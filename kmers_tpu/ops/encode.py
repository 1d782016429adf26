"""Batched ASCII -> encoding kernels and word packing.

The array-plane counterpart of the reference's per-symbol recoding loops
(/root/reference/src/construction_utils.jl:27-104): instead of one symbol
per iteration, whole byte buffers are classified and encoded with elementwise
arithmetic, then packed 16 bases (2-bit) / 8 (4-bit) / 4 (8-bit) per
uint32 word with the first symbol in the word's top bits — the same
big-endian layout the scalar :class:`~kmers_tpu.kmer.Kmer` register uses,
so windows sliced out of the packed stream are directly comparable.

Classification of 2-bit DNA/RNA input is branch-free arithmetic (no
gathers): the 2-bit code comes from the classic
``((b >> 1) ^ (b >> 2)) & 3`` identity on ASCII A/C/G/T/U (case-insensitive),
and the valid/ambiguous classes from a 26-bit letter bitmask test, exactly
reproducing ASCII_SKIPPING_LUT semantics
(/root/reference/src/iterators/common.jl:22-32).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..alphabets import (
    AminoAcidAlphabet,
    DNAAlphabet2,
    DNAAlphabet4,
    RNAAlphabet2,
    RNAAlphabet4,
)

__all__ = [
    "classify_2bit",
    "encode_table",
    "lookup_bytes",
    "pack_words",
    "PER_WORD",
]

_U32 = jnp.uint32

# Letter bitmasks (bit i = letter chr(ord('A')+i)).
def _letter_mask(letters: str) -> int:
    m = 0
    for c in letters:
        m |= 1 << (ord(c) - ord("A"))
    return m


# Certain bases for the 2-bit stream: A, C, G, T and U (T and U both code 3,
# matching ASCII_SKIPPING_LUT which accepts both for DNA and RNA).
_CERTAIN_MASK = _letter_mask("ACGTU")
# IUPAC ambiguity letters (skip class); '-' is handled separately.
_AMBIG_MASK = _letter_mask("MRSVWYHKDBN")


def classify_2bit(bytes_u8):
    """Classify an ASCII byte buffer for the 2-bit nucleotide path.

    Returns ``(codes, certain, ambiguous)``:

    - ``codes``  uint32: the 2-bit code (A=0, C=1, G=2, T/U=3); garbage
      where not certain,
    - ``certain`` bool: byte is an unambiguous base (either case),
    - ``ambiguous`` bool: byte is an IUPAC ambiguity code or ``-`` (the
      0xf0 skip class of ASCII_SKIPPING_LUT).

    Anything neither certain nor ambiguous is invalid (the 0xff class).
    """
    b = jnp.asarray(bytes_u8, _U32)
    codes = ((b >> 1) ^ (b >> 2)) & 3
    upper = b & 0xDF  # clear the ASCII case bit
    li = upper - 65  # letter index; huge (wrapped) for non-letters
    is_letter = li < 26
    safe_li = jnp.where(is_letter, li, 0)
    certain = is_letter & (((_CERTAIN_MASK >> safe_li) & 1) == 1)
    ambig = (is_letter & (((_AMBIG_MASK >> safe_li) & 1) == 1)) | (b == ord("-"))
    return codes, certain, ambig


# 256-entry encode tables for the gather-based paths (4-bit, amino acid).
_TABLES = {
    DNAAlphabet2: DNAAlphabet2().ascii_table,
    RNAAlphabet2: RNAAlphabet2().ascii_table,
    DNAAlphabet4: DNAAlphabet4().ascii_table,
    RNAAlphabet4: RNAAlphabet4().ascii_table,
    AminoAcidAlphabet: AminoAcidAlphabet().ascii_table,
}


def lookup_bytes(tbl_np, idx):
    """Gather-free byte-table lookup: ``tbl_np[idx]`` without a gather.

    This select-tree form costs ~log2(len)/4 elementwise selects per
    element and no gather (whether it still beats ``jnp.take`` on the
    H100 is not yet measured).  ``tbl_np`` must be a HOST numpy uint8 array (it becomes
    compile-time constants); ``idx`` is a traced integer array of
    in-range indices.  The table is packed 4 bytes/u32 and resolved by a
    binary select tree on the word index plus a variable byte shift.
    """
    tbl_np = np.asarray(tbl_np, np.uint8).reshape(-1)
    pad = (-tbl_np.size) % 4
    if pad:
        tbl_np = np.concatenate([tbl_np, np.zeros(pad, np.uint8)])
    words = tbl_np.view("<u4")
    nw = 1 << max((int(words.size) - 1).bit_length(), 0)
    if nw > words.size:
        words = np.concatenate([words, np.zeros(nw - words.size, "<u4")])
    idx = jnp.asarray(idx, _U32)
    w = idx >> 2
    nodes = [jnp.asarray(int(x), _U32) for x in words]
    bitpos = 0
    while len(nodes) > 1:
        bit = ((w >> bitpos) & 1) == 1
        nodes = [
            jnp.where(bit, nodes[i + 1], nodes[i])
            for i in range(0, len(nodes), 2)
        ]
        bitpos += 1
    return (nodes[0] >> ((idx & 3) << 3)) & 0xFF


@partial(jax.jit, static_argnames=("alphabet_cls",))
def encode_table(bytes_u8, alphabet_cls):
    """ASCII bytes -> (codes uint32, valid bool), gather-free.

    Semantically identical to indexing the alphabet's 256-entry ASCII
    table (invalid bytes encode as 0xFF), but computed with letter
    bitmask arithmetic instead of a table gather.  Per code bit k, a 26-bit mask of letters whose encoding has bit k
    set is tested at the byte's letter index (case-folded); non-letter
    entries (e.g. ``-`` ``*``) are handled by direct compares.
    """
    masks, valid_mask, specials = _letter_mask_consts(alphabet_cls)
    b = jnp.asarray(bytes_u8, _U32)
    upper = b & 0xDF  # fold case (tables are case-insensitive; asserted)
    li = upper - 65
    is_letter = li < 26
    safe = jnp.where(is_letter, li, 0)
    code = jnp.zeros_like(b)
    for k, m in enumerate(masks):
        if m:
            code = code | ((((jnp.asarray(m, _U32)) >> safe) & 1) << k)
    valid = is_letter & (((jnp.asarray(valid_mask, _U32) >> safe) & 1) == 1)
    enc = jnp.where(valid, code, jnp.asarray(0xFF, _U32))
    for c, v in specials:
        hit = b == c
        enc = jnp.where(hit, jnp.asarray(v, _U32), enc)
        valid = valid | hit
    return enc, valid


def _letter_mask_consts(alphabet_cls):
    """(per-bit letter masks, valid-letter mask, non-letter specials) of
    an alphabet's ASCII table — host-side constants for encode_table."""
    tbl = np.asarray(_TABLES[alphabet_cls], np.uint8)
    up = tbl[65:91].astype(np.int64)
    lo = tbl[97:123].astype(np.int64)
    if not np.array_equal(up, lo):
        raise AssertionError(
            f"{alphabet_cls.__name__} ASCII table is not case-insensitive"
        )
    masks = tuple(
        sum(
            1 << i
            for i in range(26)
            if up[i] != 0xFF and (int(up[i]) >> k) & 1
        )
        for k in range(8)
    )
    valid_mask = sum(1 << i for i in range(26) if up[i] != 0xFF)
    specials = tuple(
        (c, int(tbl[c]))
        for c in range(256)
        if tbl[c] != 0xFF and not (65 <= c <= 90 or 97 <= c <= 122)
    )
    return masks, valid_mask, specials


def PER_WORD(bps: int) -> int:
    """Symbols per uint32 word."""
    return 32 // bps


@partial(jax.jit, static_argnames=("bps", "pad_words"))
def pack_words(codes_u32, bps: int = 2, pad_words: int = 2):
    """Pack per-symbol codes into big-endian uint32 words.

    The first symbol of each group of ``32//bps`` lands in the top bits of
    its word (the scalar register layout, /root/reference/src/kmer.jl:33-44).
    The tail is zero-padded to a whole word, plus ``pad_words`` extra zero
    words so window extraction can read one word past the end.
    """
    P = PER_WORD(bps)
    L = codes_u32.shape[0]
    W = -(-L // P)
    padded = jnp.zeros(W * P, _U32).at[:L].set(codes_u32.astype(_U32))
    groups = padded.reshape(W, P)
    shifts = jnp.asarray([bps * (P - 1 - j) for j in range(P)], _U32)
    # bit-disjoint contributions, so a sum is an OR
    words = jnp.sum(groups << shifts[None, :], axis=1, dtype=_U32)
    if pad_words:
        words = jnp.concatenate([words, jnp.zeros(pad_words, _U32)])
    return words
