"""Construction & recoding: moving symbols from a source into a Kmer.

Mirrors the reference's RecodingScheme trait machinery
(/root/reference/src/construction.jl:16-100) and the public construction
utilities (/root/reference/src/construction_utils.jl) that let users build
custom kmer-like extractors (minimizers, syncmers, strobemers).

In this framework, scheme selection happens once per (target alphabet,
source type) pair in plain Python; the batched encode ops in
``kmers_tpu.ops.encode`` are the vectorized counterparts of these scalar
paths and are tested against them.
"""

from __future__ import annotations

import numpy as np

from .alphabets import (
    Alphabet,
    DNAAlphabet2,
    DNAAlphabet4,
    RNAAlphabet2,
    RNAAlphabet4,
    EncodeError,
)
from .kmer import Kmer
from .seq import Seq

__all__ = [
    "RecodingScheme",
    "Copyable",
    "TwoToFour",
    "FourToTwo",
    "AsciiEncode",
    "GenericRecoding",
    "recoding_scheme",
    "unsafe_extract",
    "unsafe_shift_from",
    "shift_encoding",
    "build_kmer_value",
]

_TWOBIT = (DNAAlphabet2, RNAAlphabet2)
_FOURBIT = (DNAAlphabet4, RNAAlphabet4)


class RecodingScheme:
    """Marker base class (reference construction.jl:14)."""


class Copyable(RecodingScheme):
    """Source and target encodings are identical (incl. DNA2<->RNA2, DNA4<->RNA4)."""


class TwoToFour(RecodingScheme):
    """2-bit source -> 4-bit target: encoding is ``1 << twobit``."""


class FourToTwo(RecodingScheme):
    """4-bit source -> 2-bit target: must be one-hot, value = bit index."""


class AsciiEncode(RecodingScheme):
    """Bytes -> encodings via the alphabet's ASCII table."""


class GenericRecoding(RecodingScheme):
    """Decode-symbol-then-encode fallback."""


def recoding_scheme(target: Alphabet, source) -> RecodingScheme:
    """Pick the fast path for a (target alphabet, source) pair
    (/root/reference/src/construction.jl:75-100)."""
    if isinstance(source, (Seq, Kmer)):
        As = source.alphabet
        if type(As) is type(target):
            return Copyable()
        if isinstance(As, _TWOBIT) and isinstance(target, _TWOBIT):
            return Copyable()
        if isinstance(As, _FOURBIT) and isinstance(target, _FOURBIT):
            return Copyable()
        if isinstance(As, _FOURBIT) and isinstance(target, _TWOBIT):
            return FourToTwo()
        if isinstance(As, _TWOBIT) and isinstance(target, _FOURBIT):
            return TwoToFour()
        return GenericRecoding()
    if isinstance(source, (str, bytes, bytearray, memoryview)) or (
        isinstance(source, np.ndarray) and source.dtype == np.uint8
    ):
        if target.ascii_table is not None:
            return AsciiEncode()
    return GenericRecoding()


def _ascii_bytes(source) -> bytes:
    if isinstance(source, str):
        return source.encode("utf-8")
    return bytes(source)


def _encodings(scheme: RecodingScheme, target: Alphabet, source, start: int, count: int):
    """Yield ``count`` target-alphabet encodings from ``source[start:]``.

    The scalar analogue of one per-scheme ``unsafe_extract`` loop body
    (/root/reference/src/construction_utils.jl:27-104).  No bounds checking.
    """
    if isinstance(scheme, Copyable):
        for i in range(start, start + count):
            yield source.extract_encoded_element(i) if isinstance(
                source, Kmer
            ) else int(source.codes[i])
    elif isinstance(scheme, TwoToFour):
        for i in range(start, start + count):
            e = (
                source.extract_encoded_element(i)
                if isinstance(source, Kmer)
                else int(source.codes[i])
            )
            yield 1 << e
    elif isinstance(scheme, FourToTwo):
        for i in range(start, start + count):
            e = (
                source.extract_encoded_element(i)
                if isinstance(source, Kmer)
                else int(source.codes[i])
            )
            if bin(e).count("1") != 1:
                raise EncodeError(target, source.alphabet.decode(e))
            yield e.bit_length() - 1
    elif isinstance(scheme, AsciiEncode):
        data = _ascii_bytes(source)
        table = target.ascii_table
        for i in range(start, start + count):
            enc = int(table[data[i]])
            if enc > 0x7F:
                raise EncodeError(target, data[i])
            yield enc
    else:  # GenericRecoding
        for i in range(start, start + count):
            yield target.encode(target.coerce(source[i]))


def _source_length(source) -> int:
    if isinstance(source, (str, bytes, bytearray, memoryview, np.ndarray)):
        return len(_ascii_bytes(source))
    return len(source)


def _check_unsafe_bounds(source, from_index: int, count: int, who: str):
    """Checked-mode validation of the reference's documented safety
    obligations for unchecked methods (construction_utils.jl:13-16,
    146-150): the window [from_index, from_index+count) must lie inside
    the source.  Without this, a negative index silently wraps in Python
    instead of segfaulting — same bug, quieter symptom."""
    L = _source_length(source)
    if from_index < 0 or from_index + count > L:
        raise IndexError(
            f"{who}: window [{from_index}, {from_index + count}) out of "
            f"bounds for source of length {L} (caught by checked mode)"
        )


def unsafe_extract(scheme: RecodingScheme, alphabet, K: int, source, from_index: int) -> Kmer:
    """Extract a whole K-mer starting at 0-based ``from_index``.

    Public primitive for building kmer replacements (minimizers/syncmers),
    mirroring /root/reference/src/construction_utils.jl:27-104 (which is
    1-based; this API is 0-based).  Bounds are NOT validated unless
    checked mode is on (KMERS_TPU_CHECKED=1 /
    :func:`kmers_tpu.utils.debug.set_checked`).
    """
    if not isinstance(alphabet, Alphabet):
        alphabet = alphabet()
    from .utils.debug import checked_mode

    if checked_mode():
        _check_unsafe_bounds(source, from_index, K, "unsafe_extract")
    v = 0
    bps = alphabet.bits_per_symbol
    for enc in _encodings(scheme, alphabet, source, from_index, K):
        v = (v << bps) | enc
    return Kmer.unsafe(alphabet, K, v)


def shift_encoding(kmer: Kmer, encoding: int) -> Kmer:
    """Module-level alias of :meth:`Kmer.shift_encoding` (public parity name)."""
    return kmer.shift_encoding(encoding)


def unsafe_shift_from(scheme: RecodingScheme, kmer: Kmer, source, from_index: int, S: int) -> Kmer:
    """Shift ``S`` symbols from ``source[from_index:from_index+S]`` into ``kmer``
    (S < K), mirroring /root/reference/src/construction_utils.jl:161-236
    (0-based here).  Bounds validated only in checked mode."""
    from .utils.debug import checked_mode

    if checked_mode():
        _check_unsafe_bounds(source, from_index, S, "unsafe_shift_from")
    for enc in _encodings(scheme, kmer.alphabet, source, from_index, S):
        kmer = kmer.shift_encoding(enc)
    return kmer


def build_kmer_value(alphabet: Alphabet, source, K: int | None) -> tuple[int, int]:
    """Validated (value, K) for ``Kmer(alphabet, source, K)``
    (/root/reference/src/construction.jl:201-276)."""
    bps = alphabet.bits_per_symbol

    if isinstance(source, Kmer) and K in (None, source.K):
        scheme = recoding_scheme(alphabet, source)
        k = source.K
        return unsafe_extract(scheme, alphabet, k, source, 0).value, k

    if isinstance(source, Seq):
        k = len(source) if K is None else K
        if len(source) != k:
            raise ValueError("Length of sequence must be K elements to build Kmer")
        scheme = recoding_scheme(alphabet, source)
        return unsafe_extract(scheme, alphabet, k, source, 0).value, k

    if isinstance(source, (str, bytes, bytearray, memoryview, np.ndarray)):
        scheme = recoding_scheme(alphabet, source)
        if isinstance(scheme, AsciiEncode):
            data = _ascii_bytes(source)
            k = len(data) if K is None else K
            if len(data) != k:
                raise ValueError("Length of sequence must be K elements to build Kmer")
            return unsafe_extract(scheme, alphabet, k, data, 0).value, k
        # non-ascii alphabet: treat as iterable of symbols below
        source = list(source) if not isinstance(source, str) else source

    # generic iterable of symbols/chars
    items = source if hasattr(source, "__len__") else list(source)
    k = len(items) if K is None else K
    if len(items) != k:
        raise ValueError("Length of sequence must be K elements to build Kmer")
    v = 0
    for s in items:
        v = (v << bps) | alphabet.encode(alphabet.coerce(s))
    return v, k
