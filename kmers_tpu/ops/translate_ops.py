"""Batched translation and six-frame amino-acid kmer extraction.

Array-plane counterpart of the scalar translate
(/root/reference/src/transformations.jl:43-70, 2-bit path): codons are a
strided recombination of the 2-bit code stream (the SpacedKmers{3,3}
pattern, /root/reference/src/iterators/SpacedKmers.jl:55-81), amino acids
a 64-entry table gather, and AA kmers come from the generic window engine
at 8 bits/symbol.  Six-frame = frames 0/1/2 of the forward stream plus
frames 0/1/2 of the reverse-complement stream (BASELINE.json config 5).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..genetic_codes import GeneticCode, standard_genetic_code
from .windows import windows_from_codes

__all__ = [
    "translate_codes",
    "six_frame_codes",
    "aa_kmer_windows",
    "six_frame_aa_kmers",
]

_U32 = jnp.uint32


import functools


@functools.lru_cache(maxsize=32)
def _translator(tbl_bytes: bytes):
    from .encode import lookup_bytes

    tbl_np = np.frombuffer(tbl_bytes, np.uint8)

    @jax.jit
    def f(codes):
        n_aa = codes.shape[0] // 3
        c = codes[: n_aa * 3].reshape(n_aa, 3)
        codons = (c[:, 0] << 4) | (c[:, 1] << 2) | c[:, 2]
        # gather-free 64-entry lookup (ops.encode.lookup_bytes)
        return lookup_bytes(tbl_np, codons).astype(_U32)

    return f


def translate_codes(codes, code: GeneticCode = standard_genetic_code):
    """2-bit nucleotide codes -> 8-bit amino-acid codes (frame 0,
    truncating a trailing partial codon)."""
    f = _translator(bytes(np.asarray(code.tbl, np.uint8).tobytes()))
    return f(jnp.asarray(codes, _U32))


def six_frame_codes(codes, code: GeneticCode = standard_genetic_code):
    """The six amino-acid streams of a 2-bit code stream.

    Returns a list of 6 arrays: frames +0, +1, +2 (forward) then -0, -1,
    -2 (reverse-complement stream, i.e. translating the opposite strand
    5'->3').
    """
    codes = jnp.asarray(codes, _U32)
    rc = (codes ^ 3)[::-1]
    return [
        translate_codes(codes[f:], code) for f in range(3)
    ] + [
        translate_codes(rc[f:], code) for f in range(3)
    ]


def aa_kmer_windows(aa_codes, K: int):
    """All K-mers of an 8-bit amino-acid code stream as U64 registers
    (K <= 8 on the array plane)."""
    return windows_from_codes(jnp.asarray(aa_codes, _U32), K, bps=8)


def six_frame_aa_kmers(codes, K: int, code: GeneticCode = standard_genetic_code):
    """Six-frame translated amino-acid K-mers (BASELINE.json config 5).

    Returns a list of 6 ``(hi, lo)`` pairs, one per frame.
    """
    return [aa_kmer_windows(aa, K) for aa in six_frame_codes(codes, code)]
