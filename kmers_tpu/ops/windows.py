"""Windowed k-mer extraction over packed words — the counting hot path.

The data-parallel reformulation of the reference's rolling iterators
(SURVEY.md §3.2/§3.3): instead of shifting one encoding into a register
per iteration (`shift_encoding`, /root/reference/src/construction_utils.jl:129),
all L-K+1 windows are produced at once from the packed word stream by
combining each word with its two successors at the ``32//bps`` static
sub-word offsets — the cross-word carry of ``leftshift_carry``
(/root/reference/src/tuple_bitflipping.jl:24-46) becomes a static shift/OR
of adjacent words.  ~10 elementwise ops per base, no gathers, no sequential state.

Reverse-complement windows use the two-stream trick (the batched analogue
of FwRvIterator maintaining both kmers,
/root/reference/src/iterators/CanonicalKmers.jl:94-174): complement the
code stream, reverse it, extract windows, and flip — rc_window[i] of the
forward sequence is window[L-K-i] of the reverse-complemented sequence.

Supported here: K*bps <= 64 (one (hi, lo) uint32 pair per window; K <= 32
at 2 bits — covering the K=31 north star).  Larger K falls back to the
scalar plane until the multi-word kernel lands.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import u64
from .encode import PER_WORD, pack_words

__all__ = [
    "window_u64",
    "windows_from_codes",
    "rc_windows_from_codes",
    "canonical_windows_from_codes",
    "window_valid_mask",
]

_U32 = jnp.uint32


def _check_k(K: int, bps: int):
    if K * bps > 64:
        raise NotImplementedError(
            f"array plane supports K*bps <= 64 (got K={K}, bps={bps}); "
            "use the scalar plane for larger kmers"
        )
    if K < 1:
        raise ValueError("K must be >= 1")


def window_u64(words, L: int, K: int, bps: int = 2):
    """All K-windows of a packed word stream as a U64 pair.

    ``words`` must be packed by :func:`~kmers_tpu.ops.encode.pack_words`
    with >= 2 pad words.  Returns ``(hi, lo)`` of length ``L - K + 1``;
    window *i* holds the kmer register value of positions ``[i, i+K)``
    (first symbol in the highest coding bits, zero head padding — the
    scalar layout, so u64 compare == lexicographic compare).

    In checked mode the packed stream's (static) shape is validated:
    a too-short stream would otherwise clamp the adjacent-word slices
    silently and emit garbage tail windows.
    """
    from ..utils.debug import checked_mode

    if checked_mode():
        Q = -(-L // PER_WORD(bps))
        if words.shape[0] < Q + 2:
            raise IndexError(
                f"window_u64: packed stream has {words.shape[0]} words but "
                f"L={L} at {bps} bits/symbol needs {Q} + 2 carry words "
                "(caught by checked mode; pack with pad_words >= 2)"
            )
    return _window_u64_jit(words, L, K, bps)


@partial(jax.jit, static_argnames=("L", "K", "bps"))
def _window_u64_jit(words, L: int, K: int, bps: int = 2):
    _check_k(K, bps)
    P = PER_WORD(bps)
    n = L - K + 1
    if n <= 0:
        z = jnp.zeros(0, _U32)
        return z, z
    Q = -(-L // P)  # real (non-pad) word count
    w0 = words[0:Q]
    w1 = words[1 : Q + 1]
    w2 = words[2 : Q + 2]
    his, los = [], []
    shift_out = 64 - bps * K
    for r in range(P):
        o = bps * r
        if o == 0:
            hi_full, lo_full = w0, w1
        else:
            hi_full = (w0 << o) | (w1 >> (32 - o))
            lo_full = (w1 << o) | (w2 >> (32 - o))
        hi, lo = u64.shr((hi_full, lo_full), shift_out)
        his.append(hi)
        los.append(lo)
    # element (q, r) is window position P*q + r
    hi = jnp.stack(his, axis=1).reshape(Q * P)[:n]
    lo = jnp.stack(los, axis=1).reshape(Q * P)[:n]
    return hi, lo


def windows_from_codes(codes, K: int, bps: int = 2):
    """Forward windows straight from a per-symbol code array."""
    L = codes.shape[0]
    words = pack_words(codes, bps=bps, pad_words=2)
    return window_u64(words, L, K, bps)


@partial(jax.jit, static_argnames=("K",))
def rc_windows_from_codes(codes, K: int):
    """Reverse-complement windows of a 2-bit code stream.

    ``out[i] == reverse_complement(kmer at i)``, aligned with
    :func:`windows_from_codes` output.
    """
    L = codes.shape[0]
    rc_stream = (codes ^ 3)[::-1]
    hi, lo = windows_from_codes(rc_stream, K, bps=2)
    return hi[::-1], lo[::-1]


@partial(jax.jit, static_argnames=("K",))
def canonical_windows_from_codes(codes, K: int):
    """min(forward, reverse-complement) per window — the strand-neutral
    kmer stream (/root/reference/src/iterators/CanonicalKmers.jl:199-226)."""
    fw = windows_from_codes(codes, K, bps=2)
    rv = rc_windows_from_codes(codes, K)
    return u64.minimum(fw, rv)


@partial(jax.jit, static_argnames=("K",))
def rc_windows_4bit_from_codes(codes, K: int):
    """Reverse-complement windows of a 4-bit nucleotide code stream.

    The 4-bit complement is the nibble bit-reversal (gap and N are
    self-complementary), applied per code before the reversed-stream
    window extraction — the 4-bit analogue of
    :func:`rc_windows_from_codes`.
    """
    c = codes
    comp = ((c & 1) << 3) | ((c & 2) << 1) | ((c & 4) >> 1) | ((c & 8) >> 3)
    rc_stream = comp[::-1]
    hi, lo = windows_from_codes(rc_stream, K, bps=4)
    return hi[::-1], lo[::-1]


@partial(jax.jit, static_argnames=("K",))
def canonical_windows_4bit_from_codes(codes, K: int):
    """min(forward, reverse-complement) per window over 4-bit codes —
    the batched CanonicalKmers{DNAAlphabet{4}} (K <= 16 per register;
    K <= 15 if feeding the sentinel-based counter)."""
    fw = windows_from_codes(codes, K, bps=4)
    rv = rc_windows_4bit_from_codes(codes, K)
    return u64.minimum(fw, rv)


@partial(jax.jit, static_argnames=("K",))
def window_valid_mask(good, K: int):
    """For a per-symbol boolean ``good``, the per-window "all K symbols good"
    mask — the data-parallel equivalent of UnambiguousKmers' restart counter
    (/root/reference/src/iterators/UnambiguousKmers.jl:88-107): a window is
    emitted iff it contains no skipped symbol."""
    L = good.shape[0]
    n = L - K + 1
    if n <= 0:
        return jnp.zeros(0, bool)
    bad = (~good).astype(jnp.int32)
    cum = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(bad)])
    return (cum[K : L + 1] - cum[0:n]) == 0
