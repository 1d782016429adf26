"""Windowed minimizer selection over kmer streams.

The reference has no built-in minimizer type — its docs show users how to
build one from ``unsafe_extract``/``unsafe_shift_from``
(/root/reference/docs/src/replacements.md:15-24, test/benchmark.jl:96-110);
minimizer-window selection is also BASELINE.json config 3.  This module is
the batched array-plane version: for every window of ``W`` consecutive
kmers, select the kmer with the smallest FxHash (leftmost on ties).

Sequentially this is a deque-based sliding minimum; the data-parallel
formulation is a doubling ("sparse table") sliding minimum: O(log W)
rounds of elementwise lexicographic min over shifted arrays, on
(hash_hi, hash_lo, position) triples so ties resolve to the leftmost
position deterministically.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .hashing import fx_hash_u64

__all__ = ["sliding_min_u64", "minimizers", "minimizers_masked"]

_U32 = jnp.uint32
_I32 = jnp.int32


def _sliding_min_with(key_hi, key_lo, extras, W: int):
    """Doubling sliding-min over (key_hi, key_lo, pos) with ``extras``
    (a tuple of same-length arrays) carried along with the winner.

    Carrying payloads through the O(log W) elementwise-select rounds
    recovers the minimizing *kmer values* without a ``kmer[argmin]``
    random gather at the end.

    Returns ``(min_hi, min_lo, argmin_pos, *min_extras)``.
    """
    n = key_hi.shape[0]
    if W < 1:
        raise ValueError("W must be >= 1")
    m = n - W + 1
    if m <= 0:
        z = jnp.zeros(0, _U32)
        return (z, z, jnp.zeros(0, _I32)) + tuple(
            jnp.zeros(0, x.dtype) for x in extras
        )
    pos = jnp.arange(n, dtype=_I32)
    cur = (key_hi, key_lo, pos) + tuple(extras)

    def comb(a, b):
        ah, al, ap = a[0], a[1], a[2]
        bh, bl, bp = b[0], b[1], b[2]
        a_lt = (ah < bh) | (
            (ah == bh) & ((al < bl) | ((al == bl) & (ap < bp)))
        )
        return tuple(jnp.where(a_lt, x, y) for x, y in zip(a, b))

    # doubling: after round t, cur[i] = min over [i, i + 2^t)
    span = 1
    while span * 2 <= W:
        shifted = tuple(x[span:] for x in cur)
        head = tuple(x[: x.shape[0] - span] for x in cur)
        cur = comb(head, shifted)
        span *= 2
    # combine two overlapping spans of length `span` to cover W
    off = W - span
    a = tuple(x[:m] for x in cur)
    b = tuple(x[off : off + m] for x in cur)
    return comb(a, b)


@partial(jax.jit, static_argnames=("W",))
def sliding_min_u64(key_hi, key_lo, W: int):
    """For each of the ``n - W + 1`` windows of ``W`` consecutive u64 keys,
    the (key, position) of the minimum, leftmost on ties.

    Returns ``(min_hi, min_lo, argmin_pos)``.
    """
    mh, ml, mp = _sliding_min_with(key_hi, key_lo, (), W)
    return mh, ml, mp


@partial(jax.jit, static_argnames=("K", "s"))
def closed_syncmer_mask(smer_hi, smer_lo, K: int, s: int):
    """Closed-syncmer selection mask over a kmer stream.

    Given the FxHash (or any u64 key) stream of all s-mers, kmer *i*
    (spanning s-mers [i, i+K-s]) is a closed syncmer iff the minimal
    s-mer in its span sits at the first or last offset — the
    open/closed syncmer schemes of Edgar 2021, built from the same
    doubling sliding-min as minimizers.  Returns a boolean mask over the
    ``n_smers - (K - s)`` kmer positions.
    """
    span = K - s + 1
    mh, ml, _ = sliding_min_u64(smer_hi, smer_lo, span)
    n = mh.shape[0]
    # value comparison (not argmin position): robust to duplicate hashes,
    # e.g. from canonical folding — and therefore symmetric under
    # sequence reversal
    first_eq = (smer_hi[:n] == mh) & (smer_lo[:n] == ml)
    last_eq = (smer_hi[span - 1 :] == mh) & (smer_lo[span - 1 :] == ml)
    return first_eq | last_eq


@partial(jax.jit, static_argnames=("W",))
def minimizers(kmer_hi, kmer_lo, W: int):
    """(W, K)-minimizers of a kmer stream: per window of W consecutive
    kmers, the (kmer_hi, kmer_lo, position) whose FxHash is smallest.

    Consecutive windows usually share their minimizer; callers dedup
    positions to obtain the sampled set (``np.unique`` on positions, or
    compare with the previous element on device).
    """
    hh, hl = fx_hash_u64(kmer_hi, kmer_lo)
    _mh, _ml, mp, kh, kl = _sliding_min_with(
        hh, hl, (kmer_hi, kmer_lo), W
    )
    return kh, kl, mp


@partial(jax.jit, static_argnames=("W",))
def minimizers_masked(kmer_hi, kmer_lo, valid, W: int):
    """Skip-ambiguous (W, K)-minimizers: kmers with ``valid == False`` are
    excluded from candidacy (their hash becomes the all-ones sentinel,
    which no valid K <= 31 kmer's FxHash can equal — the preimage of ~0
    is >= 2^62).  A window with no valid kmer selects nothing: its
    position comes back -1 (callers drop those rows).

    This is the UnambiguousKmers skip rule
    (/root/reference/src/iterators/UnambiguousKmers.jl:88-107) composed
    with minimizer selection — BASELINE.json config 3 x config 4.
    """
    sent = jnp.asarray(0xFFFFFFFF, _U32)
    hh, hl = fx_hash_u64(kmer_hi, kmer_lo)
    hh = jnp.where(valid, hh, sent)
    hl = jnp.where(valid, hl, sent)
    mh, ml, mp, kh, kl = _sliding_min_with(
        hh, hl, (kmer_hi, kmer_lo), W
    )
    empty = (mh == sent) & (ml == sent)
    mp = jnp.where(empty, -1, mp)
    return kh, kl, mp
