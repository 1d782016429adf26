"""Sort-based unique counting of U64 kmer streams.

The in-framework replacement for the reference's user-side dict counting
(SURVEY.md §3.3: "user code: counts[kmer] += 1").  XLA wants static shapes
and no dynamic allocation, so counting is a deterministic sort +
run-length encode.

Counting uses neither scatters nor random gathers:

1. lexicographic two-key sort of (hi, lo);
2. run boundaries by neighbor comparison; per-element run totals by
   cumulative scans (cumsum for weights, cummax to propagate each run's
   starting offset — valid because run starts are nondecreasing);
3. in-place emission: each run's last element keeps (kmer, total), all
   other positions become sentinel/zero padding.  No compaction pass —
   front-packing the representatives would need a second full stable
   sort, and nothing downstream needs density (merges re-sort; hosts
   mask ``counts > 0``).

Results are sorted (among real rows) and bit-exact reproducible — the
property the multi-device hash-prefix merge (kmers_tpu.parallel) relies on.

Invalid/masked windows are routed to the all-ones sentinel, which sorts
last and is dropped; callers must keep K*bps <= 62 so real registers can
never equal the sentinel (true for the K<=31 DNA north star).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

__all__ = [
    "sort_count",
    "merge_sorted_counts",
    "compact_counts",
    "merge_compact_tables",
    "SENTINEL",
]

_U32 = jnp.uint32
_I32 = jnp.int32

#: sentinel register value (sorts after every valid kmer with K*bps <= 62)
SENTINEL = 0xFFFFFFFF


def _run_length_encode(shi, slo, weights=None):
    """(uniq_hi, uniq_lo, counts, n_unique) of a pre-sorted stream.

    ``weights`` (optional, int32) are summed per run; default weight is 1.
    Scatter- and gather-free (see module docstring).

    The table is *sentinel-interspersed*, not front-packed: each run's
    last element keeps the kmer and carries the run's total; every other
    position is sentinel/zero padding.  Real rows remain in sorted order.
    Front-packing would cost a second full stable sort and no consumer
    needs it — downstream merges re-sort, and host extraction masks with
    ``counts > 0``.
    """
    n = shi.shape[0]
    sent = jnp.asarray(SENTINEL, _U32)
    first = jnp.concatenate(
        [jnp.ones(1, bool), (shi[1:] != shi[:-1]) | (slo[1:] != slo[:-1])]
    )
    is_last = jnp.concatenate([first[1:], jnp.ones(1, bool)])
    if weights is None:
        wcum = jnp.arange(1, n + 1, dtype=_I32)  # inclusive cumsum of ones
        w = jnp.ones((), _I32)
    else:
        w = weights.astype(_I32)
        wcum = jnp.cumsum(w)
    # exclusive-cumsum value at each element's run start, propagated along
    # the run: run starts increase, and wcum is nondecreasing, so a running
    # max of (first ? wcum - w : 0) carries the latest start's offset.
    start_w = lax.cummax(jnp.where(first, wcum - w, 0))
    run_total = wcum - start_w
    is_sentinel = (shi == sent) & (slo == sent)
    emit = is_last & ~is_sentinel
    uniq_hi = jnp.where(emit, shi, sent)
    uniq_lo = jnp.where(emit, slo, sent)
    counts = jnp.where(emit, run_total, 0)
    n_runs = jnp.sum(first.astype(_I32))
    # a real sentinel run (masked windows) sorts last in the input stream
    has_sentinel = (shi[-1] == sent) & (slo[-1] == sent)
    n_unique = n_runs - has_sentinel.astype(_I32)
    return uniq_hi, uniq_lo, counts, n_unique


@partial(jax.jit, static_argnames=("key_bits",))
def sort_count(hi, lo, valid=None, key_bits: int | None = None):
    """Count distinct kmers in a U64 stream.

    Returns ``(uniq_hi, uniq_lo, counts, n_unique)``: a sentinel-
    interspersed table holding each of the ``n_unique`` sorted distinct
    kmers exactly once with its multiplicity; all other slots are
    sentinel/zero padding (static shapes — callers mask with
    ``counts > 0``).

    ``key_bits`` (static): register width ``K * bits_per_symbol`` of the
    caller's kmers.  Callers that know it should pass it so the sentinel
    headroom precondition (module docstring) is *checked*, not assumed:
    a 63/64-bit register could equal the all-ones sentinel and be
    silently dropped.  Wider keys belong on the multi-limb path
    (:func:`kmers_tpu.ops.multiword.sort_count_mw`), which carries an
    explicit invalid flag limb instead of a sentinel value.
    """
    if key_bits is not None and key_bits > 62:
        raise ValueError(
            f"sort_count holds {key_bits}-bit keys in a 64-bit register "
            "whose all-ones value is the invalid-window sentinel; keys "
            "wider than 62 bits could collide with it — use the "
            "multi-limb path (ops.multiword.sort_count_mw) instead"
        )
    sent = jnp.asarray(SENTINEL, _U32)
    if valid is not None:
        hi = jnp.where(valid, hi, sent)
        lo = jnp.where(valid, lo, sent)
    # unstable: (hi, lo) fully determines the comparator, so equal elements
    # are bit-identical and the RLE is order-agnostic within a run
    shi, slo = lax.sort((hi, lo), num_keys=2, is_stable=False)
    return _run_length_encode(shi, slo)


@jax.jit
def compact_counts(uh, ul, cnt):
    """Front-pack the real rows of a sentinel-interspersed count table.

    Gather/scatter-free: every real row must move left by ``d_i`` =
    number of sentinel rows before it — ``d`` is nondecreasing, so the
    permutation decomposes into log2(n) conditional shift-left-by-2^k
    passes (move exactly the rows whose ``d`` has bit k set), each pure
    slicing + selects.

    Relative order of real rows is preserved (the table stays sorted);
    the tail becomes sentinel/zero.  Same static shape in and out.
    """
    n = uh.shape[0]
    sent = jnp.asarray(SENTINEL, _U32)
    real = cnt > 0
    nreal = (~real).astype(_I32)
    d = jnp.cumsum(nreal) - nreal  # holes before each position
    v = real
    xs = (uh, ul, cnt.astype(_I32))
    k = 0
    while (1 << k) < n:
        s = 1 << k

        def sh(a):
            return jnp.concatenate([a[s:], jnp.zeros(s, a.dtype)])

        d_in = sh(d)
        v_in = sh(v.astype(jnp.int8)).astype(bool)
        take_in = v_in & (((d_in >> k) & 1) == 1)
        stay = v & (((d >> k) & 1) == 0)
        xs = tuple(
            jnp.where(take_in, sh(x), jnp.where(stay, x, jnp.zeros_like(x)))
            for x in xs
        )
        d = jnp.where(take_in, d_in, d)
        v = take_in | stay
        k += 1
    uh2, ul2, cnt2 = xs
    return (
        jnp.where(v, uh2, sent),
        jnp.where(v, ul2, sent),
        jnp.where(v, cnt2, 0),
    )


def _next_pow2(n: int) -> int:
    return 1 << max(int(n - 1).bit_length(), 0)


@jax.jit
def merge_compact_tables(hi_a, lo_a, cnt_a, hi_b, lo_b, cnt_b):
    """Merge two *sorted* count tables with a bitonic merge network.

    Unlike :func:`merge_sorted_counts` (concat + full re-sort,
    O(n log^2 n) comparator stages), a merge of two already-sorted
    sequences needs a single bitonic merge: reverse B, concatenate, then
    log2(n) distance-halving compare-exchange passes — each pass is pure
    reshapes + min/max selects (no sort HLO).  Output size is
    ``2 * next_pow2(max(len(a), len(b)))``; equal keys are summed by the
    weighted RLE and the table is front-packed by :func:`compact_counts`.

    Returns ``(uniq_hi, uniq_lo, counts, n_unique)``, compact and sorted.
    This is the streaming-accumulator merge: with capacity-sliced inputs
    its cost tracks the true distinct count, not the stream length.
    """
    half = _next_pow2(max(hi_a.shape[0], hi_b.shape[0], 1))
    if half >= (1 << 22):
        # big tables: XLA's sort HLO fuses its comparator stages while
        # this jnp stage loop materializes every stage to device memory
        # (the 2^22-row crossover is not yet tuned on the H100)
        uh, ul, cnt, nu = merge_sorted_counts(
            hi_a, lo_a, cnt_a, hi_b, lo_b, cnt_b
        )
        uh, ul, cnt = compact_counts(uh, ul, cnt)
        return uh, ul, cnt, nu
    sent = jnp.asarray(SENTINEL, _U32)

    def pad(h, l, c):
        m = h.shape[0]
        return (
            jnp.concatenate([h, jnp.full(half - m, sent, _U32)]),
            jnp.concatenate([l, jnp.full(half - m, sent, _U32)]),
            jnp.concatenate([c.astype(_I32), jnp.zeros(half - m, _I32)]),
        )

    ah, al, ac = pad(hi_a, lo_a, cnt_a)
    bh, bl, bc = pad(hi_b, lo_b, cnt_b)
    xh = jnp.concatenate([ah, bh[::-1]])
    xl = jnp.concatenate([al, bl[::-1]])
    xc = jnp.concatenate([ac, bc[::-1]])
    m = half.bit_length()  # log2(2 * half)
    n2 = 2 * half
    for k in range(m, 0, -1):
        d = 1 << (k - 1)
        if d >= 128:
            # reshape form: minor dim d >= one lane tile, layout stays
            # dense
            h2 = xh.reshape(-1, 2, d)
            l2 = xl.reshape(-1, 2, d)
            c2 = xc.reshape(-1, 2, d)
            th, bhh = h2[:, 0], h2[:, 1]
            tl, bll = l2[:, 0], l2[:, 1]
            tc, bcc = c2[:, 0], c2[:, 1]
            le = (th < bhh) | ((th == bhh) & (tl <= bll))
            xh = jnp.stack(
                [jnp.where(le, th, bhh), jnp.where(le, bhh, th)], 1
            ).reshape(-1)
            xl = jnp.stack(
                [jnp.where(le, tl, bll), jnp.where(le, bll, tl)], 1
            ).reshape(-1)
            xc = jnp.stack(
                [jnp.where(le, tc, bcc), jnp.where(le, bcc, tc)], 1
            ).reshape(-1)
            continue
        # d < 128: a (m, 2, d) reshape would tile-pad the minor dim up
        # to 32-128x (measured 22 GB HBM for a 2^23-row merge — OOM at
        # genome scale), so compute the partner with contiguous
        # concat-shifts and an iota block mask instead
        def shl(a):
            return jnp.concatenate([a[d:], jnp.zeros(d, a.dtype)])

        def shr(a):
            return jnp.concatenate([jnp.zeros(d, a.dtype), a[:-d]])

        first = ((jax.lax.iota(_I32, n2) >> (k - 1)) & 1) == 0
        ph = jnp.where(first, shl(xh), shr(xh))
        plo = jnp.where(first, shl(xl), shr(xl))
        pc = jnp.where(first, shl(xc), shr(xc))
        lt = (xh < ph) | ((xh == ph) & (xl < plo))
        le = lt | ((xh == ph) & (xl == plo))
        # first keeps min, second keeps max; on a key tie both keep
        # their OWN row (counts may differ — dropping one would lose it)
        keep = jnp.where(first, le, ~lt)
        xh = jnp.where(keep, xh, ph)
        xl = jnp.where(keep, xl, plo)
        xc = jnp.where(keep, xc, pc)
    uh, ul, cnt, nu = _run_length_encode(xh, xl, xc)
    uh, ul, cnt = compact_counts(uh, ul, cnt)
    return uh, ul, cnt, nu


@jax.jit
def merge_sorted_counts(hi_a, lo_a, cnt_a, hi_b, lo_b, cnt_b):
    """Merge two (sorted-unique, counts) tables into one.

    Sentinel-padded inputs merge cleanly: sentinels keep zero counts and
    stay at the end.  Used for streaming chunk accumulation and for the
    cross-device table merge.
    """
    hi = jnp.concatenate([hi_a, hi_b])
    lo = jnp.concatenate([lo_a, lo_b])
    cnt = jnp.concatenate([cnt_a, cnt_b]).astype(_I32)
    # unstable is safe: RLE sums the counts over each equal-key run, so the
    # order of same-key rows from the two tables is irrelevant
    shi, slo, scnt = lax.sort((hi, lo, cnt), num_keys=2, is_stable=False)
    return _run_length_encode(shi, slo, scnt)
