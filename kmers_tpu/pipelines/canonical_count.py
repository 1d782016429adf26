"""Canonical k-mer counting — the flagship single-chip pipeline.

The end-to-end slice of SURVEY.md §7 M2-M3: ASCII bytes -> branch-free
classification -> packed words -> fused forward + reverse-complement
window extraction -> canonical select -> sort-based count, all inside one
jit region per chunk, with chunked streaming and on-device table merging
for inputs larger than one dispatch.

Equivalent reference workload: iterating ``CanonicalKmers{DNAAlphabet{2},K}``
(or ``UnambiguousKmers`` + ``canonical`` when ``skip_ambiguous``) and
counting into a dict (/root/reference/docs/src/composition.md) — here the
count table is in-framework and device-resident.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..alphabets import EncodeError, DNAAlphabet2
from ..ops.count import (
    _next_pow2,
    compact_counts,
    merge_compact_tables,
    sort_count,
)
from ..ops.encode import classify_2bit
from ..ops.windows import canonical_windows_from_codes, window_valid_mask

__all__ = [
    "CountConfig",
    "canonical_count",
    "canonical_count_bytes",
    "counts_to_dict",
]


@dataclasses.dataclass(frozen=True)
class CountConfig:
    """Static pipeline configuration (the analogue of the reference's
    compile-time type parameters, SURVEY.md §5 "Config / flag system")."""

    K: int = 31
    #: skip windows containing IUPAC ambiguity codes (UnambiguousKmers
    #: semantics); if False, ambiguity raises (FwKmers/CanonicalKmers
    #: semantics).
    skip_ambiguous: bool = True
    #: bases per jitted dispatch; inputs longer than this are streamed.
    #: None = auto: 2^20 for K <= 31, 2^19 for the K > 31 multi-limb
    #: pipeline.  Both were tuned for a comparator-network sort, where
    #: smaller chunks cost fewer stages per element; they are not yet
    #: tuned on the H100 (ROADMAP S4).
    chunk_size: int | None = None

    def __post_init__(self):
        if not 1 <= self.K <= 100:
            raise ValueError(
                "array-plane canonical counting supports 1 <= K <= 100"
            )

    @property
    def resolved_chunk_size(self) -> int:
        """The effective per-dispatch chunk size (explicit, else the
        measured per-regime default)."""
        if self.chunk_size is not None:
            return self.chunk_size
        return (1 << 19) if self.K > 31 else (1 << 20)


@partial(jax.jit, static_argnames=("K",))
def _chunk_canonical(bytes_u8, K: int):
    """One chunk: bytes -> (canonical hi, lo, valid, n_invalid_bytes, n_ambig)."""
    codes, certain, ambig = classify_2bit(bytes_u8)
    invalid = ~(certain | ambig)
    hi, lo = canonical_windows_from_codes(codes, K)
    valid = window_valid_mask(certain, K)
    return hi, lo, valid, jnp.sum(invalid), jnp.sum(ambig)


@partial(jax.jit, static_argnames=("K",))
def _chunk_count(bytes_u8, K: int):
    hi, lo, valid, n_invalid, n_ambig = _chunk_canonical(bytes_u8, K)
    uh, ul, cnt, nu = sort_count(hi, lo, valid, key_bits=2 * K)
    return uh, ul, cnt, nu, n_invalid, n_ambig


@partial(jax.jit, static_argnames=("K",))
def _chunk_count_checked(bytes_u8, K: int):
    """Checked-mode variant: also returns (n_valid_windows, n_counted) for
    the count-conservation assertion (every valid window counted exactly
    once) — the kernel-level assert path of checked mode.  A violation
    means a precondition broke (e.g. a real register colliding with the
    count sentinel) or a counting bug."""
    hi, lo, valid, n_invalid, n_ambig = _chunk_canonical(bytes_u8, K)
    uh, ul, cnt, nu = sort_count(hi, lo, valid, key_bits=2 * K)
    return uh, ul, cnt, nu, n_invalid, n_ambig, jnp.sum(valid), jnp.sum(cnt)


def _as_byte_array(data) -> np.ndarray:
    if isinstance(data, str):
        data = data.encode("ascii")
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(bytes(data), dtype=np.uint8)
    arr = np.asarray(data)
    if arr.dtype != np.uint8:
        raise TypeError("expected ASCII bytes or a uint8 array")
    return arr


def canonical_count_bytes(
    data, config: CountConfig = CountConfig(), metrics=None
):
    """Count canonical K-mers of an ASCII nucleotide buffer.

    Returns ``(kmers, counts)``: for K <= 31, ``kmers`` is a sorted
    np.uint64 array of canonical kmer register values (compare with
    ``Kmer.canonical().value``); for K > 31 it is a sorted object array
    of Python-int register values (multi-limb registers).

    ``metrics``: an optional :class:`kmers_tpu.utils.Metrics`; one
    :class:`BatchStats` is recorded per call (bases in, windows out,
    windows skipped, distinct kmers, wall seconds) at the cost of one
    extra device reduction per chunk.
    """
    if config.K > 31:
        return _canonical_count_multiword(data, config)
    if metrics is not None:
        metrics.start_batch()
    arr = _as_byte_array(data)
    K = config.K
    chunk_size = config.resolved_chunk_size
    if chunk_size < K:
        raise ValueError(
            f"chunk_size ({chunk_size}) must be >= K ({K})"
        )
    L = arr.shape[0]
    if L < K:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)

    # stream in overlapping chunks: consecutive chunks share K-1 bases so
    # no window is lost at a boundary (the shard-level carry propagation
    # of SURVEY.md §2.7 item 4, on one device)
    # stride = windows per chunk; the old max(..., K) clamp skipped
    # window starts whenever K <= chunk_size < 2K-1 (round-4 review)
    step = chunk_size - (K - 1)
    # the accumulator is the shared mergesort-style level stack
    # (utils/levelstack.py: O(c u log c) merge work, O(u log c) peak
    # memory over c chunks; merge order does not affect the table)

    acc = None  # single-dispatch fast path result
    # tallies accumulate as HOST ints at drain time (the DrainQueue has
    # async-copied the scalars by then, so the reads cost no round trip,
    # and Python ints cannot overflow the way a device int32 accumulator
    # would past ~2^31 windows); the single-dispatch path keeps the raw
    # device scalars instead so its hot path stays fully asynchronous
    dev_invalid = 0
    dev_ambig = 0
    total_pad = 0
    from ..utils.debug import checked_mode

    dbg = checked_mode()
    track = dbg or metrics is not None
    dev_valid = 0
    dev_counted = 0

    def _merge(a, b):
        return merge_compact_tables(a[0], a[1], a[2], b[0], b[1], b[2])

    def _slice(out):
        mh, ml, mc, mnu = out
        cap = _next_pow2(max(int(mnu), 1))
        return (mh[:cap], ml[:cap], mc[:cap])

    from ..utils.levelstack import LevelStack

    stack = LevelStack(_merge, _slice)
    starts = list(range(0, max(L - K + 1, 1), step))

    def _drain(out):
        # consume one chunk's output: device-side tally adds, compact,
        # and the level-stack push (its nu fetch is the stream's only
        # per-chunk host round trip)
        nonlocal dev_valid, dev_counted, dev_invalid, dev_ambig
        if track:
            uh, ul, cnt, nu, n_inv, n_amb, n_val, n_cnt = out
            dev_valid += int(np.asarray(n_val))
            dev_counted += int(np.asarray(n_cnt))
        else:
            uh, ul, cnt, nu, n_inv, n_amb = out
        dev_invalid += int(np.asarray(n_inv))
        dev_ambig += int(np.asarray(n_amb))
        uh, ul, cnt = compact_counts(uh, ul, cnt)
        bcap = _next_pow2(max(int(nu), 1))  # scalar fetch per chunk
        stack.push((uh[:bcap], ul[:bcap], cnt[:bcap]))

    from ..utils.streamq import DrainQueue

    # prefetch the capacity scalar (index 3) and every tally scalar the
    # drain reads
    queue = DrainQueue(
        _drain, nu_index=(3, 4, 5, 6, 7) if track else (3, 4, 5)
    )
    for start in starts:
        chunk = arr[start : start + chunk_size]
        pad = 0
        if len(starts) > 1 and chunk.shape[0] < chunk_size:
            # pad the tail chunk to the uniform shape with 'N' (the skip
            # class) so every dispatch reuses one compiled executable;
            # the padding's ambiguity count is discounted below
            pad = chunk_size - chunk.shape[0]
            chunk = np.concatenate(
                [chunk, np.full(pad, ord("N"), np.uint8)]
            )
        if track:
            out = _chunk_count_checked(jnp.asarray(chunk), K)
        else:
            out = _chunk_count(jnp.asarray(chunk), K)
        total_pad += pad
        if len(starts) == 1:
            # single dispatch: no merge, no compaction needed (the host
            # extraction below masks counts > 0) and no scalar fetch —
            # keeps the one-chunk hot path fully asynchronous
            if track:
                uh, ul, cnt, nu, n_inv, n_amb, n_val, n_cnt = out
                dev_valid, dev_counted = n_val, n_cnt
            else:
                uh, ul, cnt, nu, n_inv, n_amb = out
            dev_invalid, dev_ambig = n_inv, n_amb
            acc = (uh, ul, cnt)
            break
        queue.push(out)
    if acc is None:
        queue.flush()

    if acc is None and len(stack):
        acc = stack.fold()

    total_invalid = int(np.asarray(dev_invalid))
    total_ambig = int(np.asarray(dev_ambig)) - total_pad
    if total_invalid:
        raise EncodeError(DNAAlphabet2(), "<batch input>")
    if total_ambig and not config.skip_ambiguous:
        raise EncodeError(DNAAlphabet2(), "<ambiguous base>")
    if dbg and int(np.asarray(dev_valid)) != int(np.asarray(dev_counted)):
        raise RuntimeError(
            "checked mode: count conservation violated — "
            f"{int(np.asarray(dev_valid))} valid windows but "
            f"{int(np.asarray(dev_counted))} counted (sentinel "
            "collision or counting bug)"
        )

    uh, ul, cnt = (np.asarray(x) for x in acc)
    kmers = (uh.astype(np.uint64) << np.uint64(32)) | ul.astype(np.uint64)
    keep = cnt > 0
    kmers, counts = kmers[keep], cnt[keep].astype(np.int64)
    if metrics is not None:
        n_windows = max(L - K + 1, 0)
        n_valid = int(np.asarray(dev_valid))
        metrics.end_batch(
            bases_in=L,
            windows_out=n_valid,
            windows_skipped=n_windows - n_valid,
            distinct_kmers=int(kmers.shape[0]),
        )
    return kmers, counts


def _canonical_count_multiword(data, config: CountConfig):
    """K > 31: multi-limb registers (ops.multiword) with the same
    device-resident streaming accumulator as the K <= 31 path — per-chunk
    sort-count, gather-free compaction, bitonic merge into a compact
    table whose capacity tracks the true distinct count.  No host-side
    per-kmer Python work: the table converts to Python ints once, at the
    end (the old implementation merged every chunk through a host
    ``collections.Counter`` and could not stream a genome)."""
    from ..ops.count import _next_pow2
    from ..ops.multiword import (
        canonical_windows_mw,
        compact_counts_mw,
        merge_compact_tables_mw,
        mw_to_numpy,
        sort_count_mw,
    )
    from ..ops.windows import window_valid_mask

    arr = _as_byte_array(data)
    K = config.K
    chunk_size = config.resolved_chunk_size
    if chunk_size < K:
        raise ValueError("chunk_size must be >= K")
    L = arr.shape[0]
    if L < K:
        return np.zeros(0, object), np.zeros(0, np.int64)

    @partial(jax.jit, static_argnames=("K",))
    def chunk_fn(bytes_u8, K):
        codes, certain, ambig = classify_2bit(bytes_u8)
        invalid = ~(certain | ambig)
        limbs = canonical_windows_mw(codes, K)
        valid = window_valid_mask(certain, K)
        ulimbs, counts, nu = sort_count_mw(limbs, valid, key_bits=2 * K)
        return ulimbs, counts, nu, jnp.sum(invalid), jnp.sum(ambig)

    # stride = windows per chunk; the old max(..., K) clamp skipped
    # window starts whenever K <= chunk_size < 2K-1 (round-4 review)
    step = chunk_size - (K - 1)
    starts = list(range(0, max(L - K + 1, 1), step))

    def _merge(a, b):
        return merge_compact_tables_mw(a[0], a[1], b[0], b[1])

    def _slice(out):
        mlimbs, mc, mnu = out
        cap = _next_pow2(max(int(mnu), 1))
        return (tuple(x[:cap] for x in mlimbs), mc[:cap])

    from ..utils.levelstack import LevelStack

    stack = LevelStack(_merge, _slice)

    acc = None  # (limbs tuple, cnt) compact device arrays, pow2 capacity
    # host-int tallies (see the K <= 31 driver: drain-time reads of
    # async-copied scalars; no device-int32 overflow past 2^31)
    dev_invalid = 0
    dev_ambig = 0
    total_pad = 0

    def _drain(out):
        # deferred scalar fetches: by drain time the async copies have
        # landed, so the per-chunk host round trip is off the hot path
        # (the K <= 31 streamed path's DrainQueue protocol)
        nonlocal dev_invalid, dev_ambig
        ulimbs, counts, nu, n_inv, n_amb = out
        dev_invalid += int(np.asarray(n_inv))
        dev_ambig += int(np.asarray(n_amb))
        climbs, ccnt = compact_counts_mw(ulimbs, counts)
        bcap = _next_pow2(max(int(nu), 1))
        stack.push((tuple(x[:bcap] for x in climbs), ccnt[:bcap]))

    from ..utils.streamq import DrainQueue

    queue = DrainQueue(_drain, nu_index=(2, 3, 4))
    for start in starts:
        chunk = arr[start : start + chunk_size]
        pad = 0
        if len(starts) > 1 and chunk.shape[0] < chunk_size:
            pad = chunk_size - chunk.shape[0]
            chunk = np.concatenate([chunk, np.full(pad, ord("N"), np.uint8)])
        ulimbs, counts, nu, n_inv, n_amb = chunk_fn(jnp.asarray(chunk), K)
        total_pad += pad
        if len(starts) == 1:
            dev_invalid, dev_ambig = n_inv, n_amb
            acc = (ulimbs, counts)
            break
        queue.push((ulimbs, counts, nu, n_inv, n_amb))
    queue.flush()

    if acc is None and len(stack):
        acc = stack.fold()

    total_invalid = int(np.asarray(dev_invalid))
    total_ambig = int(np.asarray(dev_ambig)) - total_pad
    if total_invalid:
        raise EncodeError(DNAAlphabet2(), "<batch input>")
    if total_ambig and not config.skip_ambiguous:
        raise EncodeError(DNAAlphabet2(), "<ambiguous base>")
    cnt = np.asarray(acc[1])
    keep = cnt > 0
    kmers = mw_to_numpy(tuple(np.asarray(x)[keep] for x in acc[0]))
    return kmers, cnt[keep].astype(np.int64)


def canonical_count(data, K: int = 31, skip_ambiguous: bool = True):
    """Convenience wrapper: ``canonical_count("ACGT...", K)``."""
    return canonical_count_bytes(
        data, CountConfig(K=K, skip_ambiguous=skip_ambiguous)
    )


def join_records_with_n(seq_bytes, offsets) -> np.ndarray:
    """Join CSR records with single ``N`` separators.

    The shared boundary-handling primitive: an ``N`` classifies as the
    ambiguity skip class, so windows can never span records in any
    skip-ambiguous pipeline (counting, sketching, six-frame).
    """
    offsets = np.asarray(offsets)
    seq = np.asarray(seq_bytes, dtype=np.uint8)
    n_rec = offsets.shape[0] - 1
    if n_rec <= 1:
        return seq
    joined = np.full(seq.shape[0] + n_rec - 1, ord("N"), dtype=np.uint8)
    pos = 0
    for i in range(n_rec):
        r = seq[offsets[i] : offsets[i + 1]]
        joined[pos : pos + r.shape[0]] = r
        pos += r.shape[0] + 1
    return joined


def canonical_count_records(
    seq_bytes, offsets, config: CountConfig = CountConfig(), metrics=None
):
    """Count canonical K-mers over a CSR record batch (e.g. from
    :func:`kmers_tpu.io.read_fastx`): windows never span record
    boundaries (see :func:`join_records_with_n`); requires
    ``skip_ambiguous=True``.
    """
    if not config.skip_ambiguous:
        raise ValueError("record-batch counting requires skip_ambiguous=True")
    return canonical_count_bytes(
        join_records_with_n(seq_bytes, offsets), config, metrics=metrics
    )


def composition_vector(
    data, K: int = 4, canonical: bool = False, skip_ambiguous: bool = True
) -> np.ndarray:
    """Dense K-mer composition spectrum: a (4**K,) count vector indexed by
    the kmer register value (tetranucleotide frequency and friends — the
    reference's composition workflow, /root/reference/docs/src/composition.md,
    as a fixed-size feature vector).  K <= 12 (dense 4^K table).
    """
    if not 1 <= K <= 12:
        raise ValueError("composition vectors support 1 <= K <= 12")
    if canonical:
        kmers, counts = canonical_count_bytes(
            data, CountConfig(K=K, skip_ambiguous=skip_ambiguous)
        )
        out = np.zeros(4**K, dtype=np.int64)
        out[kmers.astype(np.int64)] = counts
        return out
    from .extract import extract_kmers

    vals, _ = extract_kmers(
        data, K=K, canonical=False, skip_ambiguous=skip_ambiguous
    )
    return np.bincount(vals.astype(np.int64), minlength=4**K).astype(np.int64)


def counts_lookup(kmers: np.ndarray, counts: np.ndarray, queries) -> np.ndarray:
    """Multiplicity of each query kmer in a sorted count table (0 if absent).

    ``queries``: uint64 register values or :class:`Kmer` objects (their
    canonical form is looked up, matching how the table was built).
    """
    from ..kmer import Kmer

    if isinstance(queries, (Kmer, int, np.integer)):
        queries = [queries]
    elif isinstance(queries, np.ndarray) and queries.ndim == 0:
        queries = [queries[()]]
    vals = [
        x.canonical().value if isinstance(x, Kmer) else int(x)
        for x in queries
    ]
    kmers = np.asarray(kmers)
    # K > 31 tables are object arrays of Python ints; match their dtype
    # (uint64 would overflow on >64-bit registers)
    q = np.array(vals, dtype=object if kmers.dtype == object else np.uint64)
    idx = np.searchsorted(kmers, q)
    idx_c = np.clip(idx, 0, max(kmers.size - 1, 0))
    hit = (kmers.size > 0) & (kmers[idx_c] == q)
    return np.where(hit, counts[idx_c], 0)


def counts_to_dict(kmers: np.ndarray, counts: np.ndarray, K: int):
    """Materialize a (kmers, counts) table as {Kmer: int} for interop/tests."""
    from ..kmer import Kmer
    from ..alphabets import DNAAlphabet2

    A = DNAAlphabet2()
    return {
        Kmer.unsafe(A, K, int(k)): int(c) for k, c in zip(kmers, counts)
    }
