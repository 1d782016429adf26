"""Sharded canonical k-mer counting over a device mesh.

The multi-device flagship pipeline (SURVEY.md §7 M6, BASELINE.json config 5):

1. **Halo sharding**: the input byte stream is split into ``n_dev`` equal
   slabs, each extended by K-1 bases of right-halo so no window is lost
   or duplicated at slab boundaries — the reference's cross-word carry
   (/root/reference/src/tuple_bitflipping.jl:24-46) lifted to the
   device-shard granularity.
2. **Local streaming count**: each device streams its slab in chunks
   through the same front-end + sort + RLE as the single-chip flagship,
   folding chunk tables with the mergesort-style level-stack accumulator of
   ``pipelines.canonical_count`` — per-device compact tables whose
   capacity tracks the distinct count, so gigabase slabs never need a
   whole-slab dispatch.
3. **Hash-prefix exchange** (once, on the final local tables): each
   table row is routed to the device owning its FxHash prefix via
   ``all_to_all``, so every distinct kmer lands on exactly one device.
4. **Local merge**: per-device weighted RLE yields a hash-partitioned,
   globally deduplicated count table.

Deterministic by construction: the exchange is keyed by hash prefix and
the local tables are sorted, so results are bit-identical across runs and
device counts (after host-side concatenation + merge of the partitions).
"""

from __future__ import annotations

import dataclasses
import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.count import (
    SENTINEL,
    _next_pow2,
    compact_counts,
    merge_compact_tables,
    sort_count,
)
from ..ops.encode import classify_2bit
from ..ops.hashing import fx_hash_u64
from ..ops.windows import canonical_windows_from_codes, window_valid_mask
from .mesh import data_mesh

__all__ = [
    "ShardedCountConfig",
    "sharded_count_step",
    "sharded_canonical_count",
]

_U32 = jnp.uint32
_I32 = jnp.int32


@dataclasses.dataclass(frozen=True)
class ShardedCountConfig:
    K: int = 31
    #: per-destination bucket capacity as a multiple of the uniform share;
    #: FxHash spreads kmers near-uniformly, so a small factor suffices.
    #: Overflow is detected and reported, never silently dropped.
    bucket_factor: float = 2.0
    #: bases per device per jitted dispatch; slabs longer than this are
    #: streamed through the level-stack accumulator.  2^20 for the same
    #: sort-stage economics as CountConfig.chunk_size (not yet tuned on
    #: the H100, ROADMAP S4).
    chunk_size: int = 1 << 20

    def __post_init__(self):
        if not 1 <= self.K <= 31:
            raise ValueError("sharded counting supports 1 <= K <= 31")
        if self.chunk_size < self.K:
            raise ValueError("chunk_size must be >= K")


# ---------------------------------------------------------------------------
# SPMD bodies


def _local_count_body(shard_bytes, K: int, checked: bool = False):
    """Per-device local chunk count (runs under shard_map).

    ``shard_bytes``: (1, n_bytes) uint8, this device's 'N'-padded chunk.
    Returns this device's sentinel-interspersed local count table, its
    distinct count, and its invalid-byte count (halo bytes included —
    callers only test > 0, so double-counting an invalid halo byte is
    harmless; padding is 'N', the ambiguity class, never invalid).  With
    ``checked`` also the valid-window and counted tallies for the
    count-conservation assert.
    """
    codes, certain, ambig = classify_2bit(shard_bytes[0])
    n_bad = jnp.sum(~(certain | ambig), dtype=_I32)
    hi, lo = canonical_windows_from_codes(codes, K)
    valid = window_valid_mask(certain, K)
    uh, ul, cnt, nu = sort_count(hi, lo, valid, key_bits=2 * K)
    if not checked:
        return uh, ul, cnt, nu[None], n_bad[None]
    n_valid = jnp.sum(valid, dtype=_I32)
    n_cnt = jnp.sum(cnt, dtype=_I32)
    return (
        uh, ul, cnt, nu[None], n_bad[None],
        n_valid[None], n_cnt[None],
    )


def _compact_body(uh, ul, cnt):
    """Front-pack each device's rows (gather-free log-shift compaction).

    Tables cross every streamed dispatch boundary as 1-D per-device
    streams (P(axis))."""
    return compact_counts(uh, ul, cnt)


def _merge_body(ah, al, ac, bh, bl, bc):
    """Per-device bitonic merge of two compact tables (level-stack step).
    1-D boundaries — see :func:`_compact_body`."""
    uh, ul, cnt, nu = merge_compact_tables(ah, al, ac, bh, bl, bc)
    return uh, ul, cnt, nu[None]


def _exchange_body(uh, ul, cnt, K: int, n_dev: int, cap: int, axis: str):
    """Hash-prefix exchange + per-device merge of the received partitions.
    1-D boundaries — see :func:`_compact_body`."""
    uh, ul, cnt, nu, overflow = exchange_and_merge(
        uh, ul, cnt, n_dev, cap, axis
    )
    total_overflow = jax.lax.psum(overflow, axis)
    return uh, ul, cnt, nu[None], total_overflow[None]


def exchange_and_merge(uh, ul, cnt, n_dev: int, cap: int, axis: str):
    """Route a local (kmer, count) table by FxHash prefix over all_to_all
    and merge the received partitions.  Returns (uh, ul, cnt, n_unique,
    overflow) — overflow counts real rows dropped for exceeding ``cap``
    (callers must psum and fail loudly on > 0).

    With one device the exchange is the identity and the local table is
    already the global table: returned unchanged (no sort, no gather) so
    the sharded-on-one-chip path matches the single-chip flagship.
    """
    sent = jnp.asarray(SENTINEL, _U32)
    is_sent = (uh == sent) & (ul == sent)
    if n_dev == 1:
        nu = jnp.sum(cnt > 0, dtype=_I32)
        return uh, ul, cnt.astype(_I32), nu, jnp.zeros((), _I32)

    # route rows to the device owning the kmer's hash prefix; sentinel
    # padding rows spread round-robin (they are droppable filler)
    hh, _hl = fx_hash_u64(uh, ul)
    shift = 32 - max(n_dev - 1, 1).bit_length()
    dest = (hh >> shift).astype(_U32) % n_dev
    n_rows = uh.shape[0]
    rr = jnp.arange(n_rows, dtype=_U32) % n_dev
    dest = jnp.where(is_sent, rr, dest)

    # sort by (destination, is_sentinel): within each destination segment
    # real rows come first, so a bucket that truncates at `cap` only ever
    # drops sentinel filler — capacity is governed by *distinct* kmers
    # per destination, not by the padded table size.  Unstable: within an
    # equal key the row order is irrelevant (the receiver re-sorts), and
    # an unstable sort is measurably cheaper than a stable one.
    key = dest * 2 + is_sent.astype(_U32)
    _, suh, sul, scnt = jax.lax.sort(
        (key, uh, ul, cnt), num_keys=1, is_stable=False
    )
    seg_counts = jnp.bincount((dest).astype(_I32), length=n_dev)
    seg_real = jnp.bincount(
        jnp.where(is_sent, n_dev, dest.astype(_I32)), length=n_dev + 1
    )[:n_dev]
    seg_starts = jnp.concatenate(
        [jnp.zeros(1, seg_counts.dtype), jnp.cumsum(seg_counts)[:-1]]
    )
    overflow = jnp.sum(jnp.maximum(seg_real - cap, 0))

    # fixed-capacity buckets: (n_dev, cap), real rows first per segment.
    # Each destination's rows are CONTIGUOUS after the destination sort,
    # so bucket d is a dynamic slice at seg_starts[d] — n_dev cheap
    # dynamic-slice ops instead of one big gather.  Inputs are padded by
    # cap sentinel rows so a slice never clamps.
    pad_h = jnp.concatenate([suh, jnp.full(cap, sent, _U32)])
    pad_l = jnp.concatenate([sul, jnp.full(cap, sent, _U32)])
    pad_c = jnp.concatenate([scnt, jnp.zeros(cap, scnt.dtype)])
    in_seg = jnp.arange(cap, dtype=_I32)[None, :] < seg_counts[:, None]
    starts = jnp.clip(seg_starts, 0, n_rows).astype(_I32)
    bh_rows, bl_rows, bc_rows = [], [], []
    for d in range(n_dev):
        s0 = (starts[d],)
        bh_rows.append(jax.lax.dynamic_slice(pad_h, s0, (cap,)))
        bl_rows.append(jax.lax.dynamic_slice(pad_l, s0, (cap,)))
        bc_rows.append(jax.lax.dynamic_slice(pad_c, s0, (cap,)))
    bh = jnp.where(in_seg, jnp.stack(bh_rows), sent)
    bl = jnp.where(in_seg, jnp.stack(bl_rows), sent)
    bc = jnp.where(in_seg, jnp.stack(bc_rows), 0)

    # exchange: row d of the result comes from device d's bucket for us
    a2a = partial(
        jax.lax.all_to_all, axis_name=axis, split_axis=0, concat_axis=0, tiled=True
    )
    bh, bl, bc = a2a(bh), a2a(bl), a2a(bc)

    # merge the n_dev received tables (weighted run-length encode)
    # unstable is safe: the RLE sums counts over each equal-(hi,lo) run
    shi, slo, scnt2 = jax.lax.sort(
        (bh.reshape(-1), bl.reshape(-1), bc.reshape(-1)),
        num_keys=2,
        is_stable=False,
    )
    from ..ops.count import _run_length_encode

    uh, ul, cnt, nu = _run_length_encode(shi, slo, scnt2)
    return uh, ul, cnt, nu, overflow


# ---------------------------------------------------------------------------
# Jitted steps (cached per geometry: rebuilding the shard_map'd closure
# per call would defeat jit's compile cache and recompile every call)


@functools.lru_cache(maxsize=64)
def _local_count_step(mesh: Mesh, K: int, checked: bool = False):
    axis = mesh.axis_names[0]
    spec = P(axis)  # 1-D table boundaries (see _compact_body)
    outs = (spec, spec, spec, P(axis), P(axis))
    if checked:
        outs = outs + (P(axis), P(axis))
    mapped = jax.shard_map(
        partial(_local_count_body, K=K, checked=checked),
        mesh=mesh,
        in_specs=P(axis, None),
        out_specs=outs,
    )
    return jax.jit(mapped)


@functools.lru_cache(maxsize=64)
def _compact_step(mesh: Mesh):
    axis = mesh.axis_names[0]
    spec = P(axis)  # 1-D table boundaries (see _compact_body)
    mapped = jax.shard_map(
        _compact_body,
        mesh=mesh,
        in_specs=(spec,) * 3,
        out_specs=(spec,) * 3,
    )
    return jax.jit(mapped)


@functools.lru_cache(maxsize=64)
def _merge_step(mesh: Mesh):
    axis = mesh.axis_names[0]
    spec = P(axis)  # 1-D table boundaries (see _compact_body)
    mapped = jax.shard_map(
        _merge_body,
        mesh=mesh,
        in_specs=(spec,) * 6,
        out_specs=(spec, spec, spec, P(axis)),
    )
    return jax.jit(mapped)


@functools.lru_cache(maxsize=64)
def _exchange_step(mesh: Mesh, K: int, cap: int):
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    body = partial(_exchange_body, K=K, n_dev=n_dev, cap=cap, axis=axis)
    spec = P(axis)  # 1-D table boundaries (see _compact_body)
    mapped = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(spec, spec, spec),
        out_specs=(spec, spec, spec, P(axis), P(axis)),
    )
    return jax.jit(mapped)


@functools.lru_cache(maxsize=64)
def sharded_count_step(
    mesh: Mesh,
    K: int,
    shard_len: int,
    cap: int,
    checked: bool = False,
):
    """SPMD counting step for a fixed geometry: local count +
    hash-prefix exchange in one jit region.  Used for inputs that fit
    one chunk per device (and by the scaling bench / multichip dryrun);
    the streaming driver composes the split steps instead.  Takes the
    (n_dev, row) uint8 device array and returns
    ``(uh, ul, cnt, nu, n_bad, overflow)`` (plus the mesh-summed
    ``n_valid, n_counted`` tallies with ``checked``).
    """
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size

    def body(shard_bytes):
        out = _local_count_body(shard_bytes, K, checked)
        uh, ul, cnt, nu, n_bad = out[:5]
        uh, ul, cnt, nu, overflow = _exchange_body(
            uh, ul, cnt, K, n_dev, cap, axis
        )
        total_bad = jax.lax.psum(jnp.sum(n_bad), axis)
        res = (uh, ul, cnt, nu, total_bad[None], overflow)
        if checked:
            n_valid = jax.lax.psum(out[5][0], axis)
            n_cnt = jax.lax.psum(out[6][0], axis)
            res = res + (n_valid[None], n_cnt[None])
        return res

    spec = P(axis)  # 1-D table boundaries (see _compact_body)
    outs = (spec, spec, spec, P(axis), P(axis), P(axis))
    if checked:
        outs = outs + (P(axis), P(axis))
    mapped = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=P(axis, None),
        out_specs=outs,
    )
    return jax.jit(mapped)


# ---------------------------------------------------------------------------
# Host driver


def _fetch_np(x) -> np.ndarray:
    """Host fetch that also works on multi-process global arrays.

    Under ``jax.distributed`` (multi-controller SPMD) each process holds
    only its addressable shards; ``process_allgather`` replicates the
    value so every process sees the same full array — the multi-process
    twin of a plain ``np.asarray``.  The branch is on the PROCESS COUNT, never on
    per-array addressability: allgather is a collective, and a mesh that
    happens to be fully addressable on one process but not another (e.g.
    a 1-device mesh in a 2-process job) would deadlock if only some
    processes entered it."""
    if jax.process_count() == 1 or not hasattr(x, "is_fully_addressable"):
        return np.asarray(x)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def _put_sharded(view: np.ndarray, sharding):
    """Stage host rows onto the mesh: plain device_put in one process;
    per-process shard materialization (``make_array_from_callback``) when
    the mesh spans processes — every process holds the full host rows
    (deterministic input) and contributes only its addressable shards.
    ``dtype`` is passed explicitly: a process owning no shard of the
    target mesh (legal in multi-controller) cannot infer it."""
    if jax.process_count() == 1:
        return jax.device_put(view, sharding)
    return jax.make_array_from_callback(
        view.shape, sharding, lambda idx: view[idx], dtype=view.dtype
    )


def _shard_with_halo(arr: np.ndarray, n_dev: int, K: int, pad_byte: int = 0):
    """Split bases into n_dev equal shards with K-1 right halos.

    Pads the tail with ``pad_byte`` (default 0x00, an invalid byte ->
    masked windows; the canonical pipeline passes ``ord('N')``, the
    ambiguity skip class, so padding never counts as invalid), so every
    window of the original stream appears in exactly one shard.
    """
    L = arr.shape[0]
    shard = -(-L // n_dev)
    halo = K - 1
    padded = np.full(n_dev * shard + halo, pad_byte, dtype=np.uint8)
    padded[:L] = arr
    out = np.empty((n_dev, shard + halo), dtype=np.uint8)
    for d in range(n_dev):
        out[d] = padded[d * shard : d * shard + shard + halo]
    return out, shard


def sharded_canonical_count(
    data,
    config: ShardedCountConfig = ShardedCountConfig(),
    mesh: Mesh | None = None,
    metrics=None,
):
    """Count canonical K-mers across all devices of ``mesh``.

    Returns ``(kmers, counts)`` as sorted host numpy arrays (exact global
    multiset — parity with the single-chip pipeline and the scalar oracle).
    Raises on invalid bytes and on bucket overflow (raise ``bucket_factor``).
    Slabs longer than ``config.chunk_size`` bases per device are streamed
    chunk by chunk with the level-stack accumulator — the whole input is
    never materialized on device at once.
    ``metrics``: optional :class:`kmers_tpu.utils.Metrics` recording one
    BatchStats per call.
    """
    if metrics is not None:
        metrics.start_batch()
    if isinstance(data, str):
        data = data.encode("ascii")
    arr = np.frombuffer(bytes(data), dtype=np.uint8).copy()
    if mesh is None:
        mesh = data_mesh()
    n_dev = mesh.devices.size
    K = config.K
    L = arr.shape[0]
    if L < K:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)

    axis = mesh.axis_names[0]
    sharding = NamedSharding(mesh, P(axis, None))

    from ..utils.debug import checked_mode

    dbg = checked_mode()
    total_valid = None

    # 'N' padding classifies as the ambiguity skip class: padded windows
    # sentinel out, and any invalid count > 0 is a real input error
    shards, shard = _shard_with_halo(arr, n_dev, K, pad_byte=ord("N"))

    n_chunks = max(-(-shard // config.chunk_size), 1)
    if n_chunks == 1:
        # single dispatch per device: fused local-count + exchange
        n_win = shard  # windows per shard
        cap = int(np.ceil(n_win * config.bucket_factor / n_dev))
        step = sharded_count_step(mesh, K, shard, cap, checked=dbg)
        out = step(_put_sharded(shards, sharding))
        uh, ul, cnt, nu, n_bad, overflow = out[:6]
        if dbg:
            # conservation inside each device's sort+RLE (psummed)
            total_valid = int(_fetch_np(out[6])[0])
            total_counted = int(_fetch_np(out[7])[0])
            if total_valid != total_counted:
                raise RuntimeError(
                    "checked mode: count conservation violated in the "
                    f"sharded local count — {total_valid} valid windows "
                    f"but {total_counted} counted (sentinel collision or "
                    "counting bug)"
                )
    else:
        uh, ul, cnt, nu, n_bad, overflow, total_valid = (
            _streamed_sharded_count(
                shards, shard, mesh, config, sharding, checked=dbg
            )
        )

    if int(_fetch_np(n_bad)[0]) > 0:
        from ..alphabets import EncodeError, DNAAlphabet2

        raise EncodeError(DNAAlphabet2(), "<batch input>")
    if int(_fetch_np(overflow)[0]) > 0:
        raise RuntimeError(
            "hash-prefix bucket overflow; increase bucket_factor"
        )

    uh = _fetch_np(uh).reshape(-1).astype(np.uint64)
    ul = _fetch_np(ul).reshape(-1).astype(np.uint64)
    cnt = _fetch_np(cnt).reshape(-1)
    kmers = (uh << np.uint64(32)) | ul
    keep = cnt > 0
    kmers, cnt = kmers[keep], cnt[keep].astype(np.int64)
    if dbg and total_valid is not None and int(cnt.sum()) != total_valid:
        # end-to-end conservation: the hash-prefix exchange must neither
        # drop nor duplicate counts
        raise RuntimeError(
            "checked mode: count conservation violated across the "
            f"exchange — {total_valid} valid windows but {int(cnt.sum())} "
            "in the merged table"
        )
    order = np.argsort(kmers, kind="stable")
    kmers, cnt = kmers[order], cnt[order]
    if metrics is not None:
        n_windows = max(L - K + 1, 0)
        counted = int(cnt.sum())
        metrics.end_batch(
            bases_in=L,
            windows_out=counted,
            windows_skipped=n_windows - counted,
            distinct_kmers=int(kmers.shape[0]),
        )
    return kmers, cnt


def _streamed_sharded_count(
    shards: np.ndarray,
    shard: int,
    mesh: Mesh,
    config: ShardedCountConfig,
    sharding,
    checked: bool = False,
):
    """Stream each device's slab chunk-by-chunk, fold per-device tables
    with the level-stack accumulator (the SPMD twin of the single-chip
    streaming path of ``pipelines.canonical_count``), then exchange the
    final compact tables once — one all_to_all per input regardless of
    chunk count.
    """
    n_dev = mesh.devices.size
    K = config.K
    chunk = config.chunk_size
    # each chunk row carries exactly `chunk` bytes; consecutive rows
    # overlap by K-1 bytes (stride chunk-(K-1)) so no window is lost or
    # duplicated at a chunk boundary — the same geometry as the
    # single-chip streaming path.  The row stays at chunk_size (a power
    # of two) instead of chunk_size + K-1 because a comparator sort pads
    # to the next power of two, so a K-1-byte overhang would double the
    # per-chunk sort.
    step_len = chunk - (K - 1)
    row_len = chunk  # uniform chunk rows ('N'-padded at the tail)

    count = _local_count_step(mesh, K, checked)
    compact = _compact_step(mesh)
    merge = _merge_step(mesh)

    # shared level-stack accumulator over sharded tables, 1-D per device
    # (utils/levelstack.py; one scalar fetch per chunk for the capacity)
    def _slice_nu(tbl, nu):
        # uniform capacity across devices: the max distinct count (shapes
        # must agree on every device)
        cap = _next_pow2(max(int(_fetch_np(nu).max()), 1))
        if n_dev == 1:
            return tuple(x[:cap] for x in tbl)
        return tuple(
            x.reshape(n_dev, -1)[:, :cap].reshape(-1) for x in tbl
        )

    def _merge2(a, b):
        return merge(*a, *b)

    def _slice2(out):
        return _slice_nu(out[:3], out[3])

    from ..utils.levelstack import LevelStack

    stack = LevelStack(_merge2, _slice2)

    dev_bad = 0
    dev_valid = dev_cnt = 0  # checked-mode conservation tallies
    n_steps = max(-(-shard // step_len), 1)

    def _drain(out):
        # consume one chunk's count output: accumulate error/conservation
        # tallies as host ints (the scalars were async-copied at push
        # time, so the reads cost no round trip; host ints cannot
        # overflow a device int32 past ~2^31 windows), then compact and
        # push to the level stack
        nonlocal dev_bad, dev_valid, dev_cnt
        if checked:
            uh, ul, cnt, nu, n_bad, n_valid, n_cnt = out
            dev_valid += int(_fetch_np(n_valid).sum())
            dev_cnt += int(_fetch_np(n_cnt).sum())
        else:
            uh, ul, cnt, nu, n_bad = out
        dev_bad += int(_fetch_np(n_bad).sum())
        uh, ul, cnt = compact(uh, ul, cnt)
        stack.push(_slice_nu((uh, ul, cnt), nu))

    from ..utils.streamq import DrainQueue

    # prefetch the capacity scalar (index 3) + the tally scalars
    queue = DrainQueue(
        _drain, nu_index=(3, 4, 5, 6) if checked else (3, 4)
    )
    for c in range(n_steps):
        lo_i = c * step_len
        rows = shards[:, lo_i : lo_i + row_len]
        if rows.shape[1] < row_len:
            rows = np.concatenate(
                [
                    rows,
                    np.full(
                        (n_dev, row_len - rows.shape[1]), ord("N"), np.uint8
                    ),
                ],
                axis=1,
            )
        queue.push(count(_put_sharded(np.ascontiguousarray(rows), sharding)))
    queue.flush()

    tbl = stack.fold()

    # one exchange on the final compact tables: per-destination capacity
    # tracks the per-device distinct count
    C = tbl[0].shape[0] // n_dev
    cap = max(int(np.ceil(C * config.bucket_factor / n_dev)), 1)
    exchange = _exchange_step(mesh, K, cap)
    uh, ul, cnt, nu, overflow = exchange(*tbl)
    total_bad = dev_bad
    total_valid = None
    if checked:
        total_valid = dev_valid
        total_counted = dev_cnt
        if total_valid != total_counted:
            raise RuntimeError(
                "checked mode: count conservation violated in the "
                f"streamed sharded count — {total_valid} valid windows "
                f"but {total_counted} counted (sentinel collision or "
                "counting bug)"
            )
    return uh, ul, cnt, nu, np.array([total_bad]), overflow, total_valid
