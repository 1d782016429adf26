"""Sharded six-frame amino-acid k-mer counting (BASELINE.json config 5).

Each device translates its base shard in all six reading frames (three
forward, three on the reverse-complement strand), extracts amino-acid
K-mer registers, counts locally, and merges tables across devices by
FxHash prefix (the same exchange as the canonical pipeline).

Sharding geometry — the part that must be exact:

- shard length is a multiple of 3, so codon frames align identically on
  every device (frame f starts at local offset f for every shard);
- each shard carries H = 3*K_aa bases of halo on *both* sides: the right
  halo covers forward-frame windows starting near the shard end, the
  left halo covers reverse-strand windows (whose codons read leftward);
- ownership: a device emits exactly the windows whose codon start
  position (in forward coordinates for + frames, reverse-complement
  coordinates for - frames) falls inside its body span.  Because the
  padded global length and the halo are multiples of 3, the ownership
  and frame masks are the same local ranges on every device, keeping the
  SPMD body uniform.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..genetic_codes import GeneticCode, standard_genetic_code
from ..ops.count import sort_count
from ..ops.encode import classify_2bit, lookup_bytes
from ..ops.windows import window_valid_mask
from .mesh import data_mesh
from .pipeline import _fetch_np, _put_sharded

__all__ = ["SixFrameCountConfig", "sharded_sixframe_aa_count"]

_U32 = jnp.uint32
_I32 = jnp.int32


@dataclasses.dataclass(frozen=True)
class SixFrameCountConfig:
    K: int = 7  # amino acids per kmer
    bucket_factor: float = 2.0
    code: GeneticCode = standard_genetic_code
    #: bases per device per jitted dispatch (rounded down to a multiple
    #: of 3 so codon frames stay aligned, then clamped so the window
    #: stream fits the sort's power of two); device slabs longer than
    #: this stream chunk-by-chunk through the level-stack accumulator
    #: like the canonical pipeline — gigabase inputs never need a
    #: whole-slab dispatch.  Default 2^20 (~2^21 windows/chunk): the
    #: same sort-stage economics as CountConfig.chunk_size (not yet
    #: tuned on the H100, ROADMAP S4).
    chunk_size: int = 1 << 20

    def __post_init__(self):
        if not 1 <= self.K <= 32:
            raise ValueError(
                "sharded AA counting supports 1 <= K <= 32 (K <= 7 on "
                "single 56-bit registers, K <= 32 on multi-limb registers)"
            )
        if self.chunk_size < 6 * self.K:
            raise ValueError("chunk_size must be >= 6*K bases")


def _aa_stream(codes, tbl):
    """AA encoding of the codon starting at EVERY base position (uint32;
    entries within 2 of the stream end are garbage — callers' window
    spans never reach them)."""
    c1 = jnp.concatenate([codes[1:], jnp.zeros(1, codes.dtype)])
    c2 = jnp.concatenate([codes[2:], jnp.zeros(2, codes.dtype)])
    cod_full = (codes << 4) | (c1 << 2) | c2
    # gather-free codon->AA lookup (ops.encode.lookup_bytes)
    return lookup_bytes(tbl, cod_full).astype(_U32)


def _aa_windows_step3(aa, K: int):
    """(hi, lo) AA K-mer registers for the window starting at EVERY base
    position p (codons at p, p+3, ..., p+3(K-1); earliest codon in the
    highest bits).

    This is the key six-frame identity: the union over the three codon
    frames of one strand is exactly the set of windows at every base
    position, so no per-frame phase selection is needed — each source
    shift ``aa[3k:]`` is a stride-1 offset slice, not a strided read.
    """
    n = aa.shape[0]
    n_win = max(n - 3 * K + 1, 0)
    hi = jnp.zeros(n_win, _U32)
    lo = jnp.zeros(n_win, _U32)
    for k in range(K):
        a = jax.lax.dynamic_slice_in_dim(aa, 3 * k, n_win)
        hi = (hi << 8) | (lo >> 24)
        lo = (lo << 8) | a
    return hi, lo


def _aa_windows_step3_mw(aa, K: int):
    """Multi-limb twin of :func:`_aa_windows_step3` for K > 7 amino
    acids (M = ceil(8K/32) uint32 limbs, big-endian — the reference's
    multi-word AA kmers, /root/reference/src/kmer.jl:82)."""
    n = aa.shape[0]
    n_win = max(n - 3 * K + 1, 0)
    M = max(-(-8 * K // 32), 1)
    limbs = [jnp.zeros(n_win, _U32) for _ in range(M)]
    for k in range(K):
        a = jax.lax.dynamic_slice_in_dim(aa, 3 * k, n_win)
        for j in range(M - 1):
            limbs[j] = (limbs[j] << 8) | (limbs[j + 1] >> 24)
        limbs[M - 1] = (limbs[M - 1] << 8) | a
    return tuple(limbs)


def _strand_windows(codes, certain, K: int, own_lo, own_hi, tbl):
    """AA kmer windows + validity for ONE strand stream, all frames at
    once (see :func:`_aa_windows_step3`).  A window is emitted iff its
    start lies in the ownership span [own_lo, own_hi) — the body — and
    all 3K bases are certain.  The bounds may be traced i32 scalars (the
    streamed driver clips the tail chunk's body dynamically so one
    compiled program serves every chunk)."""
    aa = _aa_stream(codes, tbl)
    hi, lo = _aa_windows_step3(aa, K)
    valid = window_valid_mask(certain, 3 * K)
    starts = jnp.arange(hi.shape[0], dtype=_I32)
    own = (starts >= own_lo) & (starts < own_hi)
    return hi, lo, valid & own


def _strand_windows_mw(codes, certain, K: int, own_lo, own_hi, tbl):
    aa = _aa_stream(codes, tbl)
    limbs = _aa_windows_step3_mw(aa, K)
    valid = window_valid_mask(certain, 3 * K)
    starts = jnp.arange(limbs[0].shape[0], dtype=_I32)
    own = (starts >= own_lo) & (starts < own_hi)
    return limbs, valid & own


def _sixframe_local_body(rows, pad3, K: int, tbl, checked: bool):
    """Per-device six-frame window build + sort/RLE for ONE chunk row of
    shape (1, 2H + B) — the local-count half of the streamed pipeline
    (the hot loop of /root/reference/src/transformations.jl:43-70 as one
    batched dispatch).

    ``pad3``: traced i32 scalar — how many trailing 0x00 bytes pad this
    chunk's body (a multiple of 3; nonzero only on the tail chunk).  The
    forward-frame ownership span shrinks to [H, H + B - pad3) so windows
    starting in the pad region (whose bases are the next device's real
    body, present here as right-halo data) are not double-counted; on
    the reversed stream the pad sits at the START, shifting the span to
    [H + pad3, H + B).

    Always returns the device's valid-window tally (metrics); with
    ``checked`` also the counted tally for the conservation assert."""
    data = rows[0]
    p3 = pad3[0]
    H = 3 * K
    body_len = data.shape[0] - 2 * H
    codes, certain, _ambig = classify_2bit(data)
    rc_codes = (codes ^ 3)[::-1]
    rc_certain = certain[::-1]
    fh, fl, fv = _strand_windows(codes, certain, K, H, H + body_len - p3, tbl)
    rh, rl, rv = _strand_windows(
        rc_codes, rc_certain, K, H + p3, H + body_len, tbl
    )
    hi = jnp.concatenate([fh, rh])
    lo = jnp.concatenate([fl, rl])
    valid = jnp.concatenate([fv, rv])
    uh, ul, cnt, nu = sort_count(hi, lo, valid, key_bits=8 * K)
    n_valid = jnp.sum(valid, dtype=_I32)
    # 1-D table boundaries (see pipeline._compact_body)
    out = (uh, ul, cnt, nu[None], n_valid[None])
    if checked:
        out = out + (jnp.sum(cnt, dtype=_I32)[None],)
    return out


import functools


def _chunk_geometry(chunk_size: int, shard: int, K: int):
    """(body length B, chunk count, row length) of the streamed drivers:
    B is a multiple of 3 that covers the slab in equal rows, each row
    carrying 3K bases of halo on both sides."""
    B = max(min(chunk_size - chunk_size % 3, shard), 3)
    # a sort that pads to the next power of two doubles when the window
    # stream is only a few entries past 2^m: when the overhang is small,
    # shave the body so the 2(B + 3K + 1) windows fit exactly
    T = 2 * (B + 3 * K + 1)
    m = T.bit_length() - 1
    if T > (1 << m) and (T - (1 << m)) <= (1 << m) // 16:
        B2 = (1 << m) // 2 - 3 * K - 1
        B = max(B2 - B2 % 3, 3)
    return B, -(-shard // B), B + 2 * 3 * K


@functools.lru_cache(maxsize=64)
def _sixframe_local_step(
    mesh: Mesh, K: int, tbl_bytes: bytes, checked: bool = False
):
    """Cached per-chunk local count (no exchange) for streaming.
    Outputs (uh, ul, cnt, nu, n_valid[, n_cnt])."""
    axis = mesh.axis_names[0]
    tbl = np.frombuffer(tbl_bytes, np.uint8)
    body = partial(_sixframe_local_body, K=K, tbl=tbl, checked=checked)
    spec = P(axis)  # 1-D table boundaries (see pipeline._compact_body)
    outs = (spec, spec, spec, P(axis), P(axis))
    if checked:
        outs = outs + (P(axis),)
    mapped = jax.shard_map(
        body,
        mesh=mesh,
        # pad3 is replicated (same tail-clip on every device)
        in_specs=(P(axis, None), P(None)),
        out_specs=outs,
    )
    return jax.jit(mapped)


def _sixframe_local_body_mw(rows, pad3, K: int, tbl, checked: bool):
    """Multi-limb twin of :func:`_sixframe_local_body` (K > 7 amino
    acids) — per-chunk frame windows + M-limb sort/RLE, no exchange."""
    from ..ops.multiword import sort_count_mw

    data = rows[0]
    p3 = pad3[0]
    H = 3 * K
    body_len = data.shape[0] - 2 * H
    codes, certain, _ambig = classify_2bit(data)
    rc_codes = (codes ^ 3)[::-1]
    rc_certain = certain[::-1]
    fw_limbs, fw_valid = _strand_windows_mw(
        codes, certain, K, H, H + body_len - p3, tbl
    )
    rv_limbs, rv_valid = _strand_windows_mw(
        rc_codes, rc_certain, K, H + p3, H + body_len, tbl
    )
    M = len(fw_limbs)
    limbs = tuple(
        jnp.concatenate([fw_limbs[m], rv_limbs[m]]) for m in range(M)
    )
    valid = jnp.concatenate([fw_valid, rv_valid])
    ulimbs, cnt, nu = sort_count_mw(limbs, valid, key_bits=8 * K)
    n_valid = jnp.sum(valid, dtype=_I32)
    # 1-D table boundaries (see pipeline._compact_body)
    out = (ulimbs, cnt, nu[None], n_valid[None])
    if checked:
        out = out + (jnp.sum(cnt, dtype=_I32)[None],)
    return out


@functools.lru_cache(maxsize=64)
def _sixframe_local_step_mw(
    mesh: Mesh, K: int, tbl_bytes: bytes, checked: bool = False
):
    from ..ops.multiword import n_limbs

    axis = mesh.axis_names[0]
    M = n_limbs(K, bps=8)
    tbl = np.frombuffer(tbl_bytes, np.uint8)
    body = partial(_sixframe_local_body_mw, K=K, tbl=tbl, checked=checked)
    spec = P(axis)  # 1-D table boundaries (see pipeline._compact_body)
    outs = (tuple(spec for _ in range(M)), spec, P(axis), P(axis))
    if checked:
        outs = outs + (P(axis),)
    mapped = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(axis, None), P(None)),
        out_specs=outs,
    )
    return jax.jit(mapped)


@functools.lru_cache(maxsize=64)
def _compact_step_mw(mesh: Mesh, M: int):
    from ..ops.multiword import compact_counts_mw

    axis = mesh.axis_names[0]

    def body(*args):
        ol, oc = compact_counts_mw(tuple(args[:M]), args[M])
        return ol + (oc,)

    spec = P(axis)  # 1-D table boundaries (see pipeline._compact_body)
    mapped = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(spec,) * (M + 1),
        out_specs=(spec,) * (M + 1),
    )
    return jax.jit(mapped)


@functools.lru_cache(maxsize=64)
def _merge_step_mw(mesh: Mesh, M: int):
    from ..ops.multiword import merge_compact_tables_mw

    axis = mesh.axis_names[0]

    def body(*args):
        la = tuple(args[:M])
        ca = args[M]
        lb = tuple(args[M + 1 : 2 * M + 1])
        cb = args[2 * M + 1]
        ol, oc, nu = merge_compact_tables_mw(la, ca, lb, cb)
        return ol + (oc, nu[None])

    spec = P(axis)  # 1-D table boundaries (see pipeline._compact_body)
    mapped = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(spec,) * (2 * M + 2),
        out_specs=(spec,) * (M + 1) + (P(axis),),
    )
    return jax.jit(mapped)


@functools.lru_cache(maxsize=64)
def _exchange_step_mw(mesh: Mesh, M: int, cap: int):
    from .multiword import exchange_and_merge_mw

    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size

    def body(*args):
        ul, c, nu, overflow = exchange_and_merge_mw(
            tuple(args[:M]), args[M], n_dev, cap, axis
        )
        total_overflow = jax.lax.psum(overflow, axis)
        return ul + (c, nu[None], total_overflow[None])

    spec = P(axis)  # 1-D table boundaries (see pipeline._compact_body)
    mapped = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(spec,) * (M + 1),
        out_specs=(spec,) * (M + 1) + (P(axis), P(axis)),
    )
    return jax.jit(mapped)


def _streamed_sixframe_count_mw(
    shards: np.ndarray,
    shard: int,
    mesh: Mesh,
    config: SixFrameCountConfig,
    sharding,
    tbl_bytes: bytes,
):
    """Multi-limb twin of :func:`_streamed_sixframe_count` (K > 7)."""
    from ..ops.count import _next_pow2
    from ..ops.multiword import n_limbs
    from ..utils.debug import checked_mode
    from ..utils.levelstack import LevelStack

    n_dev = mesh.devices.size
    K = config.K
    M = n_limbs(K, bps=8)
    checked = checked_mode()
    B, n_chunks, row_len = _chunk_geometry(config.chunk_size, shard, K)

    count = _sixframe_local_step_mw(mesh, K, tbl_bytes, checked)
    compact = _compact_step_mw(mesh, M)
    merge = _merge_step_mw(mesh, M)

    def _slice_nu(tbl, nu):
        cap = _next_pow2(max(int(_fetch_np(nu).max()), 1))
        if n_dev == 1:
            return tuple(x[:cap] for x in tbl)
        return tuple(
            x.reshape(n_dev, -1)[:, :cap].reshape(-1) for x in tbl
        )

    stack = LevelStack(
        lambda a, b: merge(*a, *b),
        lambda out: _slice_nu(out[: M + 1], out[M + 1]),
    )

    dev_valid = dev_cnt = 0

    def _drain(out):
        # host-int tallies (see the K <= 7 driver)
        nonlocal dev_valid, dev_cnt
        ulimbs, cnt, nu, n_valid = out[:4]
        dev_valid += int(_fetch_np(n_valid).sum())
        if checked:
            dev_cnt += int(_fetch_np(out[4]).sum())
        packed = compact(*ulimbs, cnt)
        stack.push(_slice_nu(packed, nu))

    from ..utils.streamq import DrainQueue

    # prefetch the capacity scalar (index 2) + the tally scalars
    queue = DrainQueue(_drain, nu_index=(2, 3, 4) if checked else (2, 3))
    for c in range(n_chunks):
        rows = shards[:, c * B : c * B + row_len]
        b_true = min(B, shard - c * B)
        if rows.shape[1] < row_len:
            rows = np.concatenate(
                [rows, np.zeros((n_dev, row_len - rows.shape[1]), np.uint8)],
                axis=1,
            )
        pad3 = np.asarray([B - b_true], np.int32)
        out = count(
            _put_sharded(np.ascontiguousarray(rows), sharding), pad3
        )
        queue.push(out)
    queue.flush()

    tbl = stack.fold()
    C = tbl[0].shape[0] // n_dev
    cap = max(int(np.ceil(C * config.bucket_factor / n_dev)), 1)
    exchange = _exchange_step_mw(mesh, M, cap)
    out = exchange(*tbl)
    ulimbs, cnt, _nu, overflow = out[:M], out[M], out[M + 1], out[M + 2]
    total_valid = dev_valid
    if checked:
        total_counted = dev_cnt
        if total_valid != total_counted:
            raise RuntimeError(
                "checked mode: count conservation violated in the "
                f"multi-limb six-frame local count — {total_valid} valid "
                f"windows but {total_counted} counted"
            )
    return ulimbs, cnt, overflow, total_valid


def sharded_sixframe_aa_count(
    data,
    config: SixFrameCountConfig = SixFrameCountConfig(),
    mesh: Mesh | None = None,
    metrics=None,
):
    """Count amino-acid K-mers over all six reading frames of ``data``
    across the mesh.  Ambiguous bases invalidate the windows that touch
    them; returns (kmer_values, counts int64) sorted, and the result is
    bit-identical for any device count.  ``kmer_values`` is uint64 for
    K <= 7 (single 56-bit registers) and an object array of Python ints
    for K > 7 (multi-limb registers, the reference's multi-word AA kmers
    /root/reference/src/kmer.jl:82).

    Device slabs longer than ``config.chunk_size`` bases stream chunk by
    chunk with the level-stack accumulator and one final hash-prefix
    exchange (K <= 7).  ``metrics``: optional :class:`kmers_tpu.utils.Metrics`;
    checked mode asserts count conservation through sort/RLE and the
    exchange.
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
    H = 3 * K
    L = arr.shape[0]
    if L < 3 * K:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)

    # shard: multiple of 3 covering the input
    shard = -(-L // n_dev)
    shard += (-shard) % 3
    padded = np.zeros(n_dev * shard + H, dtype=np.uint8)  # 0x00 = invalid
    padded[:L] = arr
    shards = np.zeros((n_dev, shard + 2 * H), dtype=np.uint8)
    for d in range(n_dev):
        lo_i = d * shard - H
        src_lo = max(lo_i, 0)
        dst_lo = src_lo - lo_i
        seg = padded[src_lo : d * shard + shard + H]
        shards[d, dst_lo : dst_lo + seg.shape[0]] = seg

    tbl_bytes = bytes(np.asarray(config.code.tbl).tobytes())
    axis = mesh.axis_names[0]
    sharding = NamedSharding(mesh, P(axis, None))
    if K > 7:
        from ..ops.multiword import mw_to_numpy
        from ..utils.debug import checked_mode

        ulimbs, cnt, overflow, total_valid = _streamed_sixframe_count_mw(
            shards, shard, mesh, config, sharding, tbl_bytes
        )
        if int(_fetch_np(overflow)[0]) > 0:
            raise RuntimeError(
                "hash-prefix bucket overflow; increase bucket_factor"
            )
        cnt = _fetch_np(cnt).reshape(-1)
        keep = cnt > 0
        kmers = mw_to_numpy(
            tuple(_fetch_np(x).reshape(-1)[keep] for x in ulimbs)
        )
        cnt = cnt[keep].astype(np.int64)
        if checked_mode() and int(cnt.sum()) != total_valid:
            raise RuntimeError(
                "checked mode: count conservation violated across the "
                f"multi-limb six-frame exchange — {total_valid} valid "
                f"windows but {int(cnt.sum())} in the merged table"
            )
        order = np.argsort([int(v) for v in kmers], kind="stable")
        kmers, cnt = kmers[order], cnt[order]
        if metrics is not None:
            # 2(L - 3K + 1) six-frame windows exist; skipped = the
            # ambiguity-invalidated ones (valid windows == counted when
            # conservation holds)
            n_possible = max(2 * (L - 3 * K + 1), 0)
            metrics.end_batch(
                bases_in=L,
                windows_out=int(cnt.sum()),
                windows_skipped=n_possible - total_valid,
                distinct_kmers=int(kmers.shape[0]),
            )
        return kmers, cnt
    uh, ul, cnt, overflow, total_valid = _streamed_sixframe_count(
        shards, shard, mesh, config, sharding, tbl_bytes
    )
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
    from ..utils.debug import checked_mode

    if checked_mode() and int(cnt.sum()) != total_valid:
        raise RuntimeError(
            "checked mode: count conservation violated across the "
            f"six-frame exchange — {total_valid} valid windows but "
            f"{int(cnt.sum())} in the merged table"
        )
    order = np.argsort(kmers, kind="stable")
    kmers, cnt = kmers[order], cnt[order]
    if metrics is not None:
        # see the K > 7 branch: skipped = possible - valid
        n_possible = max(2 * (L - 3 * K + 1), 0)
        metrics.end_batch(
            bases_in=L,
            windows_out=int(cnt.sum()),
            windows_skipped=n_possible - total_valid,
            distinct_kmers=int(kmers.shape[0]),
        )
    return kmers, cnt


def _streamed_sixframe_count(
    shards: np.ndarray,
    shard: int,
    mesh: Mesh,
    config: SixFrameCountConfig,
    sharding,
    tbl_bytes: bytes,
):
    """Stream each device's (H + shard + H) slab in chunk-sized bodies
    with two-sided 3K halos, fold per-device tables with the level-stack,
    and exchange once — the six-frame twin of
    ``pipeline._streamed_sharded_count``.  Chunk bodies are multiples of
    3 and tile the slab body exactly, so frame ownership masks are the
    per-chunk restriction of the per-device masks (same geometry
    argument as the module docstring, one level down)."""
    from ..ops.count import _next_pow2
    from ..utils.debug import checked_mode
    from ..utils.levelstack import LevelStack
    from .pipeline import _compact_step, _exchange_step, _merge_step

    n_dev = mesh.devices.size
    K = config.K
    checked = checked_mode()
    B, n_chunks, row_len = _chunk_geometry(config.chunk_size, shard, K)

    count = _sixframe_local_step(mesh, K, tbl_bytes, checked)
    compact = _compact_step(mesh)
    merge = _merge_step(mesh)

    def _slice_nu(tbl, nu):
        cap = _next_pow2(max(int(_fetch_np(nu).max()), 1))
        if n_dev == 1:
            return tuple(x[:cap] for x in tbl)
        return tuple(
            x.reshape(n_dev, -1)[:, :cap].reshape(-1) for x in tbl
        )

    stack = LevelStack(
        lambda a, b: merge(*a, *b), lambda out: _slice_nu(out[:3], out[3])
    )

    dev_valid = dev_cnt = 0

    def _drain(out):
        # host-int tallies from the async-prefetched scalars (no device
        # int32 overflow past ~2^31 windows, no extra round trip)
        nonlocal dev_valid, dev_cnt
        uh, ul, cnt, nu, n_valid = out[:5]
        dev_valid += int(_fetch_np(n_valid).sum())
        if checked:
            dev_cnt += int(_fetch_np(out[5]).sum())
        uh, ul, cnt = compact(uh, ul, cnt)
        stack.push(_slice_nu((uh, ul, cnt), nu))

    from ..utils.streamq import DrainQueue

    # prefetch the capacity scalar (index 3) + the tally scalars
    queue = DrainQueue(_drain, nu_index=(3, 4, 5) if checked else (3, 4))
    for c in range(n_chunks):
        rows = shards[:, c * B : c * B + row_len]
        # body bytes actually inside the slab body (the rest of the row's
        # body region is right-halo data owned by the next chunk/device)
        b_true = min(B, shard - c * B)
        if rows.shape[1] < row_len:
            # tail chunk: pad the row to the uniform dispatch shape with
            # 0x00; ownership clips at b_true so nothing double-counts
            rows = np.concatenate(
                [
                    rows,
                    np.zeros((n_dev, row_len - rows.shape[1]), np.uint8),
                ],
                axis=1,
            )
        pad3 = np.asarray([B - b_true], np.int32)
        out = count(
            _put_sharded(np.ascontiguousarray(rows), sharding), pad3
        )
        queue.push(out)
    queue.flush()

    tbl = stack.fold()
    C = tbl[0].shape[0] // n_dev
    cap = max(int(np.ceil(C * config.bucket_factor / n_dev)), 1)
    exchange = _exchange_step(mesh, K, cap)
    uh, ul, cnt, nu, overflow = exchange(*tbl)
    total_valid = dev_valid
    if checked:
        total_counted = dev_cnt
        if total_valid != total_counted:
            raise RuntimeError(
                "checked mode: count conservation violated in the "
                f"six-frame local count — {total_valid} valid windows "
                f"but {total_counted} counted"
            )
    return uh, ul, cnt, overflow, total_valid
