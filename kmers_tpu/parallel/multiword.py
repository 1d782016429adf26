"""Sharded canonical counting for K > 31 (multi-limb registers).

Extends the hash-prefix ``all_to_all`` exchange of
:mod:`kmers_tpu.parallel.pipeline` to M-limb kmer registers
(:mod:`kmers_tpu.ops.multiword`), covering the reference's multi-word
``NTuple`` kmers (/root/reference/src/kmer.jl:32-44) at device-mesh
scale.  Same structure: halo sharding, local aggregate, route table rows
by FxHash prefix, merge received partitions with a weighted multi-key
run-length encode.

No sentinel register value exists for M limbs (all-ones could be a real
kmer when K*2 == 32*M, e.g. K=32,48), so padding is carried as an
explicit invalid-flag limb leading every sort — the same convention as
:func:`kmers_tpu.ops.multiword.sort_count_mw`.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.encode import classify_2bit
from ..ops.multiword import (
    canonical_windows_mw,
    fx_hash_mw,
    mw_to_numpy,
    n_limbs,
    sort_count_mw,
)
from ..ops.windows import window_valid_mask
from .mesh import data_mesh
from .pipeline import _fetch_np, _put_sharded, _shard_with_halo

__all__ = ["sharded_canonical_count_mw", "exchange_and_merge_mw"]

_U32 = jnp.uint32
_I32 = jnp.int32


def _rle_mw(sflag, slimbs, weights):
    """Weighted run-length encode of a pre-sorted (flag, limbs) stream.

    The multi-limb twin of ``ops.count._run_length_encode``: scatter- and
    gather-free (neighbor compares + cumulative scans + one stable
    partition sort).  Rows with ``sflag == 1`` are padding and sort last;
    they are excluded from the table (all-ones limbs, zero counts).
    """
    n = sflag.shape[0]
    ones = jnp.asarray(0xFFFFFFFF, _U32)
    neq = sflag[1:] != sflag[:-1]
    for x in slimbs:
        neq = neq | (x[1:] != x[:-1])
    first = jnp.concatenate([jnp.ones(1, bool), neq])
    is_last = jnp.concatenate([first[1:], jnp.ones(1, bool)])
    w = weights.astype(_I32)
    wcum = jnp.cumsum(w)
    start_w = lax.cummax(jnp.where(first, wcum - w, 0))
    run_total = wcum - start_w
    # sentinel-interspersed emission (no compaction pass — see ops.count)
    emit = is_last & (sflag == 0)
    ulimbs = tuple(jnp.where(emit, x, ones) for x in slimbs)
    counts = jnp.where(emit, run_total, 0)
    n_runs = jnp.sum(first.astype(_I32))
    n_unique = n_runs - (sflag[-1] == 1).astype(_I32)
    return ulimbs, counts, n_unique


def exchange_and_merge_mw(ulimbs, cnt, n_dev: int, cap: int, axis: str):
    """Route a local multi-limb (kmer, count) table by FxHash prefix over
    ``all_to_all`` and merge the received partitions.

    Padding rows are identified by ``cnt == 0`` (real rows always have
    count >= 1).  Returns (ulimbs, counts, n_unique, overflow).
    """
    ulimbs = tuple(ulimbs)
    M = len(ulimbs)
    n_rows = ulimbs[0].shape[0]
    ones = jnp.asarray(0xFFFFFFFF, _U32)
    is_pad = cnt == 0

    hh, _hl = fx_hash_mw(ulimbs, K=0)
    shift = 32 - max(n_dev - 1, 1).bit_length()
    dest = (hh >> shift).astype(_U32) % n_dev
    rr = jnp.arange(n_rows, dtype=_U32) % n_dev
    dest = jnp.where(is_pad, rr, dest)

    # sort by (destination, is_pad): real rows lead each segment, so a
    # bucket truncating at `cap` only drops padding filler.  Unstable:
    # within an equal key the row order is irrelevant (receiver re-sorts).
    key = dest * 2 + is_pad.astype(_U32)
    sorted_all = lax.sort((key, *ulimbs, cnt), num_keys=1, is_stable=False)
    slimbs, scnt = sorted_all[1:-1], sorted_all[-1]
    seg_counts = jnp.bincount(dest.astype(_I32), length=n_dev)
    seg_real = jnp.bincount(
        jnp.where(is_pad, n_dev, dest.astype(_I32)), length=n_dev + 1
    )[:n_dev]
    seg_starts = jnp.concatenate(
        [jnp.zeros(1, seg_counts.dtype), jnp.cumsum(seg_counts)[:-1]]
    )
    overflow = jnp.sum(jnp.maximum(seg_real - cap, 0))

    # per-destination contiguous dynamic slices instead of one gather
    # (see pipeline.exchange_and_merge)
    in_seg = jnp.arange(cap, dtype=_I32)[None, :] < seg_counts[:, None]
    starts = jnp.clip(seg_starts, 0, n_rows).astype(_I32)
    pad_limbs = tuple(
        jnp.concatenate([x, jnp.full(cap, ones, _U32)]) for x in slimbs
    )
    pad_c = jnp.concatenate([scnt, jnp.zeros(cap, scnt.dtype)])
    blimbs = tuple(
        jnp.where(
            in_seg,
            jnp.stack(
                [
                    jax.lax.dynamic_slice(x, (starts[d],), (cap,))
                    for d in range(n_dev)
                ]
            ),
            ones,
        )
        for x in pad_limbs
    )
    bc = jnp.where(
        in_seg,
        jnp.stack(
            [
                jax.lax.dynamic_slice(pad_c, (starts[d],), (cap,))
                for d in range(n_dev)
            ]
        ),
        0,
    )

    a2a = partial(
        jax.lax.all_to_all, axis_name=axis, split_axis=0, concat_axis=0, tiled=True
    )
    blimbs = tuple(a2a(x) for x in blimbs)
    bc = a2a(bc)

    flat = tuple(x.reshape(-1) for x in blimbs)
    fc = bc.reshape(-1)
    flag = (fc == 0).astype(jnp.uint8)
    # unstable is safe: the RLE sums fc over each equal-key run
    sorted_all = lax.sort(
        (flag, *flat, fc), num_keys=M + 1, is_stable=False
    )
    sflag, slimbs2, scnt2 = sorted_all[0], sorted_all[1:-1], sorted_all[-1]
    ulimbs, counts, nu = _rle_mw(sflag, slimbs2, scnt2)
    return ulimbs, counts, nu, overflow


def _device_body_mw(shard_bytes, K: int, n_dev: int, cap: int, axis: str):
    data = shard_bytes[0]
    codes, certain, ambig = classify_2bit(data)
    body_len = data.shape[0] - (K - 1)
    invalid = (~(certain | ambig))[:body_len]
    limbs = canonical_windows_mw(codes, K)
    valid = window_valid_mask(certain, K)
    ulimbs, cnt, _ = sort_count_mw(limbs, valid, key_bits=2 * K)
    ulimbs, cnt, nu, overflow = exchange_and_merge_mw(
        ulimbs, cnt, n_dev, cap, axis
    )
    n_invalid = jax.lax.psum(jnp.sum(invalid), axis)
    total_overflow = jax.lax.psum(overflow, axis)
    return (
        tuple(x[None] for x in ulimbs),
        cnt[None],
        nu[None],
        n_invalid[None],
        total_overflow[None],
    )


import functools


@functools.lru_cache(maxsize=64)
def sharded_count_step_mw(mesh: Mesh, K: int, shard_len: int, cap: int):
    # cached per geometry: rebuilding the shard_map closure per call
    # would recompile every time
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    M = n_limbs(K)
    body = partial(_device_body_mw, K=K, n_dev=n_dev, cap=cap, axis=axis)
    mapped = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=P(axis, None),
        out_specs=(
            tuple(P(axis, None) for _ in range(M)),
            P(axis, None),
            P(axis),
            P(axis),
            P(axis),
        ),
    )
    return jax.jit(mapped)


def sharded_canonical_count_mw(
    data,
    K: int = 63,
    mesh: Mesh | None = None,
    bucket_factor: float = 2.0,
):
    """Count canonical K-mers (K > 31) across all devices of ``mesh``.

    Returns ``(kmers, counts)`` with ``kmers`` a sorted object array of
    Python-int register values — same format as the single-chip
    ``canonical_count_bytes`` multiword path, bit-exact parity with it.
    """
    if K <= 31:
        raise ValueError("use sharded_canonical_count for K <= 31")
    if isinstance(data, str):
        data = data.encode("ascii")
    arr = np.frombuffer(bytes(data), dtype=np.uint8).copy()
    if mesh is None:
        mesh = data_mesh()
    n_dev = mesh.devices.size
    L = arr.shape[0]
    if L < K:
        return np.zeros(0, object), np.zeros(0, np.int64)

    shards, shard = _shard_with_halo(arr, n_dev, K)
    n_win = shard  # windows per shard
    cap = int(np.ceil(n_win * bucket_factor / n_dev))
    step = sharded_count_step_mw(mesh, K, shard, cap)
    axis = mesh.axis_names[0]
    sharding = NamedSharding(mesh, P(axis, None))
    shards_dev = _put_sharded(shards, sharding)
    ulimbs, cnt, nu, n_invalid, overflow = step(shards_dev)

    pad = n_dev * shard - L
    if int(_fetch_np(n_invalid)[0]) - pad > 0:
        from ..alphabets import EncodeError, DNAAlphabet2

        raise EncodeError(DNAAlphabet2(), "<batch input>")
    if int(_fetch_np(overflow)[0]) > 0:
        raise RuntimeError(
            "hash-prefix bucket overflow; increase bucket_factor"
        )

    cnt = _fetch_np(cnt).reshape(-1)
    keep = cnt > 0
    vals = mw_to_numpy(
        tuple(_fetch_np(x).reshape(-1)[keep] for x in ulimbs)
    )
    cnt = cnt[keep].astype(np.int64)
    order = np.argsort([int(v) for v in vals], kind="stable")
    return vals[order], cnt[order]
