"""Benchmark all five BASELINE.json configs; one JSON line each.

Configs (BASELINE.md):
  1. every-31-mer extraction / 2-bit encoding
  2. canonical 31-mer counting (the headline metric — same as bench.py),
     K=47 multi-limb counting, and sharded counting on a 1-device mesh
  3. minimizer-window selection (and spaced sampling)
  4. 4-bit ambiguous path with N-masked skipping
  5. six-frame translated AA k-mers + sharded count-table merge

Run on the GPU: `python tools/bench_all.py`.  Every timed call ends in
``block_until_ready``; the first line names the device and the card.
The minhash and six-frame cells time the public wrappers, host transfer
included.  ROADMAP S1 replaces this with the per-cell benchmark.
"""

import json
import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def _timeit(fn, *args, reps=4):
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(fn(*args))
    return (time.perf_counter() - t0) / reps


def main():
    from kmers_tpu.utils.compile_cache import use_compile_cache

    use_compile_cache()
    import jax
    import jax.numpy as jnp

    from bench import card_name

    rng = np.random.default_rng(0)
    L = 1 << int(os.environ.get("BENCH_LOG2L", "26"))
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, L)]
    data = jax.device_put(acgt)
    dev = jax.devices()[0]
    print(json.dumps({
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card_name() if dev.platform == "gpu" else None,
    }), flush=True)

    def emit(metric, bases, secs, baseline=None):
        rec = {
            "metric": metric,
            "value": round(bases / secs),
            "unit": "bases/sec",
        }
        if baseline:
            rec["vs_baseline"] = round(bases / secs / baseline, 3)
        print(json.dumps(rec), flush=True)

    # ---- config 1: every-31-mer extraction / 2-bit encoding ----
    from kmers_tpu.ops.encode import classify_2bit
    from kmers_tpu.ops.windows import (
        canonical_windows_4bit_from_codes,
        window_valid_mask,
        windows_from_codes,
    )

    @jax.jit
    def extract31(b):
        codes, certain, _ = classify_2bit(b)
        hi, lo = windows_from_codes(codes, 31)
        return hi, lo, jnp.sum(certain)

    emit("extract_31mer_2bit", L, _timeit(extract31, data))

    # ---- config 2: canonical 31-mer counting (headline) ----
    from kmers_tpu.pipelines.canonical_count import _chunk_count

    dt = _timeit(partial(_chunk_count, K=31), data)
    emit("canonical_31mer_count", L, dt, baseline=5.0e7)

    # ---- config 2b: K=47 multi-limb canonical counting, at the
    # multi-limb pipeline's default 2^19-base chunks ----
    from kmers_tpu.ops.multiword import canonical_windows_mw, sort_count_mw

    @jax.jit
    def count47(b):
        codes, certain, _ = classify_2bit(b)
        limbs = canonical_windows_mw(codes, 47)
        return sort_count_mw(
            limbs, window_valid_mask(certain, 47), key_bits=2 * 47
        )

    L2 = min(1 << 24, L)
    CH47 = min(1 << 19, L2)
    args47 = [
        jax.device_put(acgt[c * CH47 : (c + 1) * CH47].copy())
        for c in range(L2 // CH47)
    ]
    dt = _timeit(lambda: [count47(a) for a in args47])
    emit("canonical_47mer_count_multilimb", L2, dt)

    # ---- config 2c: sharded counting on a 1-device mesh (the SPMD
    # program's single-device throughput vs the flagship) ----
    from jax.sharding import NamedSharding, PartitionSpec as P

    from kmers_tpu.parallel import data_mesh
    from kmers_tpu.parallel.pipeline import (
        ShardedCountConfig,
        _shard_with_halo,
        sharded_count_step,
    )

    mesh1 = data_mesh(1)
    CH = min(ShardedCountConfig().chunk_size, L2)
    sharding1 = NamedSharding(mesh1, P(mesh1.axis_names[0], None))
    args_s, stepf = [], None
    for c in range(L2 // CH):
        shards, shard = _shard_with_halo(
            acgt[c * CH : (c + 1) * CH].copy(), 1, 31, pad_byte=ord("N")
        )
        if stepf is None:
            stepf = sharded_count_step(mesh1, 31, shard, int(np.ceil(shard * 2.0)))
        args_s.append(jax.device_put(shards, sharding1))
    dt = _timeit(lambda: [stepf(a) for a in args_s])
    emit("sharded_count_1dev", L2, dt, baseline=5.0e7)

    # ---- config 3: minimizer windows (+ spaced) ----
    from kmers_tpu.ops.minimizer import minimizers as _minimizers
    from kmers_tpu.pipelines.extract import _extract

    @jax.jit
    def minz(b):
        hi, lo, valid, n_inv, n_amb = _extract(b, 15, True)
        return _minimizers(hi, lo, 10)

    emit("minimizer_select_w10_k15", L, _timeit(minz, data))

    @jax.jit
    def spaced(b):
        hi, lo, valid, n_inv, n_amb = _extract(b, 31, False)
        return hi[::7], lo[::7]

    emit("spaced_31mer_step7", L, _timeit(spaced, data))

    # ---- config 4: 4-bit ambiguous path with N-masked skipping ----
    from kmers_tpu.alphabets import DNAAlphabet4
    from kmers_tpu.ops.encode import encode_table

    acgtn = np.frombuffer(b"ACGTN", dtype=np.uint8)[rng.integers(0, 5, L)]
    data_n = jax.device_put(acgtn)

    @jax.jit
    def four_bit(b):
        codes, valid_sym = encode_table(b, DNAAlphabet4)
        _, certain, _ = classify_2bit(b)
        hi, lo = canonical_windows_4bit_from_codes(codes, 15)
        mask = window_valid_mask(certain, 15)
        return hi, lo, mask

    emit("fourbit_canonical_15mer_nmasked", L, _timeit(four_bit, data_n))

    # ---- config 3b: minhash sketching (reference headline: 200 MB/s,
    # /root/reference/docs/src/minhash.md:37-41 — CanonicalDNAMers{16} +
    # fx_hash, sketch size 1000; bytes/sec == bases/sec on ASCII FASTA) ----
    from kmers_tpu.pipelines.minhash import minhash_sketch

    Lmh = min(1 << 26, L)
    s6b = bytes(acgt[:Lmh].tobytes())
    dt = _timeit(lambda: minhash_sketch(s6b, K=16, s=1000))
    emit("minhash_sketch_k16_s1000", Lmh, dt, baseline=2.0e8)

    # ---- config 5: six-frame AA kmers + sharded count merge ----
    from kmers_tpu.parallel.sixframe import (
        SixFrameCountConfig,
        sharded_sixframe_aa_count,
    )

    L6 = min(1 << 24, L)
    s6 = bytes(acgt[:L6].tobytes())
    cfg = SixFrameCountConfig(K=7)
    dt = _timeit(lambda: sharded_sixframe_aa_count(s6, cfg, mesh1), reps=2)
    emit("sixframe_aa7_sharded_count", L6, dt)


if __name__ == "__main__":
    main()
