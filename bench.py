"""Benchmark: canonical 31-mer counting throughput (bases/sec/chip).

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "bases/sec", "vs_baseline": N,
   "device": {...}, "card": "<name>, <power limit>"}

The BASELINE.md reference point: Kmers.jl publishes no counting number;
its CanonicalKmers iteration runs at ~1 ns/base on a single CPU core and
dict counting dominates at ~20-50 ns/kmer, so we take 5.0e7 bases/sec as
a generous single-core estimate for canonical-31-mer *counting* (iterate
+ hash-table update) and report vs_baseline = value / 5.0e7.

Protocol: 2^24 bases per rep, dispatched as default-config
(CountConfig.chunk_size) counting chunks — the pipeline's per-chunk hot
path (front-end + sort + run-length encode).  Chunk inputs are staged on
the device before timing; each run ends in ``block_until_ready``.
Median of 3 steady-state runs of 16 reps each.  The next benchmark PR
(ROADMAP S1) replaces this with per-cell device and end-to-end rates.
"""

import json
import subprocess
import time

import numpy as np


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unknown ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"


def main():
    from kmers_tpu.utils.compile_cache import use_compile_cache

    use_compile_cache()
    import jax

    from kmers_tpu.pipelines.canonical_count import CountConfig, _chunk_count

    K = 31
    TOT = 1 << 24  # bases per logical rep
    rng = np.random.default_rng(0)
    data = np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, TOT)]

    chunk = min(CountConfig().resolved_chunk_size, TOT)
    args = [
        jax.device_put(data[c * chunk : (c + 1) * chunk].copy())
        for c in range(TOT // chunk)
    ]
    jax.block_until_ready(_chunk_count(args[0], K))  # compile + warm up

    def one_run(reps=16):
        t0 = time.perf_counter()
        outs = [_chunk_count(a, K) for _ in range(reps) for a in args]
        jax.block_until_ready(outs)
        return (time.perf_counter() - t0) / reps

    dt = sorted(one_run() for _ in range(3))[1]
    dev = jax.devices()[0]
    bases_per_sec = TOT / dt
    print(
        json.dumps(
            {
                "metric": "canonical_31mer_count_bases_per_sec_per_chip",
                "value": round(bases_per_sec),
                "unit": "bases/sec",
                "vs_baseline": round(bases_per_sec / 5.0e7, 3),
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
                "card": card_name() if dev.platform == "gpu" else None,
            }
        )
    )


if __name__ == "__main__":
    main()
