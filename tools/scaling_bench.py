"""Scaling-efficiency benchmark of the sharded counting step.

Weak scaling: FIXED per-device load, growing device count — the quantity
that demonstrates the exchange's algorithmic scaling (BASELINE.json's
>=80% target).  Runs on every visible device (four GPUs of one machine,
or ``SCALING_CPU_MESH=n`` virtual CPU devices to rehearse the path).

Per device count n in {1, 2, 4, 8, ...}: counts n * L_dev bases sharded
over n devices and reports bases/sec and efficiency vs the 1-device
throughput times n.  Prints one JSON line (a list of points).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    if os.environ.get("SCALING_CPU_MESH"):
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count="
            + os.environ["SCALING_CPU_MESH"]
        ).strip()
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    from jax.sharding import NamedSharding, PartitionSpec as P

    from kmers_tpu.parallel import data_mesh
    from kmers_tpu.parallel.pipeline import _shard_with_halo, sharded_count_step

    n_avail = len(jax.devices())
    on_cpu = jax.devices()[0].platform == "cpu"
    # per-device load: big enough that per-dispatch overhead amortizes
    L_dev = 1 << 20 if on_cpu else 1 << 24
    K = 31
    rng = np.random.default_rng(0)

    sizes = []
    n = 1
    while n <= n_avail:
        sizes.append(n)
        n *= 2
    if sizes[-1] != n_avail:
        sizes.append(n_avail)  # always measure the full slice

    results = []
    base = None
    for n in sizes:
        mesh = data_mesh(n)
        L = n * L_dev
        arr = np.frombuffer(b"ACGT", dtype=np.uint8)[
            rng.integers(0, 4, L)
        ].copy()
        shards, shard = _shard_with_halo(arr, n, K, pad_byte=ord("N"))
        cap = int(np.ceil(shard * 2.0 / n))
        step = sharded_count_step(mesh, K, shard, cap)
        sharding = NamedSharding(mesh, P(mesh.axis_names[0], None))
        shards_dev = jax.device_put(shards, sharding)
        # the device-side SPMD counting step, without the host fetch
        jax.block_until_ready(step(shards_dev))  # compile + warmup
        reps = 2 if on_cpu else 4
        t0 = time.perf_counter()
        jax.block_until_ready([step(shards_dev) for _ in range(reps)])
        dt = (time.perf_counter() - t0) / reps
        rate = L / dt
        if base is None:
            base = rate
        eff = rate / (base * n)
        results.append(
            {
                "devices": n,
                "bases_total": L,
                "bases_per_sec": round(rate),
                "efficiency": round(eff, 3),
            }
        )
        print(json.dumps(results[-1]), flush=True)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
