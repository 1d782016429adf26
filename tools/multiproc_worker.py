"""One process of the multi-process (jax.distributed) parity run.

Each process owns ``--devices-per-proc`` virtual CPU devices; the mesh
spans all processes, so the hash-prefix exchange's ``all_to_all`` and the
``psum`` tallies cross a process boundary (what the single-process
virtual mesh cannot exercise — SURVEY.md §4 "how they'd
test multi-node without a cluster").  Launch via tools/run_multiproc.py.

Cross-process collectives use JAX's gloo CPU backend; inputs are
deterministic (seeded) so every process builds identical host data (the
standard multi-controller SPMD contract).  Six-frame and multiword
expectations come precomputed from the runner's single-process run
(``--oracle``): computations on sub-meshes that do not span every
process are not legal mid-job, so cross-checks against 1-device runs
happen outside the distributed job.
"""

import argparse
import json
import os
import sys

import numpy as np


def make_inputs(bases: int):
    """Deterministic inputs shared by the runner's oracle pass and every
    worker (same seed, same draw order)."""
    rng = np.random.default_rng(123)
    s = "".join("ACGTNACGT"[i] for i in rng.integers(0, 9, bases))
    s6 = s[: min(bases, 30_000)]
    s47 = "".join("ACGT"[i] for i in rng.integers(0, 4, 20_000))
    smin = s[: min(bases, 40_000)]
    return s, s6, s47, smin


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--devices-per-proc", type=int, default=4)
    ap.add_argument("--bases", type=int, default=200_000)
    ap.add_argument("--oracle", default=None)
    args = ap.parse_args()

    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={args.devices_per_proc}"
    )
    os.environ["JAX_PLATFORMS"] = "cpu"  # CPU-only by design (gloo)
    import jax

    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(
        coordinator_address=f"localhost:{args.port}",
        num_processes=args.nproc,
        process_id=args.pid,
    )

    from jax.sharding import Mesh

    from kmers_tpu.parallel import ShardedCountConfig, sharded_canonical_count
    from kmers_tpu.pipelines import canonical_count

    assert jax.process_count() == args.nproc, (
        jax.process_count(),
        args.nproc,
    )
    n_dev = len(jax.devices())
    n_local = len(jax.local_devices())
    mesh = Mesh(np.array(jax.devices()), ("data",))

    s, s6, s47, smin = make_inputs(args.bases)

    # single-chip oracle, computed locally in this process (no mesh)
    k1, c1 = canonical_count(s, K=31)

    # 1) single-dispatch path over the process-spanning mesh
    k2, c2 = sharded_canonical_count(s, ShardedCountConfig(K=31), mesh)
    single_ok = bool(np.array_equal(k1, k2) and np.array_equal(c1, c2))

    # 2) streamed path: several chunks per device through the level-stack
    #    accumulator, one cross-process exchange at the end
    chunk = max(2048, args.bases // (n_dev * 3))
    k3, c3 = sharded_canonical_count(
        s, ShardedCountConfig(K=31, chunk_size=chunk), mesh
    )
    streamed_ok = bool(np.array_equal(k1, k3) and np.array_equal(c1, c3))

    # 3) six-frame AA counting and 4) K > 31 multi-limb counting over the
    #    process-spanning mesh vs the runner's precomputed oracles
    sixframe_ok = mw_ok = minimizer_ok = None
    if args.oracle:
        with open(args.oracle) as f:
            oracle = json.load(f)
        from kmers_tpu.parallel import (
            SixFrameCountConfig,
            sharded_canonical_count_mw,
            sharded_sixframe_aa_count,
        )

        a6k, a6c = sharded_sixframe_aa_count(
            s6, SixFrameCountConfig(K=5), mesh
        )
        sixframe_ok = bool(
            [int(x) for x in a6k] == [int(x) for x in oracle["sixframe"]["kmers"]]
            and list(map(int, a6c)) == oracle["sixframe"]["counts"]
        )

        a47k, a47c = sharded_canonical_count_mw(s47, K=47, mesh=mesh)
        mw_ok = bool(
            [int(x) for x in a47k] == [int(x) for x in oracle["mw47"]["kmers"]]
            and list(map(int, a47c)) == oracle["mw47"]["counts"]
        )

        # 5) minimizer selection over the process-spanning mesh
        from kmers_tpu.parallel.minimizers import sharded_minimizer_select

        mv, mp_ = sharded_minimizer_select(
            smin, K=15, W=10, mesh=mesh, skip_ambiguous=True
        )
        minimizer_ok = bool(
            [int(x) for x in mv] == [int(x) for x in oracle["minimizer"]["vals"]]
            and list(map(int, mp_)) == oracle["minimizer"]["pos"]
        )

    result = {
        "process_id": args.pid,
        "n_processes": args.nproc,
        "n_devices_global": n_dev,
        "n_devices_local": n_local,
        "bases": args.bases,
        "distinct_kmers": int(k1.shape[0]),
        "single_dispatch_parity": single_ok,
        "streamed_parity": streamed_ok,
        "sixframe_parity": sixframe_ok,
        "multiword_parity": mw_ok,
        "minimizer_parity": minimizer_ok,
        "ok": bool(
            single_ok
            and streamed_ok
            and sixframe_ok is not False
            and mw_ok is not False
            and minimizer_ok is not False
        ),
    }
    print("RESULT " + json.dumps(result), flush=True)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
