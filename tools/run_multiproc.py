"""Launch the multi-process (jax.distributed) parity run and report it.

Spawns N worker processes (tools/multiproc_worker.py), each with its own
set of virtual CPU devices, forming one process-spanning mesh.  Verifies
that ``sharded_canonical_count`` over that mesh is bit-exact vs the
single-chip pipeline on both the single-dispatch and streamed paths.

CPU-only by design: the workers pin ``JAX_PLATFORMS=cpu`` and use gloo
collectives, so no worker ever opens a GPU (several JAX processes on one
card would each reserve most of its memory).  The four-card GPU path is
one process over all cards: ``python chip_smoke.py --multi``.

Usage: python tools/run_multiproc.py [--nproc 2] [--bases 200000]
"""

import argparse
import json
import os
import socket
import subprocess
import sys


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker_env(root: str) -> dict:
    """The child environment: CPU only, and the repo root importable (a
    script's ``sys.path[0]`` is its own directory, ``tools/``)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p
    )
    return env


def _make_oracle(root: str, bases: int, path: str):
    """Precompute single-process six-frame/multiword expectations in a
    SEPARATE process (computations on meshes that don't span every
    process are not legal inside the distributed job, so the workers
    compare against this file instead of a sub-mesh run)."""
    script = f"""
import json, sys
sys.path.insert(0, {root!r})
import jax
from tools.multiproc_worker import make_inputs
from kmers_tpu.parallel import SixFrameCountConfig, sharded_sixframe_aa_count, data_mesh
from kmers_tpu.pipelines import minimizer_select
from kmers_tpu.pipelines.canonical_count import CountConfig, canonical_count_bytes
s, s6, s47, smin = make_inputs({bases})
k6, c6 = sharded_sixframe_aa_count(s6, SixFrameCountConfig(K=5), data_mesh(1))
k47, c47 = canonical_count_bytes(s47, CountConfig(K=47))
mv, mp = minimizer_select(smin, K=15, W=10, skip_ambiguous=True)
json.dump({{
  "sixframe": {{"kmers": [str(int(x)) for x in k6], "counts": [int(x) for x in c6]}},
  "mw47": {{"kmers": [str(int(x)) for x in k47], "counts": [int(x) for x in c47]}},
  "minimizer": {{"vals": [str(int(x)) for x in mv], "pos": [int(x) for x in mp]}},
}}, open({path!r}, "w"))
print("oracle written")
"""
    subprocess.run(
        [sys.executable, "-c", script], check=True, cwd=root, timeout=600,
        env=_worker_env(root),
    )


def run(nproc: int = 2, devices_per_proc: int = 4, bases: int = 200_000,
        timeout: float = 600.0):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(root, "tools", "multiproc_worker.py")
    port = _free_port()
    import tempfile

    oracle_path = os.path.join(
        tempfile.mkdtemp(prefix="kmers-mp-"), "oracle.json"
    )
    _make_oracle(root, bases, oracle_path)
    procs = []
    for pid in range(nproc):
        procs.append(
            subprocess.Popen(
                [
                    sys.executable, worker,
                    "--pid", str(pid),
                    "--nproc", str(nproc),
                    "--port", str(port),
                    "--devices-per-proc", str(devices_per_proc),
                    "--bases", str(bases),
                    "--oracle", oracle_path,
                ],
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
                cwd=root,
                env=_worker_env(root),
            )
        )
    results, tails = [], []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        tails.append(out[-2000:])
        for line in out.splitlines():
            if line.startswith("RESULT "):
                results.append(json.loads(line[len("RESULT "):]))
    ok = (
        len(results) == nproc
        and all(r["ok"] for r in results)
        and all(p.returncode == 0 for p in procs)
    )
    artifact = {
        "ok": ok,
        "n_processes": nproc,
        "devices_per_process": devices_per_proc,
        "results": results,
        "returncodes": [p.returncode for p in procs],
    }
    if not ok:
        artifact["tails"] = tails
    return artifact


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--devices-per-proc", type=int, default=4)
    ap.add_argument("--bases", type=int, default=200_000)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    artifact = run(args.nproc, args.devices_per_proc, args.bases)
    print(json.dumps(artifact, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(artifact, f, indent=1)
    return 0 if artifact["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
