"""Multi-process (jax.distributed) mesh execution.

Launches two real worker processes, each with its own virtual CPU
devices, forming one process-spanning mesh — the hash-prefix exchange's
``all_to_all`` crosses a process boundary (the path a single-process
virtual mesh cannot exercise).  Parity is asserted inside each worker
against the single-chip pipeline (tools/multiproc_worker.py).
"""

import importlib.util
import pathlib

import pytest


def _load_runner():
    path = (
        pathlib.Path(__file__).resolve().parent.parent
        / "tools"
        / "run_multiproc.py"
    )
    spec = importlib.util.spec_from_file_location("run_multiproc", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_two_process_parity():
    mod = _load_runner()
    artifact = mod.run(nproc=2, devices_per_proc=2, bases=30_000, timeout=420)
    assert artifact["ok"], artifact
    assert len(artifact["results"]) == 2
    for r in artifact["results"]:
        assert r["n_devices_global"] == 4
        assert r["single_dispatch_parity"] and r["streamed_parity"]
