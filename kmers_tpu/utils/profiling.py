"""Profiling hooks (SURVEY.md §5 tracing/profiling obligation).

Thin wrappers over ``jax.profiler`` so pipelines can be traced without
importing profiler plumbing at call sites::

    with trace("/tmp/kmer-trace"):
        canonical_count(data, K=31)

View with TensorBoard or xprof.  ``annotate`` scopes label regions in
the trace timeline.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import tempfile

import jax

__all__ = ["trace", "annotate", "device_op_times", "profile_step"]


@contextlib.contextmanager
def trace(log_dir: str):
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """TraceAnnotation context manager for labeling pipeline stages."""
    return jax.profiler.TraceAnnotation(name)


def device_op_times(log_dir: str) -> dict[str, float]:
    """Summed duration (ms) per event name from the newest trace under
    ``log_dir``.  Device-executed HLOs appear under their HLO names
    (e.g. ``sort.0``, fusion/custom-call names); host-side events carry
    Python frames.  This is the stage-budget view used to find the
    pipeline bottleneck."""
    paths = glob.glob(
        os.path.join(log_dir, "**", "*.trace.json.gz"), recursive=True
    )
    if not paths:
        return {}
    newest = max(paths, key=os.path.getmtime)
    with gzip.open(newest) as f:
        events = json.load(f).get("traceEvents", [])
    out: dict[str, float] = {}
    for e in events:
        if e.get("ph") == "X" and "dur" in e and "name" in e:
            out[e["name"]] = out.get(e["name"], 0.0) + e["dur"] / 1e3
    return out


def profile_step(step, *args, reps: int = 2, top: int = 10):
    """Run ``step(*args)`` ``reps`` times under a trace and return the
    ``top`` event names by total duration: ``[(name, total_ms), ...]``.

    ``step`` should force its own completion (fetch a scalar) so device
    work lands inside the trace window.
    """
    with tempfile.TemporaryDirectory(prefix="kmers-prof-") as d:
        with trace(d):
            for _ in range(reps):
                step(*args)
        times = device_op_times(d)
    return sorted(times.items(), key=lambda kv: -kv[1])[:top]
