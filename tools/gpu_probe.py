"""Per-stage timings and trace shares of the counting path on one GPU.

Times, with ``block_until_ready``, and traces:

- the plain-JAX canonical front-end (classify, windows, canonical select,
  validity mask) at 2^20 and 2^26 bases, with its achieved bandwidth
  against the bytes it must move (1 B in per base, 8 B of (hi, lo) and
  1 B of mask out per window);
- one 2^20-base counting chunk, split into sort kernels and the rest,
  compaction of its table, and table merges at 2^20 and 2^22 rows;
- ``canonical_count_bytes`` end to end at 2^24 bases (device trace, by
  jitted module) and at 2^27 bases (wall time and a host profile).

Writes traces under ``chiprun_out/probe/`` and prints one JSON line per
measurement.  Needs a GPU: exits non-zero elsewhere.

    python tools/gpu_probe.py
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys
import time
import traceback
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

OUT = os.path.join("chiprun_out", "probe")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def emit(**rec):
    print(json.dumps(rec), flush=True)


def timeit(fn, *args, reps=5):
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), ts


def device_kernels(name, fn, *args, reps=3):
    """Per-call device time of each kernel and each jitted module."""
    from jax.profiler import ProfileData

    d = os.path.join(OUT, name)
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    with jax.profiler.trace(d):
        for _ in range(reps):
            jax.block_until_ready(fn(*args))
    wall = (time.perf_counter() - t0) / reps
    path = sorted(glob.glob(os.path.join(d, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    per, mods, sort_ms = {}, {}, 0.0
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                ms = ev.duration_ns / reps / 1e6
                t = per.setdefault(ev.name, [0.0, 0])
                t[0] += ms
                t[1] += 1
                stats = dict(ev.stats)
                mod = str(stats.get("hlo_module", stats.get("hlo_op", "?")))
                mods[mod] = mods.get(mod, 0.0) + ms
                if ev.name.startswith("sort"):
                    sort_ms += ms
    top = sorted(per.items(), key=lambda kv: -kv[1][0])
    total = sum(v[0] for _, v in top)
    emit(phase="trace", name=name, wall_ms_traced=wall * 1e3, device_ms=total,
         busy_share=total / 1e3 / wall, sort_ms=sort_ms,
         n_kernels=sum(v[1] for _, v in top) / reps,
         modules=sorted(((k, round(v, 4)) for k, v in mods.items()), key=lambda kv: -kv[1])[:20],
         top=[(k[:60], round(v[0], 4), v[1] // reps) for k, v in top[:15]])
    return total, top


# --------------------------------------------------------------------------


def phase(fn):
    try:
        fn()
    except Exception:  # keep probing the other stages
        emit(phase=fn.__name__, error=traceback.format_exc()[-3000:])


def main():
    if jax.devices()[0].platform != "gpu":
        sys.exit("gpu_probe.py needs a GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    emit(card=card, device_kind=jax.devices()[0].device_kind, jax=jax.__version__)
    os.makedirs(OUT, exist_ok=True)
    rng = np.random.default_rng(0)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    big = acgt[rng.integers(0, 4, 1 << 27)]
    big[rng.integers(0, 1 << 27, 1 << 12)] = ord("N")

    import importlib

    cc = importlib.import_module("kmers_tpu.pipelines.canonical_count")

    def front_end():
        for lg in (20, 26):
            x = jax.device_put(big[: 1 << lg])
            f = jax.jit(partial(cc._chunk_canonical, K=31))
            t, ts = timeit(f, x)
            need = (1 + 8 + 1) * (1 << lg)
            emit(phase="xla_fe", log2=lg, ms=t * 1e3, runs_ms=[r * 1e3 for r in ts],
                 achieved_TBps=need / t / 1e12, roofline_share=need / t / HBM_BYTES_PER_S)
            device_kernels(f"xla_fe_2^{lg}", f, x)

    def count_chunk():
        x = jax.device_put(big[: 1 << 20])
        f = partial(cc._chunk_count, K=31)
        t, ts = timeit(f, x, reps=10)
        emit(phase="chunk_count_2^20", ms=t * 1e3, runs_ms=[r * 1e3 for r in ts])
        device_kernels("chunk_count_2^20", f, x, reps=5)
        from kmers_tpu.ops.count import compact_counts, merge_compact_tables

        uh, ul, cnt = f(x)[:3]
        t, _ = timeit(compact_counts, uh, ul, cnt)
        emit(phase="compact_2^20", ms=t * 1e3)
        device_kernels("compact_2^20", compact_counts, uh, ul, cnt)
        a = compact_counts(uh, ul, cnt)
        for lg in (20, 22):
            ta = tuple(jnp.tile(v, 1 << (lg - 20)) for v in a)
            t, _ = timeit(merge_compact_tables, *ta, *ta)
            emit(phase=f"merge_2x2^{lg}", ms=t * 1e3)
            device_kernels(f"merge_2x2^{lg}", merge_compact_tables, *ta, *ta)

    def end_to_end():
        import cProfile
        import io
        import pstats

        cfg = cc.CountConfig(K=31)
        device_kernels("e2e_2^24", lambda: cc.canonical_count_bytes(big[: 1 << 24], cfg), reps=1)
        cc.canonical_count_bytes(big, cfg)  # compile + warm
        for _ in range(2):
            t0 = time.perf_counter()
            kmers, _ = cc.canonical_count_bytes(big, cfg)
            dt = time.perf_counter() - t0
            emit(phase="e2e_2^27", s=dt, bases_per_s=big.size / dt, distinct=int(kmers.size))
        prof = cProfile.Profile()
        prof.enable()
        cc.canonical_count_bytes(big, cfg)
        prof.disable()
        buf = io.StringIO()
        pstats.Stats(prof, stream=buf).sort_stats("tottime").print_stats(15)
        emit(phase="e2e_2^27_host_profile", top=buf.getvalue().splitlines()[:40])
        st = jax.devices()[0].memory_stats() or {}
        emit(phase="memory", peak_bytes_in_use=st.get("peak_bytes_in_use"),
             bytes_limit=st.get("bytes_limit"))

    for p in (front_end, count_chunk, end_to_end):
        phase(p)


if __name__ == "__main__":
    main()
