"""Smoke test of kmers_tpu on one NVIDIA GPU (or four, with ``--multi``).

Drives the system's main paths once, through the entry points a user
calls, and checks every result for exact equality against a plain
reference (every value on these paths is an integer):

a. a genome-scale canonical 31-mer count — a seeded multi-record FASTA
   of 2^27 bases (a Drosophila-sized assembly: chromosome-length records,
   scattered N runs, soft-masked lowercase runs) through
   ``canonical_count_records``, ``python -m kmers_tpu count -o`` and
   ``count --stream`` (both in this process), against a numpy reference
   that shares no code with ``kmers_tpu.ops``;
b. a K=47 multi-limb count of 2^24 bases against the two-limb numpy
   reference;
c. minhash (K=16, s=1000), minimizers (K=15, W=10), spaced extraction
   (step 7), N-masked extraction and six-frame amino-acid counting
   (K=7, one-device mesh) against the scalar oracle plane.

``--multi`` runs only the four-card phase: sharded K=31 (the phase-a
genome), six-frame K=7 and multi-limb K=47 (2^22 bases each) counts on
a 4-device mesh against one card.

Prints one JSON line per phase, the card's name and power limit, and as
its last line ``{"ok": true, "device": {...}}``.  Exits non-zero, and
prints no such line, when a phase fails or JAX finds no GPU.

    python chip_smoke.py            # one card
    python chip_smoke.py --multi    # four cards
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

GENOME_BASES = 1 << 27
GENOME_RECORDS = 6
K47_BASES = 1 << 24
ORACLE_BASES = 1 << 17
SIXFRAME_ORACLE_BASES = 1 << 15
MULTI_SMALL_BASES = 1 << 22


class SmokeFailure(Exception):
    """A result differed from its reference."""


def emit(**rec):
    print(json.dumps(rec), flush=True)


def check(ok: bool, what: str):
    if not ok:
        raise SmokeFailure(what)


# ---------------------------------------------------------------------------
# inputs


def make_genome(n_bases: int, n_records: int, seed: int):
    """Seeded assembly-like sequence: ``(seq uint8, record offsets int64)``.

    Uniform random A/C/G/T with about one N run (assembly gap, 1..20 kb)
    and one lowercase (soft-masked) run per Mbp, cut into ``n_records``
    records of random lengths.
    """
    rng = np.random.default_rng(seed)
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n_bases, dtype=np.uint8)]
    n_runs = max(n_bases >> 20, 2)
    for start, length in zip(
        rng.integers(0, n_bases, n_runs), rng.integers(1, 20_000, n_runs)
    ):
        seq[start : start + length] = ord("N")
    for start, length in zip(
        rng.integers(0, n_bases, n_runs), rng.integers(1, 50_000, n_runs)
    ):
        seq[start : start + length] |= 0x20  # lowercase; 'N' -> 'n'
    cuts = np.sort(rng.choice(np.arange(1, n_bases), n_records - 1, replace=False))
    offsets = np.concatenate([[0], cuts, [n_bases]]).astype(np.int64)
    return seq, offsets


def write_fasta(path: str, seq: np.ndarray, offsets: np.ndarray, width: int = 80):
    with open(path, "wb") as f:
        for i in range(offsets.size - 1):
            r = seq[offsets[i] : offsets[i + 1]]
            f.write(b">chr%d\n" % (i + 1))
            n_full = r.size // width
            body = np.empty((n_full, width + 1), np.uint8)
            body[:, :width] = r[: n_full * width].reshape(n_full, width)
            body[:, width] = ord("\n")
            f.write(body.tobytes())
            if r.size % width:
                f.write(r[n_full * width :].tobytes() + b"\n")


def joined(seq: np.ndarray, offsets: np.ndarray) -> bytes:
    """Records joined by single 'N's: no window spans two records."""
    parts = []
    for i in range(offsets.size - 1):
        parts.append(seq[offsets[i] : offsets[i + 1]].tobytes())
    return b"N".join(parts)


# ---------------------------------------------------------------------------
# plain numpy reference (independent of kmers_tpu.ops)

_CODE = np.full(256, 4, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _CODE[_c] = _CODE[_c | 0x20] = _i


def _canonical_windows(rec: np.ndarray, K: int):
    """Canonical registers ``(hi, lo)`` (uint64; the register's bits above
    and below bit 64) of every window of one record that holds no base
    outside ACGT (either case).  ``hi`` is None for K <= 32."""
    codes = _CODE[rec]
    n = codes.size - K + 1
    if n <= 0:
        z = np.zeros(0, np.uint64)
        return (z if K > 32 else None), z
    wide = K > 32
    fl = np.zeros(n, np.uint64)
    rl = np.zeros(n, np.uint64)
    fh = np.zeros(n, np.uint64) if wide else None
    rh = np.zeros(n, np.uint64) if wide else None
    for k in range(K):
        c = (codes[k : k + n] & 3).astype(np.uint64)
        if wide:
            fh <<= np.uint64(2)
            fh |= fl >> np.uint64(62)
        fl <<= np.uint64(2)
        fl |= c
        # reverse complement: base k, complemented, lands at bits 2k
        t = np.uint64(3) - c
        if 2 * k < 64:
            t <<= np.uint64(2 * k)
            rl |= t
        else:
            t <<= np.uint64(2 * k - 64)
            rh |= t
    bad = np.concatenate([[0], np.cumsum(codes > 3, dtype=np.int64)])
    valid = bad[K:] == bad[:n]
    if not wide:
        return None, np.minimum(fl, rl)[valid]
    rc_first = (rh < fh) | ((rh == fh) & (rl < fl))
    return (
        np.where(rc_first, rh, fh)[valid],
        np.where(rc_first, rl, fl)[valid],
    )


def reference_counts(seq: np.ndarray, offsets: np.ndarray, K: int):
    """Canonical K-mer counts of a record batch, K <= 63.

    Returns ``(kmers uint64, counts int64)`` sorted for K <= 32, and
    ``(hi uint64, lo uint64, counts int64)`` sorted lexicographically by
    (hi, lo) for K > 32.
    """
    his, los = [], []
    for i in range(offsets.size - 1):
        hi, lo = _canonical_windows(seq[offsets[i] : offsets[i + 1]], K)
        his.append(hi)
        los.append(lo)
    lo = np.concatenate(los)
    if K <= 32:
        kmers, counts = np.unique(lo, return_counts=True)
        return kmers, counts.astype(np.int64)
    hi = np.concatenate(his)
    order = np.lexsort((lo, hi))
    hi, lo = hi[order], lo[order]
    first = np.ones(hi.size, bool)
    first[1:] = (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])
    starts = np.flatnonzero(first)
    counts = np.diff(np.append(starts, hi.size)).astype(np.int64)
    return hi[starts], lo[starts], counts


def split_wide(kmers) -> tuple[np.ndarray, np.ndarray]:
    """Python-int registers (the K > 31 table form) as (hi, lo) uint64."""
    mask = (1 << 64) - 1
    n = len(kmers)
    hi = np.fromiter((int(k) >> 64 for k in kmers), np.uint64, n)
    lo = np.fromiter((int(k) & mask for k in kmers), np.uint64, n)
    return hi, lo


def same_table(got, want) -> bool:
    return all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# phases


def phase_genome(n_bases: int = GENOME_BASES, n_records: int = GENOME_RECORDS,
                 seed: int = 1, tmpdir: str | None = None):
    """Phase a: K=31 through the library, the CLI and the streamed CLI."""
    from kmers_tpu.__main__ import main as cli
    from kmers_tpu.pipelines import CountConfig, canonical_count_records
    from kmers_tpu.utils import load_count_table

    t0 = time.perf_counter()
    seq, offsets = make_genome(n_bases, n_records, seed)
    want = reference_counts(seq, offsets, 31)
    emit(phase="a.reference", bases=n_bases, records=n_records,
         distinct=int(want[0].size), total=int(want[1].sum()),
         s=time.perf_counter() - t0)

    cfg = CountConfig(K=31)
    t0 = time.perf_counter()
    got = canonical_count_records(seq, offsets, cfg)  # compiles
    cold = time.perf_counter() - t0
    check(same_table(got, want), "canonical_count_records differs from the reference")
    t0 = time.perf_counter()
    got = canonical_count_records(seq, offsets, cfg)
    warm = time.perf_counter() - t0
    check(same_table(got, want), "canonical_count_records (warm) differs")
    emit(phase="a.canonical_count_records", ok=True, K=31, bases=n_bases,
         distinct=int(got[0].size), cold_s=cold, warm_s=warm,
         warm_bases_per_s=n_bases / warm)
    del got

    with tempfile.TemporaryDirectory(dir=tmpdir) as d:
        fasta = os.path.join(d, "genome.fa")
        write_fasta(fasta, seq, offsets)
        for name, extra in (("count", []), ("count --stream", ["--stream"])):
            out = os.path.join(d, name.replace(" ", "").replace("--", "_"))
            t0 = time.perf_counter()
            cli(["count", fasta, "-k", "31", "-o", out, *extra])
            dt = time.perf_counter() - t0
            kmers, counts, K = load_count_table(out)
            check(K == 31 and same_table((kmers, counts), want),
                  f"`kmers_tpu {name} -o` differs from the reference")
            emit(phase=f"a.cli {name}", ok=True, distinct=int(kmers.size), s=dt)
    return seq, offsets


def phase_k47(n_bases: int = K47_BASES, seed: int = 2):
    """Phase b: K=47 multi-limb counting against the two-limb reference."""
    from kmers_tpu.pipelines import CountConfig, canonical_count_records

    seq, offsets = make_genome(n_bases, 3, seed)
    want = reference_counts(seq, offsets, 47)
    t0 = time.perf_counter()
    kmers, counts = canonical_count_records(seq, offsets, CountConfig(K=47))
    dt = time.perf_counter() - t0
    check(same_table((*split_wide(kmers), counts), want),
          "K=47 count differs from the two-limb reference")
    emit(phase="b.k47", ok=True, bases=n_bases, distinct=int(counts.size), s=dt)


def _acgt(rng, n: int) -> str:
    return np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].tobytes().decode()


def phase_pipelines(n: int = ORACLE_BASES, n_six: int = SIXFRAME_ORACLE_BASES,
                    seed: int = 3):
    """Phase c: the other pipelines against the scalar oracle plane."""
    import kmers_tpu as kt
    from kmers_tpu.parallel import SixFrameCountConfig, data_mesh, sharded_sixframe_aa_count
    from kmers_tpu.pipelines import extract_kmers, minhash_sketch, minimizer_select, spaced_kmers

    rng = np.random.default_rng(seed)
    s = _acgt(rng, n)
    gappy = bytearray(s.encode())
    for start in rng.integers(0, n, max(n >> 10, 1)):
        end = min(int(start) + int(rng.integers(1, 40)), n)
        gappy[start:end] = b"N" * (end - start)
    gappy = gappy.decode()

    t0 = time.perf_counter()
    got = minhash_sketch(s, K=16, s=1000)
    want = sorted({kt.fx_hash(k) for k in kt.CanonicalDNAMers(16, s)})[:1000]
    check(got.tolist() == want, "minhash_sketch differs from the oracle")
    emit(phase="c.minhash", ok=True, K=16, s=1000, bases=n, t=time.perf_counter() - t0)

    t0 = time.perf_counter()
    K, W = 15, 10
    vals, pos = minimizer_select(s, K=K, W=W)
    ks = [k.canonical() for k in kt.FwDNAMers(K, s)]
    hs = np.array([kt.fx_hash(k) for k in ks], dtype=np.uint64)
    want_pos = []
    for j in range(len(ks) - W + 1):
        p = j + int(np.argmin(hs[j : j + W]))
        if not want_pos or want_pos[-1] != p:
            want_pos.append(p)
    check(pos.tolist() == want_pos and vals.tolist() == [ks[p].value for p in want_pos],
          "minimizer_select differs from the oracle")
    emit(phase="c.minimizers", ok=True, K=K, W=W, bases=n, t=time.perf_counter() - t0)

    t0 = time.perf_counter()
    got = spaced_kmers(s, K=31, J=7)
    want = [k.value for k in kt.SpacedDNAMers(31, 7, s)]
    check(got.tolist() == want, "spaced_kmers differs from the oracle")
    emit(phase="c.spaced", ok=True, K=31, step=7, bases=n, t=time.perf_counter() - t0)

    t0 = time.perf_counter()
    vals, pos = extract_kmers(gappy, K=15, skip_ambiguous=True)
    want = [(i, k.value) for k, i in kt.UnambiguousDNAMers(15, gappy)]
    check(list(zip(pos.tolist(), vals.tolist())) == want,
          "N-masked extract_kmers differs from the oracle")
    emit(phase="c.extract_nmasked", ok=True, K=15, bases=n, t=time.perf_counter() - t0)

    t0 = time.perf_counter()
    s6 = gappy[:n_six]
    kmers, counts = sharded_sixframe_aa_count(s6, SixFrameCountConfig(K=7), data_mesh(1))
    want = sixframe_oracle(s6, 7)
    check(dict(zip(map(int, kmers), map(int, counts))) == want,
          "six-frame count differs from the oracle")
    emit(phase="c.sixframe", ok=True, K=7, bases=n_six, distinct=len(want),
         t=time.perf_counter() - t0)


def sixframe_oracle(s: str, K: int) -> dict:
    """Amino-acid K-mer counts over the six reading frames (scalar plane)."""
    import kmers_tpu as kt

    counts: dict = {}
    comp = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N"}
    for strand in (s, "".join(comp[c] for c in reversed(s))):
        for f in range(3):
            sub = strand[f:]
            for j in range(len(sub) // 3 - K + 1):
                window = sub[3 * j : 3 * (j + K)]
                if "N" not in window:
                    v = kt.DNAKmer(window).translate().value
                    counts[v] = counts.get(v, 0) + 1
    return counts


def phase_multi(n_bases: int = GENOME_BASES, n_six: int = MULTI_SMALL_BASES,
                n47: int = MULTI_SMALL_BASES, n_dev: int = 4):
    """Phase d: sharded counts on ``n_dev`` devices against one device."""
    from kmers_tpu.parallel import (
        ShardedCountConfig,
        SixFrameCountConfig,
        data_mesh,
        sharded_canonical_count,
        sharded_canonical_count_mw,
        sharded_sixframe_aa_count,
    )
    from kmers_tpu.pipelines import CountConfig, canonical_count_bytes

    mesh = data_mesh(n_dev)
    seq, offsets = make_genome(n_bases, GENOME_RECORDS, 1)
    data = joined(seq, offsets)
    t0 = time.perf_counter()
    one = canonical_count_bytes(data, CountConfig(K=31))
    t1 = time.perf_counter()
    many = sharded_canonical_count(data, ShardedCountConfig(K=31), mesh)
    t2 = time.perf_counter()
    check(same_table(many, one), f"K=31 on {n_dev} devices differs from one device")
    emit(phase="d.sharded_k31", ok=True, devices=n_dev, bases=n_bases,
         distinct=int(one[0].size), one_device_s=t1 - t0, sharded_s=t2 - t1)
    del one, many

    s6 = joined(*make_genome(n_six, 3, 4))
    cfg = SixFrameCountConfig(K=7)
    t0 = time.perf_counter()
    one = sharded_sixframe_aa_count(s6, cfg, data_mesh(1))
    t1 = time.perf_counter()
    many = sharded_sixframe_aa_count(s6, cfg, mesh)
    t2 = time.perf_counter()
    check(same_table(many, one), f"six-frame K=7 on {n_dev} devices differs from one device")
    emit(phase="d.sixframe_k7", ok=True, devices=n_dev, bases=n_six,
         distinct=int(one[0].size), one_device_s=t1 - t0, sharded_s=t2 - t1)

    s47 = joined(*make_genome(n47, 3, 2))
    t0 = time.perf_counter()
    one = canonical_count_bytes(s47, CountConfig(K=47))
    t1 = time.perf_counter()
    many = sharded_canonical_count_mw(s47, K=47, mesh=mesh)
    t2 = time.perf_counter()
    check(same_table((*split_wide(many[0]), many[1]), (*split_wide(one[0]), one[1])),
          f"K=47 on {n_dev} devices differs from one device")
    emit(phase="d.sharded_k47", ok=True, devices=n_dev, bases=n47,
         distinct=int(one[1].size), one_device_s=t1 - t0, sharded_s=t2 - t1)


# ---------------------------------------------------------------------------


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card phase (needs 4 GPUs)")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(HERE, "kmers_tpu")):
        sys.exit("chip_smoke.py runs from a checkout of the repository")
    sys.path.insert(0, HERE)
    from kmers_tpu.utils.compile_cache import use_compile_cache

    cache_dir = use_compile_cache()
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.exit(f"chip_smoke.py needs an NVIDIA GPU; JAX found {devices[0].platform}")
    need = 4 if args.multi else 1
    if len(devices) < need:
        sys.exit(f"chip_smoke.py needs {need} GPUs; JAX found {len(devices)}")

    compile_s = [0.0]
    cache = {"hits": 0, "misses": 0}

    def on_duration(event, duration, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            compile_s[0] += duration

    def on_event(event, **_):
        if event == "/jax/compilation_cache/cache_hits":
            cache["hits"] += 1
        elif event == "/jax/compilation_cache/cache_misses":
            cache["misses"] += 1

    jax.monitoring.register_event_duration_secs_listener(on_duration)
    jax.monitoring.register_event_listener(on_event)

    from kmers_tpu.io import native_available

    print(card(), flush=True)
    emit(phase="setup", jax=jax.__version__, device_kind=devices[0].device_kind,
         devices=len(devices), native_fastx=native_available(),
         compile_cache=cache_dir)
    t0 = time.perf_counter()
    if args.multi:
        phase_multi(n_dev=need)
    else:
        phase_genome()
        phase_k47()
        phase_pipelines()
    emit(phase="done", s=time.perf_counter() - t0, backend_compile_s=compile_s[0],
         cache_hits=cache["hits"], cache_misses=cache["misses"])
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
