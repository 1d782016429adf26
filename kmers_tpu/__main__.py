"""Command-line front-end: `python -m kmers_tpu <command>`.

Commands:
  count    — canonical K-mer counting of a FASTA/FASTQ file
  sketch   — MinHash sketch of a FASTA/FASTQ file
  sixframe — six-frame amino-acid K-mer counting (sharded over all devices)
  bench    — the headline throughput benchmark (same as bench.py)
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _load(path: str):
    from .io import read_fastx

    return read_fastx(path)


def cmd_count(args):
    import contextlib

    from .pipelines.canonical_count import CountConfig, canonical_count_records
    from .utils import Metrics, checked, save_count_table

    m = Metrics() if args.metrics else None
    ctx = checked() if args.checked else contextlib.nullcontext()
    with ctx:
        if args.stream:
            # never loads the file: record batches stream through the
            # device-resident accumulator (pipelines/streaming.py, which
            # always enforces window conservation; --checked additionally
            # validates the unsafe scalar surface)
            from .pipelines import count_fastx_stream

            kmers, counts = count_fastx_stream(
                args.input, CountConfig(K=args.k), metrics=m
            )
        else:
            seq, off = _load(args.input)
            kmers, counts = canonical_count_records(
                seq, off, CountConfig(K=args.k), metrics=m
            )
    if m is not None:
        print(m.dump(), file=sys.stderr)
    if args.output:
        # record input provenance for deterministic reruns (SURVEY §5)
        save_count_table(
            args.output, kmers, counts, K=args.k, inputs=[args.input]
        )
        print(
            json.dumps(
                {"distinct": int(kmers.size), "total": int(counts.sum()),
                 "output": args.output}
            )
        )
    else:
        top = np.argsort(counts)[::-1][: args.top]
        for i in top:
            from .kmer import Kmer
            from .alphabets import DNAAlphabet2

            k = Kmer.unsafe(DNAAlphabet2(), args.k, int(kmers[i]))
            print(f"{k}\t{counts[i]}")
        print(
            json.dumps({"distinct": int(kmers.size), "total": int(counts.sum())}),
            file=sys.stderr,
        )


def cmd_merge(args):
    from .pipelines.tables import merge_counts, multiplicity_spectrum
    from .utils import load_count_table, save_count_table

    kmers, counts, K = load_count_table(args.inputs[0])
    for d in args.inputs[1:]:
        k2, c2, K2 = load_count_table(d)
        if K2 != K:
            raise SystemExit(f"K mismatch: {d} has K={K2}, expected {K}")
        kmers, counts = merge_counts(kmers, counts, k2, c2)
    save_count_table(args.output, kmers, counts, K=K)
    spec = multiplicity_spectrum(counts, max_multiplicity=8)
    print(
        json.dumps(
            {
                "distinct": int(kmers.size),
                "total": int(counts.sum()),
                "spectrum_1_to_8plus": spec[1:].tolist(),
                "output": args.output,
            }
        )
    )


def cmd_verify(args):
    """Deterministic-rerun check: re-hash the checkpoint's recorded
    inputs and compare (SURVEY §5 failure model — a rerun on verified
    inputs reproduces the table bit-exactly)."""
    from .utils import input_manifest_entry, load_count_table

    kmers, counts, K, manifest = load_count_table(
        args.checkpoint, return_manifest=True
    )
    entries = manifest.get("inputs", [])
    if not entries:
        raise SystemExit("checkpoint records no input manifest")
    bad = []
    for want in entries:
        try:
            got = input_manifest_entry(want["path"])
        except OSError as e:
            bad.append({"path": want["path"], "error": str(e)})
            continue
        if got["sha256"] != want["sha256"] or got["bytes"] != want["bytes"]:
            bad.append({"path": want["path"], "expected": want, "found": got})
    print(
        json.dumps(
            {
                "checkpoint": args.checkpoint,
                "K": K,
                "distinct": int(kmers.size),
                "inputs_checked": len(entries),
                "inputs_changed": bad,
                "ok": not bad,
            }
        )
    )
    if bad:
        raise SystemExit(1)


def cmd_sketch(args):
    if getattr(args, "stream", False):
        # never loads the file: chunked mergeable sketching
        # (pipelines/minhash.py StreamingSketcher)
        from .pipelines.minhash import sketch_fastx_stream

        sk = sketch_fastx_stream(args.input, K=args.k, s=args.size)
    else:
        from .pipelines.canonical_count import join_records_with_n
        from .pipelines.minhash import minhash_sketch

        seq, off = _load(args.input)
        sk = minhash_sketch(
            join_records_with_n(seq, off).tobytes(), K=args.k, s=args.size
        )
    # header records the sketch parameters so `dist` can validate -k
    print(f"#kmers_tpu sketch k={args.k} s={args.size}")
    for h in sk:
        print(f"{int(h):016x}")


def cmd_dist(args):
    """Mash-style distance between sketches: each input is either a
    sketch file written by ``sketch`` (header line ``#kmers_tpu sketch
    k=.. s=..`` + one 16-hex-digit hash per line) or a FASTA/FASTQ file
    to sketch on the fly.  A sketch-file header with a k different from
    ``-k`` is an error (Mash distance divides by k); headerless files
    are accepted with a warning.  Hashes are deduplicated on load (a
    sketch is a set; duplicates would corrupt the jaccard estimate)."""
    import sys

    import numpy as np

    from .pipelines.canonical_count import join_records_with_n
    from .pipelines.minhash import jaccard, minhash_sketch

    def load_sketch(path):
        with open(path, "rb") as f:
            head = f.read(1)
        if head in (b">", b"@"):
            seq, off = _load(path)
            return minhash_sketch(
                join_records_with_n(seq, off).tobytes(), K=args.k,
                s=args.size,
            )
        hashes, saw_header = [], False
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                if line.startswith("#"):
                    if line.startswith("#kmers_tpu sketch"):
                        saw_header = True
                        meta = dict(
                            kv.split("=") for kv in line.split()[2:] if "=" in kv
                        )
                        k_file = int(meta.get("k", args.k))
                        if k_file != args.k:
                            raise SystemExit(
                                f"{path}: sketch was built with k={k_file}, "
                                f"but -k is {args.k}"
                            )
                    continue
                hashes.append(int(line, 16))
        if not saw_header:
            print(
                f"warning: {path} has no sketch header; assuming k={args.k}",
                file=sys.stderr,
            )
        return np.unique(np.array(hashes, dtype=np.uint64))

    a = load_sketch(args.a)
    b = load_sketch(args.b)
    j = jaccard(a, b)
    import math

    # Mash distance (Ondov et al. 2016): d = -ln(2j/(1+j)) / k
    d = 1.0 if j <= 0 else min(-math.log(2 * j / (1 + j)) / args.k, 1.0)
    print(json.dumps({"jaccard": round(j, 6), "mash_distance": round(d, 6)}))


def cmd_sixframe(args):
    from .parallel import SixFrameCountConfig, sharded_sixframe_aa_count
    from .pipelines.canonical_count import join_records_with_n

    seq, off = _load(args.input)
    kmers, counts = sharded_sixframe_aa_count(
        join_records_with_n(seq, off).tobytes(), SixFrameCountConfig(K=args.k)
    )
    print(json.dumps({"distinct": int(kmers.size), "total": int(counts.sum())}))


def cmd_bench(args):
    # self-contained (works from any cwd / installed package)
    import time

    import jax

    from .pipelines.canonical_count import _chunk_count

    K, L = 31, 1 << 26
    rng = np.random.default_rng(0)
    data = jax.device_put(
        np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, L)]
    )
    jax.block_until_ready(_chunk_count(data, K))
    t0 = time.perf_counter()
    for _ in range(3):
        jax.block_until_ready(_chunk_count(data, K))
    dt = (time.perf_counter() - t0) / 3
    dev = jax.devices()[0]
    print(
        json.dumps(
            {
                "metric": "canonical_31mer_count_bases_per_sec_per_chip",
                "value": round(L / dt),
                "unit": "bases/sec",
                "vs_baseline": round(L / dt / 5.0e7, 3),
                "device": {"platform": dev.platform, "kind": dev.device_kind},
            }
        )
    )


def main(argv=None):
    from .utils.compile_cache import use_compile_cache

    use_compile_cache()
    p = argparse.ArgumentParser(prog="kmers_tpu")
    sub = p.add_subparsers(dest="command", required=True)

    c = sub.add_parser("count", help="canonical K-mer counting")
    c.add_argument("input")
    c.add_argument("-k", type=int, default=31)
    c.add_argument("-o", "--output", help="count-table checkpoint directory")
    c.add_argument("--top", type=int, default=10, help="print N most frequent")
    c.add_argument(
        "--metrics", action="store_true",
        help="print per-batch stats (bases in, windows skipped, ...) to stderr",
    )
    c.add_argument(
        "--checked", action="store_true",
        help="enable checked mode (validates unsafe preconditions and "
        "count conservation; see docs/debugging.md)",
    )
    c.add_argument(
        "--stream", action="store_true",
        help="stream the file in record batches instead of loading it "
        "(files larger than host memory; K <= 31)",
    )
    c.set_defaults(fn=cmd_count)

    vr = sub.add_parser(
        "verify",
        help="check a checkpoint's recorded inputs (size + sha256) so a "
        "rerun is known to see identical data",
    )
    vr.add_argument("checkpoint", help="count-table checkpoint directory")
    vr.set_defaults(fn=cmd_verify)

    m = sub.add_parser(
        "merge", help="merge count-table checkpoints (counts sum)"
    )
    m.add_argument("inputs", nargs="+", help="checkpoint directories")
    m.add_argument("-o", "--output", required=True)
    m.set_defaults(fn=cmd_merge)

    s = sub.add_parser("sketch", help="MinHash sketch")
    s.add_argument("input")
    s.add_argument("-k", type=int, default=16)
    s.add_argument("-s", "--size", type=int, default=1000)
    s.add_argument(
        "--stream", action="store_true",
        help="stream the file in record batches instead of loading it "
        "(files larger than host memory)",
    )
    s.set_defaults(fn=cmd_sketch)

    d = sub.add_parser(
        "dist", help="Mash-style distance between two sketches/FASTAs"
    )
    d.add_argument("a")
    d.add_argument("b")
    d.add_argument("-k", type=int, default=16)
    d.add_argument("-s", "--size", type=int, default=1000)
    d.set_defaults(fn=cmd_dist)

    f = sub.add_parser("sixframe", help="six-frame AA kmer counting")
    f.add_argument("input")
    f.add_argument("-k", type=int, default=7)
    f.set_defaults(fn=cmd_sixframe)

    b = sub.add_parser("bench", help="headline throughput benchmark")
    b.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
