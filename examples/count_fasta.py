"""Example: canonical k-mer counting of a FASTA file, end to end.

    python examples/count_fasta.py genome.fa -k 31

Equivalent reference workflow: iterating CanonicalKmers and updating a
dict (/root/reference/docs/src/composition.md) — here the whole pipeline
(parse -> classify -> pack -> window -> canonicalize -> count) runs as
batched device programs with the table device-resident until the final fetch.
"""

import argparse
import sys

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("fasta")
    p.add_argument("-k", type=int, default=31)
    p.add_argument("--top", type=int, default=10)
    args = p.parse_args()

    from kmers_tpu.io import read_fastx
    from kmers_tpu.pipelines import canonical_count_records, CountConfig, counts_lookup
    from kmers_tpu.utils import Metrics

    metrics = Metrics()
    metrics.start_batch()
    seq, offsets = read_fastx(args.fasta)
    kmers, counts = canonical_count_records(seq, offsets, CountConfig(K=args.k))
    metrics.end_batch(
        bases_in=int(seq.size),
        windows_out=int(counts.sum()),
        distinct_kmers=int(kmers.size),
    )

    from kmers_tpu import DNAAlphabet2, Kmer

    order = np.argsort(counts)[::-1]
    print(f"{kmers.size} distinct canonical {args.k}-mers, "
          f"{counts.sum()} total windows")
    for i in order[: args.top]:
        k = Kmer.unsafe(DNAAlphabet2(), args.k, int(kmers[i]))
        print(f"  {k}\t{counts[i]}")
    print(metrics.dump(), file=sys.stderr)


if __name__ == "__main__":
    main()
