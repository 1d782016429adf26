"""Incremental canonical counting over unbounded inputs.

``canonical_count_bytes`` streams a single in-memory buffer;
:class:`StreamingCounter` exposes the same device-resident level-stack
accumulator as an *incremental* API: push record batches as they are
read, finalize once.  Combined with :func:`kmers_tpu.io.stream_fastx`
this counts files larger than host memory end-to-end — the
checkpoint/streaming obligation of SURVEY.md §5 ("real k-mer counting
exceeds HBM") without ever materializing the input.

Semantics: each ``update()`` call is a record batch — windows never span
two calls (callers pass whole records; batch boundaries behave like
record boundaries).  Within a call, records are joined with 'N'
separators (the ambiguity skip class), so results are bit-identical to
counting the concatenated input with ``canonical_count_records``.
"""

from __future__ import annotations

import numpy as np

from .canonical_count import (
    CountConfig,
    _as_byte_array,
    _chunk_count_checked,
    join_records_with_n,
)
from ..ops.count import _next_pow2, compact_counts, merge_compact_tables

__all__ = ["StreamingCounter", "count_fastx_stream"]


class StreamingCounter:
    """Device-resident canonical K-mer counter with incremental updates.

    >>> sc = StreamingCounter(CountConfig(K=31))
    >>> for seq, off in stream_fastx("reads.fq.gz"):
    ...     sc.update(seq, off)
    >>> kmers, counts = sc.finalize()

    Peak device memory is O(distinct * log(batches)) table rows plus one
    chunk of windows — independent of total input length.  K <= 31
    (single-register tables).
    """

    def __init__(self, config: CountConfig = CountConfig(), metrics=None):
        if config.K > 31:
            raise ValueError(
                "StreamingCounter supports K <= 31 (use "
                "canonical_count_bytes for multi-limb K)"
            )
        if not config.skip_ambiguous:
            raise ValueError("streaming counting requires skip_ambiguous=True")
        if config.resolved_chunk_size < config.K:
            raise ValueError("chunk_size must be >= K")
        self.config = config
        self.metrics = metrics
        from ..utils.levelstack import LevelStack

        def _merge(a, b):
            return merge_compact_tables(*a, *b)

        def _slice(out):
            mh, ml, mc, mnu = out
            cap = _next_pow2(max(int(mnu), 1))
            return (mh[:cap], ml[:cap], mc[:cap])

        self._stack = LevelStack(_merge, _slice)
        self._n_invalid = 0
        self._n_valid = 0  # Python int: unbounded window-conservation tally
        self._n_windows = 0
        self._bases = 0
        self._done = False
        if metrics is not None:
            metrics.start_batch()

    def update(self, seq_bytes, offsets=None):
        """Count one record batch.  ``offsets`` (optional int64 CSR
        record starts, as returned by the fastx readers) joins records
        with 'N' so windows never span records; without it the buffer is
        treated as a single record."""
        import jax.numpy as jnp

        if self._done:
            raise RuntimeError("finalize() already called")
        arr = _as_byte_array(seq_bytes)
        if offsets is not None:
            arr = join_records_with_n(arr, offsets)
        K = self.config.K
        L = arr.shape[0]
        if L < K:
            self._bases += L
            return
        self._bases += L
        self._n_windows += L - K + 1
        # stride = windows per chunk (no clamp: chunk_size >= K is
        # validated, so step >= 1 and chunks tile all window starts)
        step = self.config.resolved_chunk_size - (K - 1)
        for start in range(0, max(L - K + 1, 1), step):
            chunk = arr[start : start + self.config.resolved_chunk_size]
            # quantize the dispatch shape (pow2 buckets, 'N' padding) so
            # variable-length reader batches reuse a bounded set of
            # compiled executables instead of recompiling per length
            target = max(16384, _next_pow2(chunk.shape[0]))
            if chunk.shape[0] < target:
                chunk = np.concatenate(
                    [chunk, np.full(target - chunk.shape[0], ord("N"), np.uint8)]
                )
            # checked variant: the per-chunk valid-window tally feeds the
            # finalize() conservation guard, which catches both counting
            # bugs and int32 accumulator overflow on unbounded streams
            uh, ul, cnt, nu, n_inv, _n_amb, n_val, _n_cnt = (
                _chunk_count_checked(jnp.asarray(chunk), K)
            )
            # per-chunk scalar fetches: the streaming API is sync per
            # batch anyway (the reader is the bottleneck)
            self._n_invalid += int(n_inv)
            self._n_valid += int(n_val)
            uh, ul, cnt = compact_counts(uh, ul, cnt)
            cap = _next_pow2(max(int(nu), 1))
            self._stack.push((uh[:cap], ul[:cap], cnt[:cap]))

    @property
    def bases_seen(self) -> int:
        return self._bases

    def finalize(self):
        """Fold the accumulator and return sorted ``(kmers, counts)``.

        Raises :class:`EncodeError` if any invalid (non-IUPAC) byte was
        seen in any batch, and :class:`RuntimeError` if window
        conservation fails — every valid window must be counted exactly
        once, so a mismatch means the int32 accumulator overflowed (a
        single kmer exceeding 2^31 occurrences) or a kernel bug."""
        from ..alphabets import DNAAlphabet2, EncodeError

        self._done = True
        if self._n_invalid:
            raise EncodeError(DNAAlphabet2(), "<stream input>")
        if not len(self._stack):
            return np.zeros(0, np.uint64), np.zeros(0, np.int64)
        tbl = self._stack.fold()
        uh, ul, cnt = (np.asarray(x) for x in tbl)
        kmers = (uh.astype(np.uint64) << np.uint64(32)) | ul.astype(np.uint64)
        keep = cnt > 0
        kmers, counts = kmers[keep], cnt[keep].astype(np.int64)
        counted = int(counts.sum())
        if counted != self._n_valid:
            raise RuntimeError(
                f"window conservation violated: {self._n_valid} valid "
                f"windows seen but {counted} counted — int32 count "
                "accumulator overflow (a kmer with >= 2^31 occurrences) "
                "or a counting bug"
            )
        if self.metrics is not None:
            self.metrics.end_batch(
                bases_in=self._bases,
                windows_out=counted,
                windows_skipped=self._n_windows - counted,
                distinct_kmers=int(kmers.shape[0]),
            )
        return kmers, counts


def count_fastx_stream(
    path,
    config: CountConfig = CountConfig(),
    batch_bytes: int = 1 << 26,
    metrics=None,
):
    """Count canonical K-mers of a FASTA/FASTQ file without loading it:
    stream record batches through a :class:`StreamingCounter`.

    Bit-identical to ``canonical_count_records(*read_fastx(path))`` —
    tested — but with O(batch) host memory.
    """
    from ..io import stream_fastx

    sc = StreamingCounter(config, metrics=metrics)
    for seq, off in stream_fastx(path, batch_bytes=batch_bytes):
        sc.update(seq, off)
    return sc.finalize()
