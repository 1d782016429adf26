"""MinHash sketching of canonical k-mers.

Array-plane version of the reference's headline minhash workflow
(/root/reference/docs/src/minhash.md): the sketch is the ``s`` smallest
distinct FxHash values over the canonical K-mers of a sequence.  On
device, hashes are sorted and a static prefix is returned; the tiny
host-side dedup trims it to the sketch.  Sketches from different inputs
merge/compare with plain set ops (Mash-style Jaccard estimation).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..alphabets import EncodeError, DNAAlphabet2
from ..ops.count import SENTINEL
from ..ops.encode import classify_2bit
from ..ops.hashing import fx_hash_u64
from ..ops.windows import canonical_windows_from_codes, window_valid_mask

__all__ = [
    "minhash_sketch",
    "StreamingSketcher",
    "sketch_fastx_stream",
    "jaccard",
]


def _smallest_prefix(hh, hl, prefix: int):
    """Smallest-``prefix`` (hh, hl) pairs by hh, with a sound boundary.

    Two-stage selection: per-row ``top_k`` over a (R, ~8192) reshape, then
    a global ``top_k`` over the ~n/1024 survivors (its cost against one
    global ``top_k`` is not yet measured on the H100).  Returns
    ``(hh_sel, hl_sel, boundary)`` where every element with
    ``hh < boundary`` is guaranteed selected: stage 1 keeps all elements
    below each row's kpr-th smallest (>= min of that across rows =
    ``boundary2``), stage 2 is exact among survivors up to ``max(fh)``.
    The host-side exactness check (strict ``<`` on the hh word) therefore
    remains sound; rare misses fall back to the exact full-width run.
    """
    n = hh.shape[0]
    R = max(n // 8192, 1)
    kpr = 8
    if R * kpr < 2 * prefix:
        # small input: single exact stage
        _, idx = jax.lax.top_k(~hh, min(prefix, n))
        ch = jnp.take(hh, idx)
        cl = jnp.take(hl, idx)
        return ch, cl, jnp.max(ch)
    C = -(-n // R)
    pad = R * C - n
    sent = jnp.asarray(SENTINEL, jnp.uint32)
    if pad:
        hh = jnp.concatenate([hh, jnp.full(pad, sent, jnp.uint32)])
        hl = jnp.concatenate([hl, jnp.full(pad, sent, jnp.uint32)])
    hr = hh.reshape(R, C)
    lr = hl.reshape(R, C)
    _, idx = jax.lax.top_k(~hr, kpr)
    ch = jnp.take_along_axis(hr, idx, axis=1)
    cl = jnp.take_along_axis(lr, idx, axis=1)
    boundary2 = jnp.min(jnp.max(ch, axis=1))
    _, fidx = jax.lax.top_k(~ch.reshape(-1), prefix)
    fh = jnp.take(ch.reshape(-1), fidx)
    fl = jnp.take(cl.reshape(-1), fidx)
    return fh, fl, jnp.minimum(boundary2, jnp.max(fh))


@partial(jax.jit, static_argnames=("K", "prefix"))
def _sketch_chunk(bytes_u8, K: int, prefix: int):
    """Bottom-``prefix`` hashes by partial selection.

    ``top_k`` on the negated high hash word is O(n log k) — far cheaper
    than a full sort at sketch sizes.  The low words of the selected
    candidates are recovered with a k-sized gather; ties on the 32-bit
    boundary are resolved by the host-side dedup over the 4x-oversized
    prefix (widened further by the caller if pathological).
    """
    codes, certain, ambig = classify_2bit(bytes_u8)
    invalid = ~(certain | ambig)
    hi, lo = canonical_windows_from_codes(codes, K)
    valid = window_valid_mask(certain, K)
    hh, hl = fx_hash_u64(hi, lo)
    sent = jnp.asarray(SENTINEL, jnp.uint32)
    hh = jnp.where(valid, hh, sent)
    hl = jnp.where(valid, hl, sent)
    cand_hh, cand_hl, boundary = _smallest_prefix(hh, hl, prefix)
    shh, shl = jax.lax.sort((cand_hh, cand_hl), num_keys=2)
    return shh, shl, jnp.sum(invalid), jnp.sum(ambig), boundary


def _sketch_exact(arr, K: int, s: int, skip_ambiguous: bool):
    """Exact s-smallest-distinct canonical-kmer FxHashes of one byte
    buffer, as a sorted np.uint64 array of length <= s.

    Error contract (same as the counting pipelines, mirroring the
    reference's ASCII LUT classes /root/reference/src/iterators/common.jl:22-32):
    invalid bytes (0xff class) ALWAYS raise ``EncodeError``; ambiguous
    bytes (0xf0 class) raise only when ``skip_ambiguous`` is False."""
    n_windows = arr.size - K + 1
    def run(prefix):
        hh, hl, n_invalid, n_ambig, boundary = _sketch_chunk(
            jnp.asarray(arr), K, prefix
        )
        if int(n_invalid):
            raise EncodeError(DNAAlphabet2(), "<batch input>")
        if int(n_ambig) and not skip_ambiguous:
            raise EncodeError(DNAAlphabet2(), "<ambiguous base>")
        h = (np.asarray(hh).astype(np.uint64) << np.uint64(32)) | np.asarray(
            hl
        ).astype(np.uint64)
        h = np.unique(h)  # sorted + distinct
        h = h[h != np.uint64(0xFFFFFFFFFFFFFFFF)]
        return h, int(boundary)

    prefix = min(max(4 * s, 64), max(n_windows, 1))
    h, boundary = run(prefix)
    exact = (
        # enough distinct values, and the s-th is strictly inside the
        # selected hh range (no boundary tie could change the sketch)
        h.size >= s
        and (int(h[s - 1]) >> 32) < boundary
    ) or prefix >= n_windows
    if not exact:
        # duplication/boundary-tie: fall back to the exact full selection
        h, _ = run(n_windows)
    return h[:s]


def minhash_sketch(
    data,
    K: int = 16,
    s: int = 1000,
    skip_ambiguous: bool = True,
):
    """The ``s`` smallest distinct canonical-kmer FxHashes of ``data``.

    Returns a sorted np.uint64 array of length <= s.

    Invalid bytes (the LUT's 0xff error class) always raise
    ``EncodeError``; ambiguous IUPAC codes are skipped when
    ``skip_ambiguous`` (the default) and raise otherwise — identical to
    ``canonical_count`` and ``minimizer_select``.
    """
    if isinstance(data, str):
        data = data.encode("ascii")
    arr = np.frombuffer(bytes(data), dtype=np.uint8)
    if arr.size < K:
        return np.zeros(0, np.uint64)
    return _sketch_exact(arr, K, s, skip_ambiguous)


class StreamingSketcher:
    """Incremental MinHash: push record batches, finalize to the global
    sketch — inputs larger than HBM sketch chunk-by-chunk.

    MinHash sketches are mergeable: the s smallest distinct hashes of
    A ∪ B are the s smallest of sketch(A) ∪ sketch(B), so the running
    state is one sorted <= s array.  Each chunk's sketch is exact (the
    one-shot exactness-boundary check, falling back to full-width
    selection per chunk), so the merged sketch is bit-identical to the
    one-shot sketch of the concatenated input.  Mirrors the reference's
    streamed-FASTX minhash workflow (/root/reference/docs/src/minhash.md:17-41).

    >>> sk = StreamingSketcher(K=16, s=1000)
    >>> for seq, off in stream_fastx("reads.fq.gz"):
    ...     sk.update(seq, off)
    >>> sketch = sk.finalize()
    """

    def __init__(
        self,
        K: int = 16,
        s: int = 1000,
        chunk_size: int = 1 << 24,
        metrics=None,
    ):
        if chunk_size < K:
            raise ValueError("chunk_size must be >= K")
        self.K, self.s, self.chunk_size = K, s, chunk_size
        self._sketch = np.zeros(0, np.uint64)
        self._bases = 0
        self._windows = 0
        self._done = False
        self.metrics = metrics
        if metrics is not None:
            metrics.start_batch()

    def update(self, seq_bytes, offsets=None):
        """Sketch one record batch.  ``offsets`` (optional int64 CSR
        record starts from the fastx readers) joins records with 'N' so
        windows never span records."""
        from .canonical_count import _as_byte_array, join_records_with_n
        from ..ops.count import _next_pow2

        if self._done:
            raise RuntimeError("finalize() already called")
        arr = _as_byte_array(seq_bytes)
        K = self.K
        if offsets is not None:
            # per-record window tally (windows never span the 'N' joins);
            # ambiguous-base windows drop silently (invalid bytes still
            # raise), without the counting pipelines' conservation
            # bookkeeping
            lens = np.diff(np.asarray(offsets))
            self._windows += int(np.maximum(lens - K + 1, 0).sum())
            self._bases += int(lens.sum())
            arr = join_records_with_n(arr, offsets)
            L = arr.shape[0]
        else:
            L = arr.shape[0]
            self._bases += L
            self._windows += max(L - K + 1, 0)
        if L < K:
            return
        # K-1-byte overlap so windows spanning chunk boundaries appear in
        # exactly one chunk's window set (duplicates would be harmless —
        # sketches are sets — but the overlap keeps coverage exact)
        step = self.chunk_size - (K - 1)
        for start in range(0, max(L - K + 1, 1), step):
            chunk = arr[start : start + self.chunk_size]
            # quantize dispatch shapes (pow2, 'N' pad) to bound the set
            # of compiled executables; 'N' windows drop as invalid
            target = max(16384, _next_pow2(chunk.shape[0]))
            if chunk.shape[0] < target:
                chunk = np.concatenate(
                    [chunk, np.full(target - chunk.shape[0], ord("N"), np.uint8)]
                )
            h = _sketch_exact(chunk, K, self.s, True)
            self._sketch = np.unique(np.concatenate([self._sketch, h]))[
                : self.s
            ]

    @property
    def bases_seen(self) -> int:
        return self._bases

    def finalize(self) -> np.ndarray:
        self._done = True
        if self.metrics is not None:
            self.metrics.end_batch(
                bases_in=self._bases,
                windows_out=self._windows,
                windows_skipped=0,
                distinct_kmers=int(self._sketch.size),
            )
        return self._sketch


def sketch_fastx_stream(
    path,
    K: int = 16,
    s: int = 1000,
    batch_bytes: int = 1 << 26,
    chunk_size: int = 1 << 24,
):
    """MinHash-sketch a FASTA/FASTQ file without loading it: stream
    record batches through a :class:`StreamingSketcher`."""
    from ..io import stream_fastx

    sk = StreamingSketcher(K=K, s=s, chunk_size=chunk_size)
    for seq, off in stream_fastx(path, batch_bytes=batch_bytes):
        sk.update(seq, off)
    return sk.finalize()


def jaccard(sketch_a: np.ndarray, sketch_b: np.ndarray, s: int | None = None):
    """Mash-style Jaccard estimate from two minhash sketches."""
    if s is None:
        s = min(sketch_a.size, sketch_b.size)
    if s == 0:
        return 0.0
    merged = np.union1d(sketch_a, sketch_b)[:s]
    inter = np.intersect1d(sketch_a, sketch_b, assume_unique=True)
    return float(np.isin(merged, inter).sum()) / float(merged.size)
