"""Extraction pipelines: every-kmer, spaced, and minimizer selection.

Batched, host-facing wrappers over the window engine for BASELINE.json
configs 1 and 3: plain 31-mer extraction, strided (spaced) sampling, and
(W, K)-minimizer selection over read batches.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..alphabets import EncodeError, DNAAlphabet2
from ..ops import u64 as u64ops
from ..ops.encode import classify_2bit
from ..ops.minimizer import minimizers as _minimizers
from ..ops.windows import (
    canonical_windows_from_codes,
    window_valid_mask,
    windows_from_codes,
)

__all__ = ["extract_kmers", "spaced_kmers", "minimizer_select", "syncmer_select"]


def _prep(data):
    if isinstance(data, str):
        data = data.encode("ascii")
    return np.frombuffer(bytes(data), dtype=np.uint8)


@partial(jax.jit, static_argnames=("K", "canonical"))
def _extract(bytes_u8, K: int, canonical: bool):
    codes, certain, ambig = classify_2bit(bytes_u8)
    invalid = ~(certain | ambig)
    if canonical:
        hi, lo = canonical_windows_from_codes(codes, K)
    else:
        hi, lo = windows_from_codes(codes, K)
    valid = window_valid_mask(certain, K)
    return hi, lo, valid, jnp.sum(invalid), jnp.sum(ambig)


def extract_kmers(data, K: int = 31, canonical: bool = False, skip_ambiguous: bool = True):
    """All K-mers of an ASCII buffer as (values uint64, positions int64).

    ``FwKmers`` semantics when ``skip_ambiguous=False`` (any non-ACGT
    raises), ``UnambiguousKmers`` semantics otherwise (ambiguous windows
    dropped, positions reported).
    """
    arr = _prep(data)
    if arr.size < K:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    hi, lo, valid, n_inv, n_amb = _extract(jnp.asarray(arr), K, canonical)
    if int(n_inv):
        raise EncodeError(DNAAlphabet2(), "<batch input>")
    if int(n_amb) and not skip_ambiguous:
        raise EncodeError(DNAAlphabet2(), "<ambiguous base>")
    vals = u64ops.to_numpy((hi, lo))
    mask = np.asarray(valid)
    return vals[mask], np.nonzero(mask)[0].astype(np.int64)


def spaced_kmers(data, K: int, J: int, canonical: bool = False):
    """K-mers sampled at stride J (SpacedKmers); errors on any ambiguity
    inside sampled windows, like the scalar iterator."""
    arr = _prep(data)
    if arr.size < K:
        return np.zeros(0, np.uint64)
    hi, lo, valid, n_inv, _ = _extract(jnp.asarray(arr), K, canonical)
    vals = u64ops.to_numpy((hi[::J], lo[::J]))
    mask = np.asarray(valid[::J])
    if not mask.all():
        raise EncodeError(DNAAlphabet2(), "<ambiguous base in sampled window>")
    if int(n_inv):
        raise EncodeError(DNAAlphabet2(), "<batch input>")
    return vals


@partial(jax.jit, static_argnames=("K", "s", "canonical"))
def _syncmer_windows(bytes_u8, K: int, s: int, canonical: bool):
    from ..ops.hashing import fx_hash_u64
    from ..ops.minimizer import closed_syncmer_mask

    codes, certain, ambig = classify_2bit(bytes_u8)
    bad = jnp.sum(~certain)
    if canonical:
        hi, lo = canonical_windows_from_codes(codes, K)
        # hash canonical s-mers so selection is strand-symmetric: under
        # reverse complement the s-mer span mirrors, mapping the
        # first-offset criterion onto the last-offset one — which the
        # closed (first OR last) rule is invariant to
        s_hi, s_lo = canonical_windows_from_codes(codes, s)
    else:
        hi, lo = windows_from_codes(codes, K)
        s_hi, s_lo = windows_from_codes(codes, s)
    sh, sl = fx_hash_u64(s_hi, s_lo)
    mask = closed_syncmer_mask(sh, sl, K, s)
    return hi, lo, mask, bad


def syncmer_select(data, K: int = 15, s: int = 5, canonical: bool = False):
    """Closed-syncmer sampling: kmers whose minimal s-mer (by FxHash) sits
    at the first or last offset of the kmer.  Returns (values, positions).

    Unlike minimizers, syncmer selection is a pure function of each kmer's
    own content, so the sampling is context-free (identical for a kmer in
    any sequence) — the property that makes syncmers robust to mutations
    (docs/replacements.md).  With ``canonical=True`` both the emitted
    kmers and the s-mer hashes are canonical, making the sampling
    strand-symmetric.  Requires an ambiguity-free buffer.
    """
    if not 1 <= s < K:
        raise ValueError("need 1 <= s < K")
    arr = _prep(data)
    if arr.size < K:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    hi, lo, mask, bad = _syncmer_windows(jnp.asarray(arr), K, s, canonical)
    if int(bad):
        raise EncodeError(DNAAlphabet2(), "<ambiguous or invalid base>")
    mask = np.asarray(mask)
    vals = u64ops.to_numpy((hi, lo))
    pos = np.nonzero(mask)[0].astype(np.int64)
    return vals[mask], pos


def minimizer_select(
    data,
    K: int = 15,
    W: int = 10,
    canonical: bool = True,
    skip_ambiguous: bool = False,
):
    """(W, K)-minimizers: per window of W consecutive kmers, the kmer with
    the smallest FxHash (leftmost tie-break); returns the deduplicated
    (kmer values, positions) sampling.

    With ``skip_ambiguous=False`` the buffer must be ambiguity-free
    (split reads on Ns first — see kmers_tpu.io record offsets); with
    ``skip_ambiguous=True``, kmers containing ambiguous bases are
    excluded from candidacy and windows with no valid kmer select
    nothing (UnambiguousKmers skip semantics composed with selection).
    """
    arr = _prep(data)
    n = arr.size - K + 1
    if n < W:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    hi, lo, valid, n_inv, n_amb = _extract(jnp.asarray(arr), K, canonical)
    if int(n_inv) or (int(n_amb) and not skip_ambiguous):
        raise EncodeError(DNAAlphabet2(), "<ambiguous or invalid base>")
    if skip_ambiguous:
        from ..ops.minimizer import minimizers_masked

        mh, ml, mp = minimizers_masked(hi, lo, valid, W)
    else:
        mh, ml, mp = _minimizers(hi, lo, W)
    vals = u64ops.to_numpy((mh, ml))
    pos = np.asarray(mp).astype(np.int64)
    keep = np.concatenate([[True], pos[1:] != pos[:-1]]) & (pos >= 0)
    return vals[keep], pos[keep]
