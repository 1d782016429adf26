"""The plain-JAX front-end and counting primitives vs the scalar oracle.

Front-end (classify, windows, canonical select, FxHash, error counters),
the 2/4/8-bit window builders, the run-length encoder, sort_count,
compaction, table merges and six-frame counting — at the shapes and edge
cases the counting pipelines depend on.
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

import kmers_tpu as kt
from kmers_tpu import AminoAcidAlphabet, DNAAlphabet2, DNAAlphabet4, Kmer
from kmers_tpu.ops import u64
from kmers_tpu.ops.count import (
    SENTINEL,
    _run_length_encode,
    compact_counts,
    merge_compact_tables,
    sort_count,
)
from kmers_tpu.ops.encode import classify_2bit, encode_table
from kmers_tpu.ops.hashing import fx_hash_u64
from kmers_tpu.ops.windows import (
    canonical_windows_4bit_from_codes,
    canonical_windows_from_codes,
    window_valid_mask,
    windows_from_codes,
)
from kmers_tpu.pipelines.canonical_count import _chunk_canonical

# certain (both cases, U), ambiguous (N, '-') bytes — every class the
# 2-bit classifier distinguishes except invalid
POOL = np.frombuffer(b"ACGTNacgtu-", np.uint8)


def _bytes(rng, n, pool=POOL):
    return pool[rng.integers(0, len(pool), n)]


def _oracle_windows(b: np.ndarray, K: int):
    """(position, canonical Kmer) of every skip-free window."""
    return [(i, k.canonical()) for k, i in kt.UnambiguousDNAMers(K, b.tobytes().decode())]


GRID = [(K, L) for K in (1, 5, 31) for L in (1, 17, 1000, 5003)]


@pytest.mark.parametrize("K,L", GRID)
def test_canonical_windows_vs_oracle(rng, K, L):
    b = _bytes(rng, L)
    hi, lo, valid, _, _ = _chunk_canonical(jnp.asarray(b), K)
    valid = np.asarray(valid)
    vals = u64.to_numpy((hi, lo))
    want = _oracle_windows(b, K)
    assert np.flatnonzero(valid).tolist() == [i for i, _ in want]
    assert vals[valid].tolist() == [k.value for _, k in want]


@pytest.mark.parametrize("K,L", GRID)
def test_fxhash_vs_oracle(rng, K, L):
    b = _bytes(rng, L)
    hi, lo, valid, _, _ = _chunk_canonical(jnp.asarray(b), K)
    hashes = u64.to_numpy(fx_hash_u64(hi, lo))[np.asarray(valid)]
    assert hashes.tolist() == [kt.fx_hash(k) for _, k in _oracle_windows(b, K)]


@pytest.mark.parametrize("L", [1, 17, 1000, 5003])
def test_error_counters(rng, L):
    b = _bytes(rng, L, np.frombuffer(b"ACGTNacgtu-X!", np.uint8))
    _, _, _, n_invalid, n_ambig = _chunk_canonical(jnp.asarray(b), 5)
    up = np.char.upper(b.view("S1"))
    ambig = np.isin(up, [b"N", b"-"])
    certain = np.isin(up, [b"A", b"C", b"G", b"T", b"U"])
    assert int(n_ambig) == int(ambig.sum())
    assert int(n_invalid) == int((~(ambig | certain)).sum())


@pytest.mark.parametrize("K", [1, 7, 16, 31, 32])
def test_long_stream_canonical_windows(rng, K):
    s = "".join("ACGT"[i] for i in rng.integers(0, 4, 20000))
    codes, _, _ = classify_2bit(np.frombuffer(s.encode(), np.uint8))
    got = u64.to_numpy(canonical_windows_from_codes(codes, K))
    want = [k.canonical().value for k in kt.FwDNAMers(K, s)]
    assert got.tolist() == want


@pytest.mark.parametrize("bps,K,canonical", [
    (2, 31, True), (2, 16, False), (4, 15, True), (4, 9, False), (8, 7, False),
])
def test_general_windows_vs_oracle(rng, bps, K, canonical):
    if bps == 2:
        A, chars, n = DNAAlphabet2(), "ACGTN", 4000
    elif bps == 4:
        A, chars, n = DNAAlphabet4(), "ACGTMRN", 3000
    else:
        A, chars, n = AminoAcidAlphabet(), "ARNDCQEGHILKMFPSTWYV", 2000
    s = "".join(chars[i] for i in rng.integers(0, len(chars), n))
    b = np.frombuffer(s.encode(), np.uint8)
    if bps == 2:
        codes, good, _ = classify_2bit(b)
        win = canonical_windows_from_codes if canonical else windows_from_codes
        hi, lo = win(codes, K)
    else:
        codes, good = encode_table(b, type(A))
        if canonical:
            hi, lo = canonical_windows_4bit_from_codes(codes, K)
        else:
            hi, lo = windows_from_codes(codes, K, bps=bps)
    valid = np.asarray(window_valid_mask(good, K))
    vals = u64.to_numpy((hi, lo))
    want = []
    for i in np.flatnonzero(valid):
        k = Kmer(A, s[i : i + K])
        want.append((k.canonical() if canonical else k).value)
    assert vals[valid].tolist() == want


# ---------------------------------------------------------------------------
# run-length encoding and sort_count


def _rle_reference(hi, lo):
    """The sentinel-interspersed table of a sorted (hi, lo) stream: each
    run's last slot keeps (key, run length); other slots are sentinel."""
    n = hi.size
    uh = np.full(n, SENTINEL, np.uint32)
    ul = np.full(n, SENTINEL, np.uint32)
    cnt = np.zeros(n, np.int32)
    if n == 0:
        return uh, ul, cnt, 0
    last = np.ones(n, bool)
    last[:-1] = (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])
    ends = np.flatnonzero(last)
    lens = np.diff(np.concatenate([[-1], ends]))
    real = ~((hi[ends] == SENTINEL) & (lo[ends] == SENTINEL))
    uh[ends[real]] = hi[ends[real]]
    ul[ends[real]] = lo[ends[real]]
    cnt[ends[real]] = lens[real]
    return uh, ul, cnt, int(real.sum())


def _sorted(hi, lo):
    order = np.lexsort((lo, hi))
    return hi[order], lo[order]


def _runs(case, rng):
    sent = np.uint32(SENTINEL)
    if case == "random_duplicates":
        return rng.integers(0, 50, 5000), rng.integers(0, 4, 5000)
    if case == "sentinel_tail":
        hi, lo = rng.integers(0, 20, 3000), rng.integers(0, 3, 3000)
        hi[-100:] = sent
        lo[-100:] = sent
        return hi, lo
    if case == "all_unique":
        return np.arange(1000), np.arange(1000)
    if case == "one_long_run":
        return np.zeros(2000), np.zeros(2000)
    if case == "runs_at_block_edges":
        return np.repeat(np.arange(8), 256), np.zeros(8 * 256)
    if case == "runs_across_rows":
        return np.sort(rng.integers(0, 40, 3 * 1024)), np.zeros(3 * 1024)
    if case == "row_boundary_runs":
        return np.repeat(np.arange(16), 128), np.zeros(16 * 128)
    if case == "odd_length":
        return rng.integers(0, 9, 777), rng.integers(0, 2, 777)
    if case == "empty":
        return np.zeros(0), np.zeros(0)
    raise ValueError(case)


RLE_CASES = [
    "random_duplicates", "sentinel_tail", "all_unique", "one_long_run",
    "runs_at_block_edges", "runs_across_rows", "row_boundary_runs",
    "odd_length", "empty",
]


@pytest.mark.parametrize("case", RLE_CASES)
def test_run_length_encode(rng, case):
    hi, lo = (np.asarray(x).astype(np.uint32) for x in _runs(case, rng))
    hi, lo = _sorted(hi, lo)
    want = _rle_reference(hi, lo)
    if hi.size == 0:
        # sort_count's callers never pass empty streams; the reference
        # shape is still well defined
        assert want[3] == 0
        return
    got = _run_length_encode(jnp.asarray(hi), jnp.asarray(lo))
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w))


def test_sort_count_with_valid_mask(rng):
    n = 4096
    hi = rng.integers(0, 30, n).astype(np.uint32)
    lo = rng.integers(0, 2, n).astype(np.uint32)
    valid = rng.random(n) < 0.9
    uh, ul, cnt, nu = sort_count(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid))
    cnt = np.asarray(cnt)
    keys = (hi[valid].astype(np.uint64) << 32) | lo[valid]
    want_k, want_c = np.unique(keys, return_counts=True)
    real = cnt > 0
    got_k = (np.asarray(uh)[real].astype(np.uint64) << 32) | np.asarray(ul)[real]
    assert np.array_equal(got_k, want_k) and np.array_equal(cnt[real], want_c)
    assert int(nu) == want_k.size


@pytest.mark.parametrize("tiles", [1, 2, 8])
def test_two_key_sort(rng, tiles):
    n = tiles * 1024
    hi = rng.integers(0, 50, n).astype(np.uint32)
    lo = rng.integers(0, 1 << 16, n).astype(np.uint32)
    sh, sl = lax.sort((jnp.asarray(hi), jnp.asarray(lo)), num_keys=2)
    wh, wl = _sorted(hi, lo)
    assert np.array_equal(np.asarray(sh), wh) and np.array_equal(np.asarray(sl), wl)


def test_two_key_sort_sentinels_last(rng):
    n = 2048
    hi = rng.integers(0, 10, n).astype(np.uint32)
    lo = rng.integers(0, 4, n).astype(np.uint32)
    mask = rng.random(n) < 0.3
    hi[mask] = lo[mask] = SENTINEL
    sh, sl = lax.sort((jnp.asarray(hi), jnp.asarray(lo)), num_keys=2)
    sh, sl = np.asarray(sh), np.asarray(sl)
    assert (sh[-mask.sum():] == SENTINEL).all() and (sl[-mask.sum():] == SENTINEL).all()
    wh, wl = _sorted(hi, lo)
    assert np.array_equal(sh, wh) and np.array_equal(sl, wl)


def _table(rng, n, n_keys):
    hi = rng.integers(0, n_keys, n).astype(np.uint32)
    lo = rng.integers(0, 1 << 12, n).astype(np.uint32)
    return sort_count(jnp.asarray(hi), jnp.asarray(lo))[:3]


@pytest.mark.parametrize("n,n_keys", [(2048, 60), (2048, 1), (1 << 14, 1 << 30)])
def test_compact_counts_front_packs(rng, n, n_keys):
    uh, ul, cnt = (np.asarray(x) for x in _table(rng, n, n_keys))
    real = cnt > 0
    oh, ol, oc = (np.asarray(x) for x in compact_counts(uh, ul, cnt))
    m = int(real.sum())
    assert np.array_equal(oh[:m], uh[real]) and np.array_equal(ol[:m], ul[real])
    assert np.array_equal(oc[:m], cnt[real])
    assert (oh[m:] == SENTINEL).all() and (ol[m:] == SENTINEL).all()
    assert (oc[m:] == 0).all()


@pytest.mark.parametrize("n_a,n_b", [(1024, 1024), (2048, 300), (16384, 16384)])
def test_merge_compact_tables(rng, n_a, n_b):
    a = compact_counts(*_table(rng, n_a, 5000))
    b = compact_counts(*_table(rng, n_b, 5000))
    uh, ul, cnt, nu = (np.asarray(x) for x in merge_compact_tables(*a, *b))
    want = collections.Counter()
    for t in (a, b):
        h, l, c = (np.asarray(x) for x in t)
        for key, k in zip(zip(h[c > 0].tolist(), l[c > 0].tolist()), c[c > 0]):
            want[key] += int(k)
    m = int(nu)
    got = dict(zip(zip(uh[:m].tolist(), ul[:m].tolist()), cnt[:m].tolist()))
    assert got == dict(want) and m == len(want)
    assert list(got) == sorted(got)  # sorted and front-packed
    assert (cnt[m:] == 0).all()


# ---------------------------------------------------------------------------
# six-frame counting on the plain path


@pytest.mark.parametrize("K", [1, 3, 5, 7])
def test_sixframe_vs_oracle(rng, K):
    from chip_smoke import sixframe_oracle
    from kmers_tpu.parallel import (
        SixFrameCountConfig,
        data_mesh,
        sharded_sixframe_aa_count,
    )

    s = "".join("ACGTN"[i] for i in rng.choice(5, 2500, p=[0.24] * 4 + [0.04]))
    kmers, counts = sharded_sixframe_aa_count(
        s, SixFrameCountConfig(K=K, chunk_size=999), data_mesh(2)
    )
    assert dict(zip(map(int, kmers), map(int, counts))) == sixframe_oracle(s, K)
