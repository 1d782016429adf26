"""Multi-word (K > 32) array plane vs the scalar oracle."""

import collections

import jax.numpy as jnp

import numpy as np
import pytest

from kmers_tpu import DNAKmer, UnambiguousDNAMers, fx_hash
from kmers_tpu.ops import u64
from kmers_tpu.ops.encode import classify_2bit
from kmers_tpu.ops.multiword import (
    canonical_windows_mw,
    fx_hash_mw,
    mw_to_numpy,
    n_limbs,
    rc_windows_mw,
    sort_count_mw,
    windows_mw,
)
from kmers_tpu.ops.windows import window_valid_mask


def rand_dna(rng, n, chars="ACGT"):
    return "".join(chars[i] for i in rng.integers(0, len(chars), n))


def codes_of(s):
    c, certain, _ = classify_2bit(np.frombuffer(s.encode(), np.uint8))
    return np.asarray(c), np.asarray(certain)


class TestMultiwordWindows:
    @pytest.mark.parametrize("K", [33, 48, 63, 64, 100])
    def test_fw_parity(self, rng, K):
        s = rand_dna(rng, 300)
        codes, _ = codes_of(s)
        limbs = windows_mw(codes, K)
        got = mw_to_numpy(limbs)
        want = [DNAKmer(s[i : i + K]).value for i in range(len(s) - K + 1)]
        assert list(got) == want

    @pytest.mark.parametrize("K", [33, 63])
    def test_rc_canonical_parity(self, rng, K):
        s = rand_dna(rng, 250)
        codes, _ = codes_of(s)
        ks = [DNAKmer(s[i : i + K]) for i in range(len(s) - K + 1)]
        rc = mw_to_numpy(rc_windows_mw(codes, K))
        assert list(rc) == [k.reverse_complement().value for k in ks]
        canon = mw_to_numpy(canonical_windows_mw(codes, K))
        assert list(canon) == [k.canonical().value for k in ks]

    def test_small_k_consistency(self, rng):
        # M=1 and M=2 paths agree with the (hi, lo) engine
        from kmers_tpu.ops.windows import windows_from_codes

        s = rand_dna(rng, 200)
        codes, _ = codes_of(s)
        for K in (9, 31):
            limbs = windows_mw(codes, K)
            want = u64.to_numpy(windows_from_codes(codes, K))
            got = mw_to_numpy(limbs)
            assert [int(x) for x in got] == [int(x) for x in want]


class TestMultiwordHash:
    @pytest.mark.parametrize("K", [33, 48, 63])
    def test_parity(self, rng, K):
        s = rand_dna(rng, 200)
        codes, _ = codes_of(s)
        limbs = windows_mw(codes, K)
        h = u64.to_numpy(fx_hash_mw(limbs, K))
        want = [
            fx_hash(DNAKmer(s[i : i + K])) for i in range(len(s) - K + 1)
        ]
        assert [int(x) for x in h] == want


class TestMultiwordCount:
    @pytest.mark.parametrize("K", [33, 48, 63])
    def test_count_parity(self, rng, K):
        s = rand_dna(rng, 4000, "ACGTN")
        codes, certain = codes_of(s)
        limbs = canonical_windows_mw(codes, K)
        valid = window_valid_mask(certain, K)
        ulimbs, counts, nu = sort_count_mw(limbs, valid)
        got = {}
        vals = mw_to_numpy(ulimbs)
        for v, c in zip(vals, np.asarray(counts)):
            if c > 0:
                got[int(v)] = int(c)
        oracle = collections.Counter(
            k.canonical().value for k, _ in UnambiguousDNAMers(K, s)
        )
        assert got == dict(oracle)
        assert int(nu) == len(oracle)

    @pytest.mark.parametrize("K", [33, 47])
    def test_count_parity_sentinel_form(self, rng, K):
        # key_bits < 32*M drops the explicit invalid-flag sort operand
        # and marks invalids by value; results must be identical
        s = rand_dna(rng, 3000, "ACGTN")
        codes, certain = codes_of(s)
        limbs = canonical_windows_mw(codes, K)
        valid = window_valid_mask(certain, K)
        a = sort_count_mw(limbs, valid)
        b = sort_count_mw(limbs, valid, key_bits=2 * K)
        assert int(a[2]) == int(b[2])
        da = dict(
            (int(v), int(c))
            for v, c in zip(mw_to_numpy(a[0]), np.asarray(a[1]))
            if c > 0
        )
        db = dict(
            (int(v), int(c))
            for v, c in zip(mw_to_numpy(b[0]), np.asarray(b[1]))
            if c > 0
        )
        assert da == db

    def test_all_ones_register_not_dropped_at_boundary_width(self):
        # K=32: 2K == 32*M, so the all-ones register IS a valid kmer
        # (T^32 canonically... poly-A's RC) and key_bits must keep the
        # flag operand — a sentinel form would silently drop it
        import jax.numpy as jnp

        K = 32
        M = 2
        ones = np.uint32(0xFFFFFFFF)
        limbs = (
            jnp.asarray([ones, 5, ones], jnp.uint32),
            jnp.asarray([ones, 9, ones], jnp.uint32),
        )
        valid = jnp.asarray([True, True, False])
        ulimbs, counts, nu = sort_count_mw(limbs, valid, key_bits=2 * K)
        got = {
            int(v): int(c)
            for v, c in zip(mw_to_numpy(ulimbs), np.asarray(counts))
            if c > 0
        }
        all_ones_val = (int(ones) << 32) | int(ones)
        assert got == {(5 << 32) | 9: 1, all_ones_val: 1}
        assert int(nu) == 2

    def test_repeat_heavy(self):
        s = "ACGTACGTA" * 100
        K = 40
        codes, certain = codes_of(s)
        limbs = canonical_windows_mw(codes, K)
        valid = window_valid_mask(certain, K)
        ulimbs, counts, nu = sort_count_mw(limbs, valid)
        oracle = collections.Counter(
            k.canonical().value for k, _ in UnambiguousDNAMers(K, s)
        )
        assert int(np.asarray(counts).sum()) == sum(oracle.values())
        assert int(nu) == len(oracle)

    def test_n_limbs(self):
        assert n_limbs(31) == 2 and n_limbs(33) == 3 and n_limbs(48) == 3
        assert n_limbs(63) == 4 and n_limbs(64) == 4


class TestMultiwordPipeline:
    @pytest.mark.parametrize("K", [33, 55])
    def test_pipeline_parity(self, rng, K):
        from kmers_tpu.pipelines import canonical_count

        s = rand_dna(rng, 3000, "ACGTN")
        kmers, counts = canonical_count(s, K=K)
        oracle = collections.Counter(
            k.canonical().value for k, _ in UnambiguousDNAMers(K, s)
        )
        assert dict(zip([int(k) for k in kmers], counts.tolist())) == dict(oracle)

    @pytest.mark.parametrize("K", [32, 33, 47, 63])
    def test_streamed_pipeline_oracle_parity(self, rng, K):
        # 500-base chunks through the level stack vs the scalar oracle,
        # on a buffer with Ns
        from kmers_tpu.pipelines import CountConfig, canonical_count_bytes

        s = rand_dna(rng, 2000, "ACGTN")
        a = canonical_count_bytes(s, CountConfig(K=K, chunk_size=500))
        oracle = collections.Counter(
            k.canonical().value for k, _ in UnambiguousDNAMers(K, s)
        )
        assert dict(zip([int(k) for k in a[0]], a[1].tolist())) == dict(oracle)

    def test_invalid_byte_error(self, rng):
        from kmers_tpu import EncodeError
        from kmers_tpu.pipelines import CountConfig, canonical_count_bytes

        s = rand_dna(rng, 500) + "!" + rand_dna(rng, 100)
        with pytest.raises(EncodeError):
            canonical_count_bytes(s, CountConfig(K=33))

    def test_chunked(self, rng):
        from kmers_tpu.pipelines import CountConfig, canonical_count_bytes

        s = rand_dna(rng, 5000)
        a = canonical_count_bytes(s, CountConfig(K=40, chunk_size=700))
        b = canonical_count_bytes(s, CountConfig(K=40))
        assert [int(x) for x in a[0]] == [int(x) for x in b[0]]
        assert np.array_equal(a[1], b[1])

    def test_explicit_chunk_size_honored(self):
        # an explicit chunk_size must never be silently overridden by
        # the per-regime default (K>31 auto-resolves to 2^19 only when
        # chunk_size is None)
        from kmers_tpu.pipelines import CountConfig

        assert CountConfig(K=47).resolved_chunk_size == 1 << 19
        assert CountConfig(K=31).resolved_chunk_size == 1 << 20
        assert CountConfig(K=47, chunk_size=1 << 20).resolved_chunk_size == (
            1 << 20
        )
        assert CountConfig(K=31, chunk_size=1 << 19).resolved_chunk_size == (
            1 << 19
        )

    def test_chunked_duplicates_oracle(self, rng):
        # repeats spanning chunk boundaries: the device-side bitonic
        # accumulator must sum counts across chunks exactly
        from kmers_tpu.pipelines import CountConfig, canonical_count_bytes

        unit = rand_dna(rng, 400)
        s = unit * 6  # heavy cross-chunk duplication
        K = 47
        kmers, counts = canonical_count_bytes(
            s, CountConfig(K=K, chunk_size=512)
        )
        oracle = collections.Counter(
            k.canonical().value for k, _ in UnambiguousDNAMers(K, s)
        )
        assert dict(zip([int(k) for k in kmers], counts.tolist())) == dict(oracle)
        assert max(counts) >= 5  # duplication actually exercised
        vals = [int(k) for k in kmers]
        assert vals == sorted(vals)


class TestMultiwordMerge:
    def test_merge_compact_tables_mw(self, rng):
        from kmers_tpu.ops.multiword import (
            compact_counts_mw,
            merge_compact_tables_mw,
            sort_count_mw,
        )

        M = 3
        a = tuple(
            jnp.asarray(rng.integers(0, 50, 64, np.uint32)) for _ in range(M)
        )
        b = tuple(
            jnp.asarray(rng.integers(0, 50, 32, np.uint32)) for _ in range(M)
        )
        ta = compact_counts_mw(*sort_count_mw(a)[:2])
        tb = compact_counts_mw(*sort_count_mw(b)[:2])
        ml, mc, nu = merge_compact_tables_mw(ta[0], ta[1], tb[0], tb[1])
        want = collections.Counter()
        for limbs in (a, b):
            arrs = [np.asarray(x) for x in limbs]
            for i in range(arrs[0].shape[0]):
                v = 0
                for x in arrs:
                    v = (v << 32) | int(x[i])
                want[v] += 1
        got = {}
        cnt = np.asarray(mc)
        arrs = [np.asarray(x) for x in ml]
        for i in range(cnt.shape[0]):
            if cnt[i] > 0:
                v = 0
                for x in arrs:
                    v = (v << 32) | int(x[i])
                got[v] = int(cnt[i])
        assert got == dict(want)
        assert int(nu) == len(want)
        assert list(got) == sorted(got)
