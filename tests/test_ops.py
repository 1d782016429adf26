"""Array plane vs the scalar oracle: bit-exact parity.

The scalar Kmer plane plays the role Kmers.jl plays for the reference's
tests (SURVEY.md §4 "oracle testing"): every batched kernel must
reproduce the scalar iterators' outputs exactly.
"""

import collections

import numpy as np
import pytest

from kmers_tpu import (
    AAKmer,
    AminoAcidAlphabet,
    CanonicalDNAMers,
    DNAAlphabet2,
    DNAAlphabet4,
    DNAKmer,
    FwKmers,
    Kmer,
    Seq,
    SpacedDNAMers,
    UnambiguousDNAMers,
    fx_hash,
    mer,
    ncbi_trans_table,
)
from kmers_tpu.ops import (
    aa_kmer_windows,
    canonical_windows_from_codes,
    classify_2bit,
    encode_table,
    fx_hash_u64,
    merge_sorted_counts,
    minimizers,
    pack_words,
    rc_windows_from_codes,
    six_frame_codes,
    sliding_min_u64,
    sort_count,
    translate_codes,
    u64,
    window_u64,
    window_valid_mask,
    windows_from_codes,
)
from kmers_tpu.pipelines import CountConfig, canonical_count, canonical_count_bytes


def rand_dna(rng, n, chars="ACGT"):
    return "".join(chars[i] for i in rng.integers(0, len(chars), n))


def to_bytes(s):
    return np.frombuffer(s.encode(), np.uint8)


class TestU64:
    def test_arith_vs_python(self, rng):
        xs = rng.integers(0, 2**64, 200, dtype=np.uint64)
        ys = rng.integers(0, 2**64, 200, dtype=np.uint64)
        a = u64.u64(xs >> np.uint64(32), xs & np.uint64(0xFFFFFFFF))
        b = u64.u64(ys >> np.uint64(32), ys & np.uint64(0xFFFFFFFF))
        M = (1 << 64) - 1
        assert np.array_equal(
            u64.to_numpy(u64.mul(a, b)),
            np.array([(int(x) * int(y)) & M for x, y in zip(xs, ys)], np.uint64),
        )
        assert np.array_equal(
            u64.to_numpy(u64.add(a, b)),
            np.array([(int(x) + int(y)) & M for x, y in zip(xs, ys)], np.uint64),
        )
        for k in [1, 5, 31, 32, 33, 63]:
            assert np.array_equal(
                u64.to_numpy(u64.shl(a, k)),
                np.array([(int(x) << k) & M for x in xs], np.uint64),
            )
            assert np.array_equal(
                u64.to_numpy(u64.shr(a, k)),
                np.array([int(x) >> k for x in xs], np.uint64),
            )
            assert np.array_equal(
                u64.to_numpy(u64.rotl(a, k)),
                np.array(
                    [((int(x) << k) | (int(x) >> (64 - k))) & M for x in xs],
                    np.uint64,
                ),
            )
        assert np.array_equal(
            np.asarray(u64.lt(a, b)), xs < ys
        )
        assert np.array_equal(np.asarray(u64.eq(a, a)), np.ones(200, bool))


class TestClassify:
    def test_classes(self):
        s = b"ACGTacgtUuNnMmRr-X!z\x00"
        codes, certain, ambig = classify_2bit(np.frombuffer(s, np.uint8))
        codes, certain, ambig = (np.asarray(x) for x in (codes, certain, ambig))
        want_codes = [0, 1, 2, 3, 0, 1, 2, 3, 3, 3]
        assert list(codes[:10]) == want_codes
        assert certain[:10].all()
        assert not certain[10:].any()
        assert list(ambig[10:]) == [True] * 7 + [False, False, False, False]

    def test_vs_skipping_lut(self):
        from kmers_tpu import ASCII_SKIPPING_LUT

        all_bytes = np.arange(256, dtype=np.uint8)
        codes, certain, ambig = (
            np.asarray(x) for x in classify_2bit(all_bytes)
        )
        lut = np.asarray(ASCII_SKIPPING_LUT)
        assert np.array_equal(certain, lut <= 3)
        assert np.array_equal(ambig, lut == 0xF0)
        assert np.array_equal(codes[lut <= 3], lut[lut <= 3])

    def test_encode_table(self):
        enc, valid = encode_table(to_bytes("ACMGRSVTWYHKDBN-"), DNAAlphabet4)
        assert np.asarray(valid).all()
        assert list(np.asarray(enc)) == [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 0]
        enc, valid = encode_table(to_bytes("AZ*-!"), AminoAcidAlphabet)
        assert list(np.asarray(valid)) == [True] * 4 + [False]
        assert list(np.asarray(enc)[:4]) == [0x00, 0x18, 0x1A, 0x1B]

    def test_encode_table_matches_ascii_table_all_bytes(self):
        # the gather-free letter-mask form must be bit-identical to
        # indexing the 256-entry ASCII table, for every byte value
        from kmers_tpu.alphabets import RNAAlphabet2, RNAAlphabet4
        from kmers_tpu.ops.encode import _TABLES

        b = np.arange(256, dtype=np.uint8)
        for cls in (
            DNAAlphabet2,
            RNAAlphabet2,
            DNAAlphabet4,
            RNAAlphabet4,
            AminoAcidAlphabet,
        ):
            tbl = np.asarray(_TABLES[cls], np.uint8)
            enc, valid = encode_table(b, cls)
            assert np.array_equal(np.asarray(enc), tbl.astype(np.uint32)), cls
            assert np.array_equal(np.asarray(valid), tbl != 0xFF), cls

    def test_lookup_bytes_vs_numpy_indexing(self, rng):
        from kmers_tpu.ops.encode import lookup_bytes

        for n in (4, 16, 28, 64, 256):
            tbl = rng.integers(0, 256, n).astype(np.uint8)
            idx = rng.integers(0, n, 5000)
            got = np.asarray(lookup_bytes(tbl, idx))
            assert np.array_equal(got, tbl[idx].astype(np.uint32)), n


class TestWindows:
    @pytest.mark.parametrize("K", [1, 5, 16, 17, 31, 32])
    def test_fw_parity(self, rng, K):
        s = rand_dna(rng, 257)
        codes, _, _ = classify_2bit(to_bytes(s))
        vals = u64.to_numpy(windows_from_codes(np.asarray(codes), K))
        want = np.array(
            [DNAKmer(s[i : i + K]).value for i in range(len(s) - K + 1)],
            np.uint64,
        )
        assert np.array_equal(vals, want)

    @pytest.mark.parametrize("K", [1, 11, 31])
    def test_rc_canonical_parity(self, rng, K):
        s = rand_dna(rng, 200)
        codes, _, _ = classify_2bit(to_bytes(s))
        rc = u64.to_numpy(rc_windows_from_codes(np.asarray(codes), K))
        canon = u64.to_numpy(canonical_windows_from_codes(np.asarray(codes), K))
        ks = [DNAKmer(s[i : i + K]) for i in range(len(s) - K + 1)]
        assert np.array_equal(
            rc, np.array([k.reverse_complement().value for k in ks], np.uint64)
        )
        assert np.array_equal(
            canon, np.array([k.canonical().value for k in ks], np.uint64)
        )

    def test_4bit_windows(self, rng):
        s = rand_dna(rng, 100, "ACGTMRSVWYHKDBN")
        codes, valid = encode_table(to_bytes(s), DNAAlphabet4)
        K = 13
        vals = u64.to_numpy(windows_from_codes(np.asarray(codes), K, bps=4))
        want = np.array(
            [Kmer(DNAAlphabet4(), s[i : i + K]).value for i in range(len(s) - K + 1)],
            np.uint64,
        )
        assert np.array_equal(vals, want)

    def test_8bit_windows(self, rng):
        s = rand_dna(rng, 80, "ARNDCQEGHILKMFPSTWYV")
        codes, _ = encode_table(to_bytes(s), AminoAcidAlphabet)
        for K in [1, 4, 8]:
            vals = u64.to_numpy(windows_from_codes(np.asarray(codes), K, bps=8))
            want = np.array(
                [AAKmer(s[i : i + K]).value for i in range(len(s) - K + 1)],
                np.uint64,
            )
            assert np.array_equal(vals, want)

    def test_too_large_k(self):
        with pytest.raises(NotImplementedError):
            windows_from_codes(np.zeros(100, np.uint32), 33, bps=2)

    def test_valid_mask(self, rng):
        s = rand_dna(rng, 120, "ACGTN")
        _, certain, _ = classify_2bit(to_bytes(s))
        K = 7
        mask = np.asarray(window_valid_mask(np.asarray(certain), K))
        want = np.array(
            [all(c in "ACGT" for c in s[i : i + K]) for i in range(len(s) - K + 1)]
        )
        assert np.array_equal(mask, want)

    def test_short_input(self):
        hi, lo = windows_from_codes(np.zeros(3, np.uint32), 5)
        assert hi.shape == (0,)


class TestHash:
    def test_parity(self, rng):
        s = rand_dna(rng, 150)
        K = 31
        codes, _, _ = classify_2bit(to_bytes(s))
        hi, lo = windows_from_codes(np.asarray(codes), K)
        h = u64.to_numpy(fx_hash_u64(hi, lo))
        want = np.array(
            [fx_hash(DNAKmer(s[i : i + K])) for i in range(len(s) - K + 1)],
            np.uint64,
        )
        assert np.array_equal(h, want)


class TestCount:
    def test_sort_count_sentinel_headroom_guard(self):
        # the all-ones count sentinel needs >= 2 bits of headroom; wider
        # keys must be rejected at the entry point (VERDICT round 2 #8)
        hi = np.zeros(8, np.uint32)
        lo = np.zeros(8, np.uint32)
        out = sort_count(hi, lo, key_bits=62)  # boundary: allowed
        assert int(out[3]) == 1
        with pytest.raises(ValueError, match="sentinel"):
            sort_count(hi, lo, key_bits=63)
        with pytest.raises(ValueError, match="multi-limb"):
            sort_count(hi, lo, key_bits=64)

    def test_sort_count_parity(self, rng):
        s = rand_dna(rng, 3000, "ACGTN")
        K = 9
        kmers, counts = canonical_count(s, K=K)
        oracle = collections.Counter(
            k.canonical().value for k, _ in UnambiguousDNAMers(K, s)
        )
        assert dict(zip(kmers.tolist(), counts.tolist())) == {
            int(k): v for k, v in oracle.items()
        }
        # deterministic & sorted
        assert np.array_equal(np.sort(kmers), kmers)

    def test_chunked_equals_single(self, rng):
        s = rand_dna(rng, 20000)
        a = canonical_count_bytes(s, CountConfig(K=15, chunk_size=3001))
        b = canonical_count_bytes(s, CountConfig(K=15))
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])

    def test_ambiguity_error_mode(self, rng):
        from kmers_tpu import EncodeError

        with pytest.raises(EncodeError):
            canonical_count("ACGTNACGTACG", K=5, skip_ambiguous=False)
        with pytest.raises(EncodeError):
            canonical_count("ACGT!ACGTACG", K=5)

    def test_merge(self, rng):
        s1, s2 = rand_dna(rng, 500), rand_dna(rng, 700)
        k1, c1 = canonical_count(s1, K=7)
        k2, c2 = canonical_count(s2, K=7)
        km, cm = canonical_count(s1 + "N" + s2, K=7)  # N splits windows
        merged = collections.Counter(dict(zip(k1.tolist(), c1.tolist())))
        merged.update(dict(zip(k2.tolist(), c2.tolist())))
        assert dict(zip(km.tolist(), cm.tolist())) == dict(merged)

    def test_total_kmers(self, rng):
        s = rand_dna(rng, 1000)
        K = 31
        _, counts = canonical_count(s, K=K)
        assert counts.sum() == len(s) - K + 1

    def test_compact_counts(self, rng):
        from kmers_tpu.ops.count import SENTINEL, compact_counts

        for n in (1, 2, 65, 1000, 4096):
            for p in (0.0, 0.3, 1.0):
                real = rng.random(n) < p
                uh = np.where(real, rng.integers(0, 1 << 30, n), SENTINEL)
                ul = np.where(real, rng.integers(0, 1 << 31, n), SENTINEL)
                cnt = np.where(real, rng.integers(1, 99, n), 0)
                oh, ol, oc = (
                    np.asarray(x)
                    for x in compact_counts(
                        uh.astype(np.uint32),
                        ul.astype(np.uint32),
                        cnt.astype(np.int32),
                    )
                )
                m = int(real.sum())
                assert np.array_equal(oh[:m], uh[real].astype(np.uint32))
                assert np.array_equal(ol[:m], ul[real].astype(np.uint32))
                assert np.array_equal(oc[:m], cnt[real])
                assert (oh[m:] == SENTINEL).all() and (oc[m:] == 0).all()

    def test_merge_compact_tables(self, rng):
        from kmers_tpu.ops.count import compact_counts, merge_compact_tables

        s1, s2 = rand_dna(rng, 900), rand_dna(rng, 333)
        K = 11
        tables = []
        for s in (s1, s2):
            codes, certain, _ = classify_2bit(to_bytes(s))
            hi, lo = canonical_windows_from_codes(codes, K)
            valid = window_valid_mask(certain, K)
            t = sort_count(hi, lo, valid)
            tables.append(compact_counts(t[0], t[1], t[2]))
        mh, ml, mc, mnu = merge_compact_tables(*tables[0], *tables[1])
        mh, ml, mc = (np.asarray(x) for x in (mh, ml, mc))
        keep = mc > 0
        got = {
            (int(h) << 32) | int(l): int(c)
            for h, l, c in zip(mh[keep], ml[keep], mc[keep])
        }
        oracle = collections.Counter(
            k.canonical().value for k, _ in UnambiguousDNAMers(K, s1)
        )
        oracle.update(
            k.canonical().value for k, _ in UnambiguousDNAMers(K, s2)
        )
        assert got == {int(k): v for k, v in oracle.items()}
        assert int(mnu) == len(oracle)
        # sorted among real rows, sentinels at the end
        keys = (mh[keep].astype(np.uint64) << np.uint64(32)) | ml[keep]
        assert (np.diff(keys.astype(np.uint64)) > 0).all()
        assert keep[: int(keep.sum())].all()

    def test_merge_compact_tables_large_sort_form(self, rng):
        # tables >= 2^22 rows take the concat+sort+RLE form
        # (ROUND6F_r04.jsonl); same contract: compact, sorted, summed
        from kmers_tpu.ops.count import SENTINEL, merge_compact_tables

        n = 1 << 22
        def mk(n_real, seed):
            r = np.random.default_rng(seed)
            v = np.unique(r.integers(0, 1 << 40, n_real).astype(np.uint64))
            h = np.full(n, SENTINEL, np.uint32)
            l = np.full(n, SENTINEL, np.uint32)
            c = np.zeros(n, np.int32)
            h[: v.size] = (v >> np.uint64(32)).astype(np.uint32)
            l[: v.size] = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)
            c[: v.size] = 1 + (np.arange(v.size) % 4)
            return (h, l, c), dict(
                zip(v.tolist(), c[: v.size].tolist())
            )
        A, da = mk(3000, 1)
        B, db = mk(2000, 2)
        mh, ml, mc, mnu = merge_compact_tables(*A, *B)
        mh, ml, mc = (np.asarray(x) for x in (mh, ml, mc))
        want = collections.Counter(da)
        want.update(db)
        m = len(want)
        assert int(mnu) == m
        # compact: all real rows first, sorted
        assert (mc[:m] > 0).all() and (mc[m:] == 0).all()
        keys = (mh[:m].astype(np.uint64) << np.uint64(32)) | ml[:m]
        assert keys.tolist() == sorted(want)
        assert mc[:m].tolist() == [want[k] for k in sorted(want)]

    def test_merge_compact_tables_mw_large_sort_form(self, rng):
        from kmers_tpu.ops.multiword import merge_compact_tables_mw

        n = 1 << 22
        M = 3
        def mk(n_real, seed):
            r = np.random.default_rng(seed)
            v = np.unique(r.integers(0, 1 << 50, n_real).astype(np.uint64))
            limbs = [np.full(n, 0xFFFFFFFF, np.uint32) for _ in range(M)]
            c = np.zeros(n, np.int32)
            limbs[1][: v.size] = (v >> np.uint64(32)).astype(np.uint32)
            limbs[2][: v.size] = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)
            limbs[0][: v.size] = 0
            c[: v.size] = 2
            return (tuple(limbs), c), {int(x): 2 for x in v}
        (la, ca), da = mk(1500, 3)
        (lb, cb), db = mk(900, 4)
        ol, oc, nu = merge_compact_tables_mw(la, ca, lb, cb)
        oc = np.asarray(oc)
        want = collections.Counter(da)
        want.update(db)
        m = len(want)
        assert int(nu) == m
        assert (oc[:m] > 0).all() and (oc[m:] == 0).all()
        keys = [
            (int(np.asarray(ol[1])[i]) << 32) | int(np.asarray(ol[2])[i])
            for i in range(m)
        ]
        assert keys == sorted(want)
        assert oc[:m].tolist() == [want[k] for k in sorted(want)]


class TestMinimizer:
    def test_sliding_min_oracle(self, rng):
        n, W = 300, 11
        keys = rng.integers(0, 2**64, n, dtype=np.uint64)
        # inject ties to exercise leftmost tie-break
        keys[50:60] = keys[50]
        hi = (keys >> np.uint64(32)).astype(np.uint32)
        lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        mh, ml, mp = sliding_min_u64(hi, lo, W)
        got = u64.to_numpy((mh, ml))
        pos = np.asarray(mp)
        for j in range(n - W + 1):
            w = keys[j : j + W]
            assert got[j] == w.min()
            assert pos[j] == j + int(np.argmin(w))  # leftmost

    def test_minimizers_parity(self, rng):
        s = rand_dna(rng, 400)
        K, W = 15, 10
        codes, _, _ = classify_2bit(to_bytes(s))
        hi, lo = canonical_windows_from_codes(np.asarray(codes), K)
        mh, ml, mp = minimizers(hi, lo, W)
        # oracle: per window of W kmers, leftmost min fx_hash
        ks = [
            DNAKmer(s[i : i + K]).canonical() for i in range(len(s) - K + 1)
        ]
        hs = [fx_hash(k) for k in ks]
        got = u64.to_numpy((mh, ml))
        for j in range(len(ks) - W + 1):
            w = hs[j : j + W]
            i = j + int(np.argmin(w))
            assert int(np.asarray(mp)[j]) == i
            assert int(got[j]) == ks[i].value


class TestTranslateOps:
    def test_translate_parity(self, rng):
        s = rand_dna(rng, 99)
        codes, _, _ = classify_2bit(to_bytes(s))
        for code in [None, ncbi_trans_table[2], ncbi_trans_table[25]]:
            kwargs = {} if code is None else {"code": code}
            aa = np.asarray(
                translate_codes(np.asarray(codes), **({"code": code} if code else {}))
            )
            want = (
                Seq(DNAAlphabet2(), s)
                .translate(**({"code": code} if code else {}))
                .codes
            )
            assert np.array_equal(aa, np.asarray(want, np.uint32))

    def test_six_frames(self, rng):
        s = rand_dna(rng, 100)
        codes, _, _ = classify_2bit(to_bytes(s))
        frames = six_frame_codes(np.asarray(codes))
        seq = Seq(DNAAlphabet2(), s)
        rc = seq.reverse_complement()
        for f in range(3):
            fw_len = (100 - f) // 3
            want = Seq(DNAAlphabet2(), str(seq)[f : f + 3 * fw_len]).translate()
            assert np.array_equal(
                np.asarray(frames[f]), np.asarray(want.codes, np.uint32)
            )
            want_rc = Seq(
                DNAAlphabet2(), str(rc)[f : f + 3 * fw_len]
            ).translate()
            assert np.array_equal(
                np.asarray(frames[3 + f]), np.asarray(want_rc.codes, np.uint32)
            )

    def test_six_frame_aa_kmers(self, rng):
        from kmers_tpu.ops import six_frame_aa_kmers

        s = rand_dna(rng, 60)
        codes, _, _ = classify_2bit(to_bytes(s))
        K = 5
        frames = six_frame_aa_kmers(np.asarray(codes), K)
        seq = Seq(DNAAlphabet2(), s)
        streams = [str(seq), str(seq.reverse_complement())]
        idx = 0
        for stream in streams:
            for f in range(3):
                n_aa = (60 - f) // 3
                aa = Seq(DNAAlphabet2(), stream[f : f + 3 * n_aa]).translate()
                want = np.array(
                    [
                        AAKmer(str(aa)[i : i + K]).value
                        for i in range(len(aa) - K + 1)
                    ],
                    np.uint64,
                )
                assert np.array_equal(u64.to_numpy(frames[idx]), want)
                idx += 1


class TestSpacedArrays:
    def test_strided_slice_parity(self, rng):
        s = rand_dna(rng, 200)
        K, J = 9, 4
        codes, _, _ = classify_2bit(to_bytes(s))
        hi, lo = windows_from_codes(np.asarray(codes), K)
        vals = u64.to_numpy((hi[::J], lo[::J]))
        want = np.array([k.value for k in SpacedDNAMers(K, J, s)], np.uint64)
        assert np.array_equal(vals, want)


class TestFourBitCanonical:
    @pytest.mark.parametrize("K", [1, 7, 15])
    def test_parity(self, rng, K):
        from kmers_tpu.ops import (
            canonical_windows_4bit_from_codes,
            rc_windows_4bit_from_codes,
        )

        s = rand_dna(rng, 150, "ACGTMRSVWYHKDBN")
        codes, valid = encode_table(to_bytes(s), DNAAlphabet4)
        codes = np.asarray(codes)
        ks = [
            Kmer(DNAAlphabet4(), s[i : i + K]) for i in range(len(s) - K + 1)
        ]
        rc = u64.to_numpy(rc_windows_4bit_from_codes(codes, K))
        assert np.array_equal(
            rc, np.array([k.reverse_complement().value for k in ks], np.uint64)
        )
        canon = u64.to_numpy(canonical_windows_4bit_from_codes(codes, K))
        assert np.array_equal(
            canon, np.array([k.canonical().value for k in ks], np.uint64)
        )

    def test_counting(self, rng):
        import collections
        from kmers_tpu import CanonicalKmers
        from kmers_tpu.ops import canonical_windows_4bit_from_codes

        s = rand_dna(rng, 800, "ACGTN")
        codes, _ = encode_table(to_bytes(s), DNAAlphabet4)
        hi, lo = canonical_windows_4bit_from_codes(np.asarray(codes), 9)
        uh, ul, cnt, nu = sort_count(hi, lo)
        got = {}
        for h, l, c in zip(np.asarray(uh), np.asarray(ul), np.asarray(cnt)):
            if c > 0:
                got[(int(h) << 32) | int(l)] = int(c)
        oracle = collections.Counter(
            k.value for k in CanonicalKmers(DNAAlphabet4(), 9, Seq(DNAAlphabet4(), s))
        )
        assert got == dict(oracle)
