"""Extraction pipelines + batched stats vs the scalar oracle."""

import numpy as np
import pytest

from kmers_tpu import (
    CanonicalDNAMers,
    DNAKmer,
    EncodeError,
    FwDNAMers,
    SpacedDNAMers,
    UnambiguousDNAMers,
    fx_hash,
)
from kmers_tpu.ops import gc_count_u64, u64
from kmers_tpu.ops.encode import classify_2bit
from kmers_tpu.ops.windows import windows_from_codes
from kmers_tpu.pipelines import extract_kmers, minimizer_select, spaced_kmers


def rand_dna(rng, n, chars="ACGT"):
    return "".join(chars[i] for i in rng.integers(0, len(chars), n))


class TestExtract:
    def test_plain(self, rng):
        s = rand_dna(rng, 500)
        vals, pos = extract_kmers(s, K=31)
        want = [DNAKmer(s[i : i + 31]).value for i in range(len(s) - 30)]
        assert vals.tolist() == want
        assert pos.tolist() == list(range(len(want)))

    def test_skipping(self, rng):
        s = rand_dna(rng, 300, "ACGTN")
        vals, pos = extract_kmers(s, K=9)
        want = [(k.value, i) for k, i in UnambiguousDNAMers(9, s)]
        assert list(zip(vals.tolist(), pos.tolist())) == want

    def test_canonical(self, rng):
        s = rand_dna(rng, 200)
        vals, _ = extract_kmers(s, K=21, canonical=True)
        want = [k.value for k in CanonicalDNAMers(21, s)]
        assert vals.tolist() == want

    def test_error_modes(self):
        with pytest.raises(EncodeError):
            extract_kmers("ACGT!ACGT", K=3)
        with pytest.raises(EncodeError):
            extract_kmers("ACGTNACGT", K=3, skip_ambiguous=False)

    @pytest.mark.parametrize("canonical", [False, True])
    def test_n_masked_vs_oracle(self, rng, canonical):
        # a buffer containing Ns: the valid mask drops exactly the
        # windows the scalar UnambiguousDNAMers skips
        s = rand_dna(rng, 700, "ACGTACGTN")
        K = 21
        vals, pos = extract_kmers(s, K=K, canonical=canonical)
        want = [
            ((k.canonical() if canonical else k).value, i)
            for k, i in UnambiguousDNAMers(K, s)
        ]
        assert list(zip(vals.tolist(), pos.tolist())) == want

    def test_k32_uses_full_register(self, rng):
        # K=32 at 2 bits fills the whole 64-bit register (no sentinel
        # headroom); extraction must still match the scalar plane
        s = rand_dna(rng, 300)
        vals, pos = extract_kmers(s, K=32)
        want = [(k.value, i) for k, i in UnambiguousDNAMers(32, s)]
        assert list(zip(vals.tolist(), pos.tolist())) == want

    def test_spaced(self, rng):
        s = rand_dna(rng, 300)
        vals = spaced_kmers(s, K=9, J=4)
        want = [k.value for k in SpacedDNAMers(9, 4, s)]
        assert vals.tolist() == want

    def test_minimizers_dedup(self, rng):
        s = rand_dna(rng, 400)
        K, W = 15, 10
        vals, pos = minimizer_select(s, K=K, W=W)
        # oracle: dedup consecutive sliding-window argmins
        ks = [DNAKmer(s[i : i + K]).canonical() for i in range(len(s) - K + 1)]
        hs = [fx_hash(k) for k in ks]
        want_pos = []
        for j in range(len(ks) - W + 1):
            w = hs[j : j + W]
            p = j + int(np.argmin(w))
            if not want_pos or want_pos[-1] != p:
                want_pos.append(p)
        assert pos.tolist() == want_pos
        assert vals.tolist() == [ks[p].value for p in want_pos]

    def test_minimizers_skip_ambiguous_oracle(self, rng):
        s = "".join("ACGTNACGT"[i] for i in rng.integers(0, 9, 500))
        K, W = 9, 6
        vals, pos = minimizer_select(s, K=K, W=W, skip_ambiguous=True)
        # oracle: valid kmers only; windows with no valid kmer select nothing
        n = len(s) - K + 1
        cand = {}
        for i in range(n):
            win = s[i : i + K]
            if all(c in "ACGT" for c in win):
                k = DNAKmer(win).canonical()
                cand[i] = (fx_hash(k), i, k.value)
        want = []
        for j in range(n - W + 1):
            xs = [cand[i] for i in range(j, j + W) if i in cand]
            if not xs:
                continue
            h, p, v = min(xs)
            if not want or want[-1][0] != p:
                want.append((p, v))
        assert pos.tolist() == [p for p, _ in want]
        assert vals.tolist() == [v for _, v in want]
        # and without the flag the same input raises
        with pytest.raises(EncodeError):
            minimizer_select(s, K=K, W=W)


class TestStats:
    def test_gc_vs_scalar(self, rng):
        s = rand_dna(rng, 300)
        K = 27
        codes, _, _ = classify_2bit(np.frombuffer(s.encode(), np.uint8))
        hi, lo = windows_from_codes(np.asarray(codes), K)
        got = np.asarray(gc_count_u64(hi, lo))
        want = [DNAKmer(s[i : i + K]).count_gc() for i in range(len(s) - K + 1)]
        assert got.tolist() == want


class TestRecordCounting:
    def test_windows_dont_span_records(self, rng):
        import collections
        from kmers_tpu.io import read_fastx_bytes
        from kmers_tpu.pipelines.canonical_count import (
            CountConfig,
            canonical_count_records,
        )

        reads = [rand_dna(rng, int(n)) for n in rng.integers(20, 80, 30)]
        fasta = "".join(f">r{i}\n{r}\n" for i, r in enumerate(reads)).encode()
        seq, off = read_fastx_bytes(fasta)
        K = 15
        kmers, counts = canonical_count_records(seq, off, CountConfig(K=K))
        oracle = collections.Counter()
        for r in reads:
            for k in CanonicalDNAMers(K, r):
                oracle[k.value] += 1
        assert dict(zip(kmers.tolist(), counts.tolist())) == dict(oracle)


class TestLookup:
    def test_counts_lookup(self, rng):
        from kmers_tpu.pipelines import canonical_count, counts_lookup

        s = rand_dna(rng, 500)
        kmers, counts = canonical_count(s, K=11)
        # present queries (by value and by Kmer)
        q_vals = kmers[[0, 5, len(kmers) - 1]]
        assert np.array_equal(
            counts_lookup(kmers, counts, q_vals), counts[[0, 5, len(kmers) - 1]]
        )
        k = DNAKmer(s[3 : 3 + 11])
        assert counts_lookup(kmers, counts, [k])[0] >= 1
        # absent query
        absent = np.uint64((1 << 22) - 1)
        while absent in set(kmers.tolist()):
            absent += np.uint64(1)
        assert counts_lookup(kmers, counts, [absent])[0] == 0


class TestComposition:
    def test_forward(self, rng):
        from kmers_tpu.pipelines import composition_vector

        s = rand_dna(rng, 400)
        v = composition_vector(s, K=3)
        assert v.shape == (64,) and v.sum() == len(s) - 2
        # oracle
        import collections
        want = collections.Counter(k.value for k in FwDNAMers(3, s))
        for code in range(64):
            assert v[code] == want.get(code, 0)

    def test_canonical(self, rng):
        from kmers_tpu.pipelines import composition_vector

        s = rand_dna(rng, 400)
        v = composition_vector(s, K=4, canonical=True)
        import collections
        want = collections.Counter(k.value for k in CanonicalDNAMers(4, s))
        assert v.sum() == len(s) - 3
        for code in range(256):
            assert v[code] == want.get(code, 0)


class TestSyncmers:
    def test_oracle(self, rng):
        from kmers_tpu.pipelines import syncmer_select

        s = rand_dna(rng, 300)
        K, sl = 11, 4
        vals, pos = syncmer_select(s, K=K, s=sl)
        # oracle: per kmer, hash its own s-mers; selected iff min at ends
        want_pos = []
        for i in range(len(s) - K + 1):
            window = s[i : i + K]
            hs = [fx_hash(DNAKmer(window[j : j + sl])) for j in range(K - sl + 1)]
            if min(hs) in (hs[0], hs[-1]):
                want_pos.append(i)
        assert pos.tolist() == want_pos
        assert vals.tolist() == [DNAKmer(s[p : p + K]).value for p in want_pos]

    def test_context_free(self, rng):
        # a kmer's syncmer-ness is identical in any context
        from kmers_tpu.pipelines import syncmer_select

        core = rand_dna(rng, 40)
        K, sl = 11, 4
        _, p1 = syncmer_select("AAAA" + core, K=K, s=sl)
        _, p2 = syncmer_select("GGGGGGGG" + core, K=K, s=sl)
        set1 = {q - 4 for q in p1.tolist() if q >= 4}
        set2 = {q - 8 for q in p2.tolist() if q >= 8}
        assert set1 == set2

    def test_bad_s(self):
        from kmers_tpu.pipelines import syncmer_select

        import pytest as pt
        with pt.raises(ValueError):
            syncmer_select("ACGTACGT", K=4, s=4)


class TestSyncmerStrandSymmetry:
    def test_canonical_strand_symmetric(self, rng):
        from kmers_tpu import Seq, DNAAlphabet2
        from kmers_tpu.pipelines import syncmer_select

        s = rand_dna(rng, 200)
        rc = str(Seq(DNAAlphabet2(), s).reverse_complement())
        K, sl = 11, 4
        v1, _ = syncmer_select(s, K=K, s=sl, canonical=True)
        v2, _ = syncmer_select(rc, K=K, s=sl, canonical=True)
        assert set(v1.tolist()) == set(v2.tolist())

    def test_lookup_0d_query(self, rng):
        from kmers_tpu.pipelines import canonical_count, counts_lookup

        s = rand_dna(rng, 200)
        kmers, counts = canonical_count(s, K=9)
        q = np.array(kmers[0])  # 0-d ndarray
        assert counts_lookup(kmers, counts, q)[0] == counts[0]


def test_counts_lookup_multiword_object_table():
    import numpy as np

    from kmers_tpu.pipelines import CountConfig, canonical_count_bytes
    from kmers_tpu.pipelines.canonical_count import counts_lookup

    rng = np.random.default_rng(9)
    s = bytes(np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 400)])
    kmers, counts = canonical_count_bytes(s, CountConfig(K=47))
    assert kmers.dtype == object and kmers.size > 0
    got = counts_lookup(kmers, counts, [kmers[0], kmers[-1], (1 << 90) + 1])
    assert got.tolist() == [int(counts[0]), int(counts[-1]), 0]


def test_streaming_level_stack_many_chunks_parity():
    """20+ chunks force several merge levels and an uneven final fold;
    the streamed table must equal the single-dispatch table exactly
    (duplicates recur across chunk boundaries via a repeated motif)."""
    import numpy as np

    from kmers_tpu.pipelines import CountConfig, canonical_count_bytes

    rng = np.random.default_rng(21)
    motif = bytes(np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 64)])
    rand = bytes(np.frombuffer(b"ACGTN", np.uint8)[rng.integers(0, 5, 9000)])
    s = motif * 30 + rand + motif * 5  # ~11k bases
    one = canonical_count_bytes(s, CountConfig(K=17))
    for chunk in (400, 512, 777):  # 15-28 chunks, pow2 and not
        many = canonical_count_bytes(
            s, CountConfig(K=17, chunk_size=chunk)
        )
        assert np.array_equal(one[0], many[0])
        assert np.array_equal(one[1], many[1])


def test_streaming_level_stack_multiword_many_chunks():
    import numpy as np

    from kmers_tpu.pipelines import CountConfig, canonical_count_bytes

    rng = np.random.default_rng(22)
    motif = bytes(np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 80)])
    s = motif * 12 + bytes(
        np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 4000)]
    )
    one = canonical_count_bytes(s, CountConfig(K=41))
    many = canonical_count_bytes(s, CountConfig(K=41, chunk_size=333))
    assert np.array_equal(one[0], many[0])
    assert np.array_equal(one[1], many[1])


class TestSmallChunkStride:
    def test_chunk_size_between_k_and_2k(self, rng):
        # regression (round-4 review): the old stride clamp skipped
        # window starts whenever K <= chunk_size < 2K-1
        import collections

        from kmers_tpu import UnambiguousDNAMers
        from kmers_tpu.pipelines import CountConfig, canonical_count_bytes

        s = "".join("ACGT"[i] for i in rng.integers(0, 4, 500))
        K = 31
        for chunk in (31, 40, 60, 61):
            k, c = canonical_count_bytes(
                s, CountConfig(K=K, chunk_size=chunk)
            )
            assert int(c.sum()) == 500 - K + 1, chunk
        oracle = collections.Counter(
            x.canonical().value for x, _ in UnambiguousDNAMers(K, s)
        )
        k, c = canonical_count_bytes(s, CountConfig(K=K, chunk_size=40))
        assert dict(zip(k.tolist(), c.tolist())) == {
            int(x): v for x, v in oracle.items()
        }

    def test_streaming_counter_small_chunks(self, rng):
        from kmers_tpu.pipelines import CountConfig, StreamingCounter, canonical_count

        s = "".join("ACGT"[i] for i in rng.integers(0, 4, 300))
        sc = StreamingCounter(CountConfig(K=31, chunk_size=40))
        sc.update(s)
        k, c = sc.finalize()
        k1, c1 = canonical_count(s, K=31)
        assert np.array_equal(k, k1) and np.array_equal(c, c1)
