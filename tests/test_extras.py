"""Random kmers, MinHash pipeline, metrics, checkpointing."""

import collections

import numpy as np
import pytest

from kmers_tpu import (
    AminoAcidAlphabet,
    CanonicalDNAMers,
    DNAAlphabet2,
    DNAAlphabet4,
    EncodeError,
    Kmer,
    RNAAlphabet4,
    UnambiguousDNAMers,
    canonical,
    fx_hash,
)
from kmers_tpu.random import rand_kmer, rand_kmers, PROTEOGENIC_AA
from kmers_tpu.pipelines.minhash import minhash_sketch, jaccard
from kmers_tpu.utils import Metrics, load_count_table, save_count_table


class TestRandom:
    def test_two_bit_uniform(self, rng):
        vals = rand_kmers(DNAAlphabet2(), 4, 20000, rng)
        assert vals.max() < 256
        # all 256 4-mers appear, roughly uniform
        counts = np.bincount(vals.astype(np.int64), minlength=256)
        assert (counts > 0).all()
        assert counts.std() / counts.mean() < 0.3

    def test_four_bit_one_hot(self, rng):
        vals = rand_kmers(DNAAlphabet4(), 12, 500, rng)
        for v in vals[:50]:
            k = Kmer.unsafe(DNAAlphabet4(), 12, int(v))
            assert all(s.iscertain for s in k)

    def test_aa_proteogenic(self, rng):
        vals = rand_kmers(AminoAcidAlphabet(), 8, 300, rng)
        allowed = set(int(c) for c in PROTEOGENIC_AA)
        for v in vals[:50]:
            k = Kmer.unsafe(AminoAcidAlphabet(), 8, int(v))
            assert all(k.extract_encoded_element(i) in allowed for i in range(8))

    def test_scalar(self, rng):
        k = rand_kmer(RNAAlphabet4(), 33 % 16, rng)  # K=1
        assert len(k) == 1
        k = rand_kmer(DNAAlphabet2(), 31, rng)
        assert len(k) == 31

    def test_k_zero(self, rng):
        assert rand_kmer(DNAAlphabet2(), 0, rng).value == 0

    def test_multiword_dna47(self, rng):
        # K*bps > 64: object-dtype big ints, uniform symbols
        # (/root/reference/ext/RandomExt.jl:37-50,87-101 samples any N)
        vals = rand_kmers(DNAAlphabet2(), 47, 400, rng)
        assert vals.dtype == object
        seen = collections.Counter()
        for v in vals:
            assert 0 <= int(v) < 1 << 94
            k = Kmer.unsafe(DNAAlphabet2(), 47, int(v))
            seen.update(str(s) for s in k)
        assert set(seen) == {"A", "C", "G", "T"}
        counts = np.array([seen[c] for c in "ACGT"], float)
        assert counts.std() / counts.mean() < 0.05

    def test_multiword_aa(self, rng):
        # 9 AAs = 72 bits > 64; also the reference's K=116 regime
        allowed = set(int(c) for c in PROTEOGENIC_AA)
        for K in (9, 116):
            vals = rand_kmers(AminoAcidAlphabet(), K, 60, rng)
            for v in vals[:20]:
                k = Kmer.unsafe(AminoAcidAlphabet(), K, int(v))
                assert len(k) == K
                assert all(
                    k.extract_encoded_element(i) in allowed for i in range(K)
                )

    def test_multiword_fourbit_one_hot(self, rng):
        vals = rand_kmers(DNAAlphabet4(), 21, 60, rng)  # 84 bits
        for v in vals[:20]:
            k = Kmer.unsafe(DNAAlphabet4(), 21, int(v))
            assert all(s.iscertain for s in k)

    def test_scalar_multiword(self, rng):
        k = rand_kmer(DNAAlphabet2(), 47, rng)
        assert len(k) == 47
        k = rand_kmer(AminoAcidAlphabet(), 116, rng)
        assert len(k) == 116

    def test_mw_limbs_layout(self, rng):
        # limb arrays are big-endian with zero padding atop limb 0
        from kmers_tpu.random import rand_kmers_mw

        seeds = np.random.default_rng(5)
        a = rand_kmers_mw(DNAAlphabet2(), 47, 30, seeds)  # 94 bits, M=3
        assert a.shape == (30, 3) and a.dtype == np.uint32
        assert (a[:, 0] >> 30 == 0).all()  # 2 pad bits zero
        b = rand_kmers_mw(DNAAlphabet2(), 47, 30, np.random.default_rng(5))
        vals = rand_kmers(DNAAlphabet2(), 47, 30, np.random.default_rng(5))
        np.testing.assert_array_equal(a, b)
        got = [
            (int(r[0]) << 64) | (int(r[1]) << 32) | int(r[2]) for r in a
        ]
        assert got == [int(v) for v in vals]

    def test_device_multiword(self):
        import jax

        from kmers_tpu.random import rand_kmers_device

        key = jax.random.PRNGKey(3)
        limbs = np.asarray(rand_kmers_device(key, DNAAlphabet2(), 47, 64))
        assert limbs.shape == (64, 3)
        assert (limbs[:, 0] >> 30 == 0).all()
        aa = np.asarray(rand_kmers_device(key, AminoAcidAlphabet(), 9, 64))
        assert aa.shape == (64, 3)  # 72 bits, M=3, 24 pad bits
        assert (aa[:, 0] >> 8 == 0).all()
        allowed = set(int(c) for c in PROTEOGENIC_AA)
        for r in aa[:10]:
            v = (int(r[0]) << 64) | (int(r[1]) << 32) | int(r[2])
            k = Kmer.unsafe(AminoAcidAlphabet(), 9, v)
            assert all(k.extract_encoded_element(i) in allowed for i in range(9))
        # (hi, lo) contract preserved at or below 64 bits
        hi, lo = rand_kmers_device(key, DNAAlphabet2(), 31, 16)
        assert np.asarray(hi).shape == (16,)
        assert (np.asarray(hi) >> 30 == 0).all()

    def test_rand_from_kmer(self, rng):
        # samples the kmer's positions, not the alphabet
        # (/root/reference/ext/RandomExt.jl:40-44)
        from kmers_tpu import mer, rand_from_kmer

        k = mer("ACCCC", "dna")
        seen = collections.Counter(
            str(rand_from_kmer(k, rng)) for _ in range(300)
        )
        assert set(seen) == {"A", "C"}
        assert seen["C"] > seen["A"]  # 4/5 of positions are C
        assert all(s in str(k) for s in seen)


class TestMinhash:
    def test_sketch_matches_oracle(self, rng):
        s = "".join("ACGT"[i] for i in rng.integers(0, 4, 5000))
        sk = minhash_sketch(s, K=16, s=100)
        oracle = sorted(
            {fx_hash(k) for k in CanonicalDNAMers(16, s)}
        )[:100]
        assert list(sk) == oracle

    def test_self_similarity(self, rng):
        s = "".join("ACGT"[i] for i in rng.integers(0, 4, 3000))
        a = minhash_sketch(s, K=16, s=200)
        assert jaccard(a, a) == 1.0

    def test_disjoint(self, rng):
        a = minhash_sketch(
            "".join("ACGT"[i] for i in rng.integers(0, 4, 3000)), K=16, s=100
        )
        b = minhash_sketch(
            "".join("ACGT"[i] for i in rng.integers(0, 4, 3000)), K=16, s=100
        )
        assert jaccard(a, b) < 0.05

    def test_pathological_duplication(self):
        # low-complexity input forces the widen-to-full fallback
        sk = minhash_sketch("ACGT" * 2000, K=8, s=16)
        oracle = sorted({fx_hash(k) for k in CanonicalDNAMers(8, "ACGT" * 2000)})
        assert list(sk) == oracle[:16]

    def test_short(self):
        assert minhash_sketch("ACG", K=16, s=10).size == 0

    def test_skip_ambiguous_drops_n_windows(self, rng):
        # ambiguous codes drop their windows under the default skip mode;
        # the sketch equals the sketch over the unambiguous sub-windows
        s = "".join("ACGTNACGT"[i] for i in rng.integers(0, 9, 4000))
        sk = minhash_sketch(s, K=9, s=50)
        oracle = sorted(
            {fx_hash(canonical(k)) for k, _ in UnambiguousDNAMers(9, s)}
        )[:50]
        assert list(sk) == oracle

    def test_ambiguous_raises_when_not_skipping(self):
        with pytest.raises(EncodeError):
            minhash_sketch("ACGT" * 50 + "N" + "ACGT" * 50, K=9, s=10,
                           skip_ambiguous=False)

    def test_invalid_bytes_always_raise(self):
        # the LUT's 0xff error class raises even under skip_ambiguous —
        # same contract as canonical_count / minimizer_select
        # (cf. /root/reference/src/iterators/common.jl:22-32)
        bad = "ACGTACGTACGT" * 20 + "!!??" + "ACGTACGTACGT" * 20
        with pytest.raises(EncodeError):
            minhash_sketch(bad, K=9, s=10)
        with pytest.raises(EncodeError):
            minhash_sketch(bad, K=9, s=10, skip_ambiguous=False)

    def test_streaming_invalid_bytes_raise(self):
        from kmers_tpu.pipelines.minhash import StreamingSketcher

        sk = StreamingSketcher(K=9, s=10, chunk_size=1024)
        with pytest.raises(EncodeError):
            sk.update(("ACGT" * 100 + "X" + "ACGT" * 100).encode())

    def test_streaming_parity_multichunk(self, rng):
        # >= 3 chunks per update, windows spanning chunk boundaries
        from kmers_tpu.pipelines.minhash import StreamingSketcher

        s = "".join("ACGT"[i] for i in rng.integers(0, 4, 60000))
        want = minhash_sketch(s, K=16, s=300)
        sk = StreamingSketcher(K=16, s=300, chunk_size=16384)
        sk.update(s.encode())
        got = sk.finalize()
        assert sk.bases_seen == 60000
        np.testing.assert_array_equal(got, want)

    def test_streaming_parity_record_batches(self, rng):
        # many update() calls with record offsets == one-shot sketch of
        # the N-joined concatenation
        from kmers_tpu.pipelines.canonical_count import join_records_with_n
        from kmers_tpu.pipelines.minhash import StreamingSketcher

        recs = [
            "".join("ACGT"[i] for i in rng.integers(0, 4, n))
            for n in (900, 40, 3000, 17)
        ]
        sk = StreamingSketcher(K=11, s=64, chunk_size=1024)
        joined_parts = []
        for r in recs:
            arr = np.frombuffer(r.encode(), np.uint8)
            off = np.array([0, arr.size], np.int64)
            sk.update(arr, off)
            joined_parts.append(r)
        want = minhash_sketch("N".join(joined_parts), K=11, s=64)
        # per-update joining is independent, so the merged sketch equals
        # the sketch of records joined by N in any grouping
        np.testing.assert_array_equal(sk.finalize(), want)

    def test_streaming_pathological_duplication(self):
        from kmers_tpu.pipelines.minhash import StreamingSketcher

        s = "ACGT" * 20000
        sk = StreamingSketcher(K=8, s=16, chunk_size=4096)
        sk.update(s.encode())
        np.testing.assert_array_equal(
            sk.finalize(), minhash_sketch(s, K=8, s=16)
        )

    def test_streaming_metrics(self, rng):
        from kmers_tpu.pipelines.minhash import StreamingSketcher
        from kmers_tpu.utils import Metrics

        m = Metrics()
        s = "".join("ACGT"[i] for i in rng.integers(0, 4, 5000))
        sk = StreamingSketcher(K=16, s=50, chunk_size=2048, metrics=m)
        sk.update(s.encode())
        out = sk.finalize()
        stats = m.batches[-1]
        assert stats.bases_in == 5000
        assert stats.windows_out == 5000 - 16 + 1
        assert stats.distinct_kmers == out.size == 50

    def test_sketch_fastx_stream(self, rng, tmp_path):
        from kmers_tpu.pipelines.minhash import sketch_fastx_stream

        seqs = [
            "".join("ACGT"[i] for i in rng.integers(0, 4, 2500))
            for _ in range(6)
        ]
        p = tmp_path / "reads.fa"
        p.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(seqs)))
        got = sketch_fastx_stream(p, K=14, s=100, batch_bytes=4096,
                                  chunk_size=2048)
        want = minhash_sketch("N".join(seqs), K=14, s=100)
        np.testing.assert_array_equal(got, want)

    def test_two_stage_selection_exact(self, rng):
        # exercise the two-stage top_k branch of _smallest_prefix directly
        # (end-to-end sketches on CPU-sized inputs stay in the one-stage
        # branch, which would leave the full-size path untested)
        import jax.numpy as jnp

        from kmers_tpu.pipelines.minhash import _smallest_prefix

        n, prefix = 1 << 20, 64
        hh = rng.integers(0, 1 << 32, n).astype(np.uint32)
        hl = rng.integers(0, 1 << 32, n).astype(np.uint32)
        fh, fl, boundary = (
            np.asarray(x)
            for x in _smallest_prefix(jnp.asarray(hh), jnp.asarray(hl), prefix)
        )
        assert fh.shape == (prefix,)
        full = hh.astype(np.uint64) << np.uint64(32) | hl.astype(np.uint64)
        got = np.sort(fh.astype(np.uint64) << np.uint64(32) | fl.astype(np.uint64))
        # soundness contract: everything strictly below `boundary` selected
        below = np.sort(full[(full >> np.uint64(32)) < np.uint64(boundary)])
        assert below.size > 0, "boundary should not be degenerate here"
        assert np.isin(below, got).all()
        # and with uniform hashes the selection equals the exact bottom-k
        exact = np.sort(full)[:prefix]
        if (int(exact[-1]) >> 32) < int(boundary):
            assert np.array_equal(got, exact)


class TestUtils:
    def test_metrics(self):
        m = Metrics()
        m.start_batch()
        m.end_batch(bases_in=100, windows_out=70, windows_skipped=2, distinct_kmers=50)
        summ = m.summary()
        assert summ["bases_in"] == 100 and summ["n_batches"] == 1
        assert "bases_per_sec" in summ

    def test_pipeline_emits_metrics(self, rng):
        # end-to-end: the counting pipeline populates BatchStats itself
        # (SURVEY.md §5 observability: bases in, windows skipped, distinct)
        from kmers_tpu.pipelines.canonical_count import (
            CountConfig,
            canonical_count_bytes,
        )

        seq = "ACGTN" * 300  # every window hits an N except none: K=3
        m = Metrics()
        kmers, counts = canonical_count_bytes(
            seq, CountConfig(K=3, chunk_size=512), metrics=m
        )
        assert len(m.batches) == 1
        b = m.batches[0]
        assert b.bases_in == 1500
        assert b.distinct_kmers == kmers.shape[0]
        assert b.windows_out == int(counts.sum())
        assert b.windows_skipped == (1500 - 3 + 1) - b.windows_out
        assert b.windows_skipped > 0  # the Ns skip real windows
        assert b.seconds > 0
        assert m.summary()["n_batches"] == 1

    def test_sharded_pipeline_emits_metrics(self, rng):
        from kmers_tpu.parallel import (
            ShardedCountConfig,
            data_mesh,
            sharded_canonical_count,
        )

        seq = "".join("ACGTN"[i] for i in rng.integers(0, 5, 2000))
        m = Metrics()
        kmers, counts = sharded_canonical_count(
            seq, ShardedCountConfig(K=7), data_mesh(1), metrics=m
        )
        b = m.batches[0]
        assert b.bases_in == 2000
        assert b.windows_out == int(counts.sum())
        assert b.distinct_kmers == kmers.shape[0]

    def test_checkpoint_roundtrip(self, tmp_path, rng):
        k1 = np.sort(rng.integers(0, 2**62, 100, dtype=np.uint64))
        c1 = rng.integers(1, 10, 100).astype(np.int64)
        k2 = np.sort(rng.integers(0, 2**62, 50, dtype=np.uint64))
        c2 = rng.integers(1, 10, 50).astype(np.int64)
        save_count_table(tmp_path, k1, c1, K=31, partition=0, n_partitions=2)
        save_count_table(tmp_path, k2, c2, K=31, partition=1, n_partitions=2)
        kmers, counts, K = load_count_table(tmp_path)
        assert K == 31
        want = collections.Counter()
        for k, c in zip(k1.tolist(), c1.tolist()):
            want[k] += c
        for k, c in zip(k2.tolist(), c2.tolist()):
            want[k] += c
        assert dict(zip(kmers.tolist(), counts.tolist())) == dict(want)
        assert np.array_equal(np.sort(kmers), kmers)

    def test_checkpoint_roundtrip_multiword_k47(self, tmp_path):
        # K=47 tables are object arrays of >64-bit Python ints; they
        # checkpoint as fixed-width limb arrays (VERDICT round 2 weak #6)
        from kmers_tpu.pipelines import CountConfig, canonical_count_bytes

        rng = np.random.default_rng(7)
        seq = "".join("ACGT"[i] for i in rng.integers(0, 4, 600))
        kmers, counts = canonical_count_bytes(seq, CountConfig(K=47))
        assert kmers.dtype == object and int(max(kmers)) >= 2**64
        save_count_table(tmp_path, kmers, counts, K=47)
        k2, c2, K = load_count_table(tmp_path)
        assert K == 47
        assert [int(v) for v in k2] == [int(v) for v in kmers]
        assert np.array_equal(c2, counts)

    def test_checkpoint_input_manifest(self, tmp_path):
        # per-shard input provenance for deterministic reruns
        # (SURVEY.md §5 failure-model row; VERDICT round 2 missing #5)
        import hashlib
        import json

        src = tmp_path / "reads.fa"
        src.write_bytes(b">r1\nACGTACGT\n")
        k = np.array([3, 9], np.uint64)
        c = np.array([2, 1], np.int64)
        save_count_table(tmp_path / "ckpt", k, c, K=31, inputs=[src])
        kmers, counts, K, manifest = load_count_table(
            tmp_path / "ckpt", return_manifest=True
        )
        (entry,) = manifest["inputs"]
        assert entry["path"] == str(src)
        assert entry["bytes"] == src.stat().st_size
        assert entry["sha256"] == hashlib.sha256(src.read_bytes()).hexdigest()


class TestModuleFunctions:
    def test_verbs(self):
        from kmers_tpu import (
            mer, translate, complement, reverse_complement, canonical,
            iscanonical, push, shift, pop, delete, CodonSet, reverse,
        )

        k = mer("TAGC", "d")
        assert str(complement(k)) == "ATCG"
        assert str(reverse(k)) == "CGAT"
        assert reverse_complement(k) == k.reverse_complement()
        assert canonical(k) == k.canonical()
        assert iscanonical(canonical(k))
        assert str(push(k, "A")) == "TAGCA"
        assert str(shift(k, "A")) == "AGCA"
        assert str(pop(k)) == "TAG"
        assert str(translate(mer("AUGCCG", "r"))) == "MP"
        cs = CodonSet([mer("UAG", "r"), mer("GGA", "r")])
        assert set(delete(cs, mer("UAG", "r"))) == {mer("GGA", "r")}


class TestBatchedRevtrans:
    def test_parity(self, rng):
        import numpy as np
        from kmers_tpu import AAKmer, reverse_translate
        from kmers_tpu.ops import reverse_translate_codes, u64

        s = "ARNDCQEGHILKMFPSTWYVOUBJZX*"
        codes = np.array([AAKmer(c).value for c in s], dtype=np.uint8)
        hi, lo = reverse_translate_codes(codes)
        masks = u64.to_numpy((hi, lo))
        want = [reverse_translate(c).x for c in s]
        assert [int(m) for m in masks] == want

    def test_gap_raises(self):
        import numpy as np
        import pytest as pt
        from kmers_tpu.ops import reverse_translate_codes

        with pt.raises(ValueError):
            reverse_translate_codes(np.array([27], dtype=np.uint8))


class TestDeviceRandom:
    def test_device_sampling(self, rng):
        import jax
        import numpy as np
        from kmers_tpu import AminoAcidAlphabet, DNAAlphabet2, DNAAlphabet4, Kmer
        from kmers_tpu.random import PROTEOGENIC_AA, rand_kmers_device
        from kmers_tpu.ops import u64

        key = jax.random.PRNGKey(0)
        hi, lo = rand_kmers_device(key, DNAAlphabet2(), 31, 500)
        vals = u64.to_numpy((hi, lo))
        assert (vals < (1 << 62)).all()
        assert len(set(vals.tolist())) > 490  # essentially all distinct

        hi, lo = rand_kmers_device(key, DNAAlphabet4(), 12, 100)
        for v in u64.to_numpy((hi, lo))[:20]:
            k = Kmer.unsafe(DNAAlphabet4(), 12, int(v))
            assert all(s.iscertain for s in k)

        hi, lo = rand_kmers_device(key, AminoAcidAlphabet(), 7, 100)
        allowed = set(int(c) for c in PROTEOGENIC_AA)
        for v in u64.to_numpy((hi, lo))[:20]:
            k = Kmer.unsafe(AminoAcidAlphabet(), 7, int(v))
            assert all(k.extract_encoded_element(i) in allowed for i in range(7))

        # small K path (bits <= 32)
        hi, lo = rand_kmers_device(key, DNAAlphabet2(), 9, 50)
        assert (np.asarray(hi) == 0).all()
        assert (np.asarray(lo) < (1 << 18)).all()


class TestSeqCanonical:
    def test_canonical(self, rng):
        from kmers_tpu import Seq, DNAAlphabet2, DNAKmer, canonical, iscanonical

        for _ in range(10):
            s = "".join("ACGT"[i] for i in rng.integers(0, 4, 23))
            seq = Seq(DNAAlphabet2(), s)
            want = DNAKmer(s).canonical()
            assert str(canonical(seq)) == str(want)
            assert iscanonical(canonical(seq))


class TestPickling:
    def test_roundtrip(self, rng):
        import pickle
        from kmers_tpu import AAKmer, CodonSet, DNAAlphabet4, Seq, mer, AminoAcid

        for obj in [
            mer("TAGCTA", "d"),
            AAKmer("KWPQHVY"),
            Seq(DNAAlphabet4(), "TAGWN-"),
            CodonSet([mer("UAG", "r"), mer("GGA", "r")]),
            AminoAcid.W,
        ]:
            assert pickle.loads(pickle.dumps(obj)) == obj


def test_profile_step_reports_event_times():
    import jax.numpy as jnp
    import numpy as np

    from kmers_tpu.pipelines.canonical_count import _chunk_count
    from kmers_tpu.utils import profile_step

    data = jnp.asarray(
        np.frombuffer(b"ACGT", np.uint8)[
            np.random.default_rng(0).integers(0, 4, 1 << 12)
        ]
    )

    def step():
        out = _chunk_count(data, 15)
        int(np.asarray(out[3]))

    top = profile_step(step, reps=1, top=5)
    assert top, "no trace events captured"
    assert all(isinstance(n, str) and ms >= 0 for n, ms in top)
    # ordered by total duration
    assert [ms for _, ms in top] == sorted(
        (ms for _, ms in top), reverse=True
    )
