"""Multi-device plane on the virtual 8-device CPU mesh (SURVEY.md §4):
sharded counting must be bit-identical to the single-chip pipeline and
the scalar oracle for any device count."""

import collections

import numpy as np
import pytest

import jax

from kmers_tpu import UnambiguousDNAMers
from kmers_tpu.parallel import (
    ShardedCountConfig,
    data_mesh,
    sharded_canonical_count,
)
from kmers_tpu.pipelines import canonical_count


def rand_dna(rng, n, chars="ACGTN"):
    return "".join(chars[i] for i in rng.integers(0, len(chars), n))


@pytest.fixture(scope="module")
def sample(request):
    rng = np.random.default_rng(123)
    return rand_dna(rng, 20000)


class TestShardedCount:
    @pytest.mark.parametrize("n_dev", [1, 2, 3, 5, 8])
    def test_parity_across_device_counts(self, sample, n_dev):
        mesh = data_mesh(n_dev)
        k, c = sharded_canonical_count(sample, ShardedCountConfig(K=31), mesh)
        k1, c1 = canonical_count(sample, K=31)
        assert np.array_equal(k, k1) and np.array_equal(c, c1)

    def test_vs_scalar_oracle(self, sample):
        mesh = data_mesh(8)
        K = 15
        k, c = sharded_canonical_count(sample, ShardedCountConfig(K=K), mesh)
        oracle = collections.Counter(
            x.canonical().value for x, _ in UnambiguousDNAMers(K, sample)
        )
        assert dict(zip(k.tolist(), c.tolist())) == {
            int(x): v for x, v in oracle.items()
        }

    def test_boundary_windows(self):
        # shard boundaries must neither lose nor duplicate windows: a
        # repeated motif spanning every boundary
        s = "ACGTACGTA" * 2000
        mesh = data_mesh(8)
        K = 9
        k, c = sharded_canonical_count(s, ShardedCountConfig(K=K), mesh)
        k1, c1 = canonical_count(s, K=K)
        assert np.array_equal(k, k1) and np.array_equal(c, c1)
        assert c.sum() == len(s) - K + 1

    def test_short_input(self):
        mesh = data_mesh(8)
        k, c = sharded_canonical_count("ACG", ShardedCountConfig(K=31), mesh)
        assert k.size == 0

    @pytest.mark.parametrize("n_dev", [1, 3, 8])
    def test_streamed_parity(self, sample, n_dev):
        # slabs span >= 3 chunks per device: the streamed level-stack
        # path (chunked local counts + single final exchange) must be
        # bit-identical to the single-dispatch path (VERDICT round 2 #4)
        mesh = data_mesh(n_dev)
        shard = -(-len(sample) // n_dev)
        chunk = max(shard // 4, 31)  # >= 4 chunks per device
        cfg = ShardedCountConfig(K=31, chunk_size=chunk)
        assert -(-shard // chunk) >= 3
        k, c = sharded_canonical_count(sample, cfg, mesh)
        k1, c1 = canonical_count(sample, K=31)
        assert np.array_equal(k, k1) and np.array_equal(c, c1)

    def test_streamed_boundary_windows(self):
        # chunk boundaries must neither lose nor duplicate windows
        s = "ACGTACGTA" * 2000
        mesh = data_mesh(4)
        K = 9
        cfg = ShardedCountConfig(K=K, chunk_size=997)  # odd, many chunks
        k, c = sharded_canonical_count(s, cfg, mesh)
        k1, c1 = canonical_count(s, K=K)
        assert np.array_equal(k, k1) and np.array_equal(c, c1)
        assert c.sum() == len(s) - K + 1

    def test_streamed_small_chunk_parity(self, sample):
        # streamed with several 600-base chunks per device on 3 devices
        mesh = data_mesh(3)
        cfg = ShardedCountConfig(K=31, chunk_size=600)
        k, c = sharded_canonical_count(sample[:6000], cfg, mesh)
        k1, c1 = canonical_count(sample[:6000], K=31)
        assert np.array_equal(k, k1) and np.array_equal(c, c1)

    def test_invalid_raises(self):
        from kmers_tpu import EncodeError

        mesh = data_mesh(4)
        with pytest.raises(EncodeError):
            sharded_canonical_count(
                "ACGT!" + "ACGT" * 100, ShardedCountConfig(K=5), mesh
            )

    def test_low_complexity_no_overflow(self):
        # local dedup makes bucket load proportional to distinct kmers:
        # a poly-A chromosome (1 distinct canonical kmer) must count fine
        # even with a tiny bucket factor
        s = "A" * 4000
        mesh = data_mesh(8)
        k, c = sharded_canonical_count(
            s, ShardedCountConfig(K=31, bucket_factor=0.3), mesh
        )
        assert list(k) == [0] and list(c) == [4000 - 31 + 1]

    def test_overflow_detection(self):
        # high-entropy input with a bucket factor far below the distinct
        # load must fail loudly, never drop kmers silently
        rng = np.random.default_rng(5)
        s = rand_dna(rng, 20000, "ACGT")  # every window valid and distinct-ish
        mesh = data_mesh(8)
        with pytest.raises(RuntimeError):
            sharded_canonical_count(
                s, ShardedCountConfig(K=31, bucket_factor=0.01), mesh
            )


class TestGraftEntry:
    def test_entry_compiles(self):
        import sys, pathlib

        sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
        import __graft_entry__ as ge

        fn, args = ge.entry()
        out = jax.jit(fn)(*args)
        assert int(np.asarray(out[3])) > 0

    def test_dryrun_multichip(self):
        import __graft_entry__ as ge

        ge.dryrun_multichip(8)


class TestSixFrame:
    @staticmethod
    def _oracle(s, K):
        import collections
        from kmers_tpu import DNAKmer

        counts = collections.Counter()
        # both strands, with N preserved for validity checking
        comp = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N"}
        strands = [s, "".join(comp[c] for c in reversed(s))]
        for strand in strands:
            for f in range(3):
                sub = strand[f:]
                n_aa = len(sub) // 3
                for j in range(n_aa - K + 1):
                    window = sub[3 * j : 3 * (j + K)]
                    if "N" in window:
                        continue
                    aa = DNAKmer(window).translate()
                    counts[aa.value] += 1
        return counts

    @pytest.mark.parametrize("n_dev", [1, 3, 8])
    def test_parity(self, n_dev):
        from kmers_tpu.parallel.sixframe import (
            SixFrameCountConfig,
            sharded_sixframe_aa_count,
        )

        rng = np.random.default_rng(77)
        s = "".join("ACGTN"[i] for i in rng.integers(0, 5, 2000))
        K = 5
        mesh = data_mesh(n_dev)
        kmers, counts = sharded_sixframe_aa_count(
            s, SixFrameCountConfig(K=K), mesh
        )
        oracle = self._oracle(s, K)
        assert dict(zip(kmers.tolist(), counts.tolist())) == {
            int(k): v for k, v in oracle.items()
        }

    @pytest.mark.parametrize("n_dev", [1, 3, 8])
    def test_multilimb_k15_parity(self, n_dev):
        # K > 7 amino acids: multi-limb registers through the exchange
        # (the reference's multi-word AA kmers at mesh scale)
        from kmers_tpu.parallel.sixframe import (
            SixFrameCountConfig,
            sharded_sixframe_aa_count,
        )

        rng = np.random.default_rng(13)
        s = "".join("ACGTN"[i] for i in rng.integers(0, 5, 1200))
        K = 15
        kmers, counts = sharded_sixframe_aa_count(
            s, SixFrameCountConfig(K=K), data_mesh(n_dev)
        )
        oracle = self._oracle(s, K)
        assert dict(
            zip([int(k) for k in kmers], counts.tolist())
        ) == {int(k): v for k, v in oracle.items()}
        vals = [int(k) for k in kmers]
        assert vals == sorted(vals)

    def test_total_window_count(self):
        from kmers_tpu.parallel.sixframe import (
            SixFrameCountConfig,
            sharded_sixframe_aa_count,
        )

        rng = np.random.default_rng(3)
        s = "".join("ACGT"[i] for i in rng.integers(0, 4, 999))
        K = 4
        mesh = data_mesh(4)
        _, counts = sharded_sixframe_aa_count(s, SixFrameCountConfig(K=K), mesh)
        want = 2 * sum((len(s) - f) // 3 - K + 1 for f in range(3))
        assert counts.sum() == want

    @pytest.mark.parametrize("n_dev", [1, 4])
    def test_multilimb_streamed_multichunk_parity(self, n_dev):
        # K > 7 (multi-limb) through the streamed level-stack path,
        # >= 3 chunks per device, vs big-chunk and the scalar oracle
        from kmers_tpu.parallel.sixframe import (
            SixFrameCountConfig,
            sharded_sixframe_aa_count,
        )
        from kmers_tpu.utils import checked

        rng = np.random.default_rng(41)
        s = "".join("ACGTN"[i] for i in rng.integers(0, 5, 8000))
        K = 11
        big = sharded_sixframe_aa_count(
            s, SixFrameCountConfig(K=K), data_mesh(n_dev)
        )
        with checked():
            small = sharded_sixframe_aa_count(
                s, SixFrameCountConfig(K=K, chunk_size=600), data_mesh(n_dev)
            )
        assert [int(k) for k in big[0]] == [int(k) for k in small[0]]
        assert np.array_equal(big[1], small[1])
        oracle = self._oracle(s, K)
        assert dict(
            zip([int(k) for k in small[0]], small[1].tolist())
        ) == {int(k): v for k, v in oracle.items()}

    # chunk_size 900: plain multi-chunk; 2035: rounds to B=2034 whose
    # 2(B+16)=4100 window stream overhangs 2^12 by 4, so the pow2 clamp
    # shaves B to 2031 — the sort-padding guard branch
    @pytest.mark.parametrize("n_dev,chunk", [(1, 900), (8, 900), (4, 2035)])
    def test_streamed_multichunk_parity(self, n_dev, chunk):
        # >= 3 chunks per device through the level-stack; chunk bodies
        # clip at the tail so halo data is never double-counted
        from kmers_tpu.parallel.sixframe import (
            SixFrameCountConfig,
            sharded_sixframe_aa_count,
        )

        rng = np.random.default_rng(21)
        s = "".join("ACGTN"[i] for i in rng.integers(0, 5, 24001))
        K = 5
        big = sharded_sixframe_aa_count(
            s, SixFrameCountConfig(K=K), data_mesh(n_dev)
        )
        small = sharded_sixframe_aa_count(
            s, SixFrameCountConfig(K=K, chunk_size=chunk), data_mesh(n_dev)
        )
        assert np.array_equal(big[0], small[0])
        assert np.array_equal(big[1], small[1])
        oracle = self._oracle(s, K)
        assert dict(zip(small[0].tolist(), small[1].tolist())) == {
            int(k): v for k, v in oracle.items()
        }

    @pytest.mark.parametrize("n_dev", [1, 4])
    def test_chunked_oracle_parity(self, n_dev):
        # 1200-base chunks stream through the level stack and match the
        # python oracle
        from kmers_tpu.parallel.sixframe import (
            SixFrameCountConfig,
            sharded_sixframe_aa_count,
        )

        rng = np.random.default_rng(31)
        s = "".join("ACGTN"[i] for i in rng.integers(0, 5, 5000))
        K = 5
        out = sharded_sixframe_aa_count(
            s, SixFrameCountConfig(K=K, chunk_size=1200), data_mesh(n_dev)
        )
        oracle = self._oracle(s, K)
        assert dict(zip(out[0].tolist(), out[1].tolist())) == {
            int(k): v for k, v in oracle.items()
        }

    @pytest.mark.parametrize("n_dev", [1, 3, 8])
    def test_default_config_oracle_parity(self, n_dev):
        from kmers_tpu.parallel.sixframe import (
            SixFrameCountConfig,
            sharded_sixframe_aa_count,
        )

        rng = np.random.default_rng(41)
        s = "".join("ACGTN"[i] for i in rng.integers(0, 5, 5000))
        K = 5
        out = sharded_sixframe_aa_count(
            s, SixFrameCountConfig(K=K), data_mesh(n_dev)
        )
        oracle = self._oracle(s, K)
        assert dict(zip(out[0].tolist(), out[1].tolist())) == {
            int(k): v for k, v in oracle.items()
        }

    @pytest.mark.parametrize("n_dev,K", [(1, 8), (1, 9), (3, 15)])
    def test_multilimb_oracle_parity(self, n_dev, K):
        # K > 7 amino acids on multi-limb registers.  K=8 is the
        # register-filling width (8K == 32M): the explicit validity
        # stream must drive sort_count_mw's flag-operand branch, where a
        # sentinel value could collide with a real all-ones window
        from kmers_tpu.parallel.sixframe import (
            SixFrameCountConfig,
            sharded_sixframe_aa_count,
        )

        rng = np.random.default_rng(47)
        s = "".join("ACGTN"[i] for i in rng.integers(0, 5, 1500))
        out = sharded_sixframe_aa_count(
            s, SixFrameCountConfig(K=K), data_mesh(n_dev)
        )
        oracle = self._oracle(s, K)
        assert dict(
            zip([int(k) for k in out[0]], out[1].tolist())
        ) == {int(k): v for k, v in oracle.items()}

    def test_config_rejects_out_of_range(self):
        from kmers_tpu.parallel.sixframe import SixFrameCountConfig

        with pytest.raises(ValueError):
            SixFrameCountConfig(K=33)
        with pytest.raises(ValueError):
            SixFrameCountConfig(K=7, chunk_size=41)

    def test_multichunk_stream(self):
        # device slabs of ~35k bases in 3000-base chunks stream through
        # the level stack (12 chunks per device) and match the
        # one-dispatch-per-device run
        from kmers_tpu.parallel.sixframe import (
            SixFrameCountConfig,
            sharded_sixframe_aa_count,
        )

        rng = np.random.default_rng(43)
        s = "".join("ACGTN"[i] for i in rng.integers(0, 5, 70000))
        K = 3
        mesh = data_mesh(2)
        one = sharded_sixframe_aa_count(
            s, SixFrameCountConfig(K=K, chunk_size=1 << 16), mesh
        )
        many = sharded_sixframe_aa_count(
            s, SixFrameCountConfig(K=K, chunk_size=3000), mesh
        )
        assert np.array_equal(one[0], many[0])
        assert np.array_equal(one[1], many[1])

    def test_metrics_windows_skipped_counts_ambiguity(self):
        # windows_skipped = ambiguity-invalidated windows (possible -
        # valid), not the always-zero valid-minus-counted difference
        from kmers_tpu.parallel.sixframe import (
            SixFrameCountConfig,
            sharded_sixframe_aa_count,
        )
        from kmers_tpu.utils import Metrics

        rng = np.random.default_rng(17)
        s = "".join("ACGTN"[i] for i in rng.integers(0, 5, 3000))
        K = 4
        m = Metrics()
        kmers, counts = sharded_sixframe_aa_count(
            s, SixFrameCountConfig(K=K), data_mesh(2), metrics=m
        )
        stats = m.batches[-1]
        n_possible = 2 * (len(s) - 3 * K + 1)
        assert stats.windows_out == int(counts.sum())
        assert stats.windows_skipped == n_possible - int(counts.sum())
        assert stats.windows_skipped > 0  # the Ns really skip windows

    def test_streamed_checked_and_metrics(self):
        from kmers_tpu.parallel.sixframe import (
            SixFrameCountConfig,
            sharded_sixframe_aa_count,
        )
        from kmers_tpu.utils import Metrics, checked

        rng = np.random.default_rng(9)
        s = "".join("ACGT"[i] for i in rng.integers(0, 4, 6000))
        m = Metrics()
        with checked():
            kmers, counts = sharded_sixframe_aa_count(
                s,
                SixFrameCountConfig(K=4, chunk_size=1500),
                data_mesh(4),
                metrics=m,
            )
        want = 2 * sum((len(s) - f) // 3 - 4 + 1 for f in range(3))
        assert counts.sum() == want
        stats = m.batches[-1]
        assert stats.bases_in == 6000
        assert stats.windows_out == want
        assert stats.distinct_kmers == kmers.size


class TestShardedMinimizers:
    @pytest.mark.parametrize("n_dev", [1, 3, 8])
    def test_parity_with_single_chip(self, n_dev):
        from kmers_tpu.parallel.minimizers import sharded_minimizer_select
        from kmers_tpu.pipelines import minimizer_select

        rng = np.random.default_rng(11)
        s = "".join("ACGT"[i] for i in rng.integers(0, 4, 3000))
        K, W = 15, 10
        vals1, pos1 = minimizer_select(s, K=K, W=W)
        mesh = data_mesh(n_dev)
        vals2, pos2 = sharded_minimizer_select(s, K=K, W=W, mesh=mesh)
        assert np.array_equal(pos1, pos2)
        assert np.array_equal(vals1, vals2)

    def test_ambiguity_raises(self):
        from kmers_tpu import EncodeError
        from kmers_tpu.parallel.minimizers import sharded_minimizer_select

        with pytest.raises(EncodeError):
            sharded_minimizer_select("ACGT" * 100 + "N" + "ACGT" * 100, mesh=data_mesh(4))

    @pytest.mark.parametrize("n_dev", [1, 3, 8])
    def test_skip_ambiguous_parity(self, n_dev):
        # N-containing reads select correctly instead of raising; sharded
        # output is bit-identical to the single-chip skip pipeline
        from kmers_tpu.parallel.minimizers import sharded_minimizer_select
        from kmers_tpu.pipelines import minimizer_select

        rng = np.random.default_rng(23)
        s = "".join("ACGTNACGT"[i] for i in rng.integers(0, 9, 2500))
        K, W = 15, 10
        vals1, pos1 = minimizer_select(s, K=K, W=W, skip_ambiguous=True)
        assert vals1.size > 0
        vals2, pos2 = sharded_minimizer_select(
            s, K=K, W=W, mesh=data_mesh(n_dev), skip_ambiguous=True
        )
        assert np.array_equal(pos1, pos2)
        assert np.array_equal(vals1, vals2)

    def test_skip_ambiguous_invalid_still_raises(self):
        from kmers_tpu import EncodeError
        from kmers_tpu.parallel.minimizers import sharded_minimizer_select

        with pytest.raises(EncodeError):
            sharded_minimizer_select(
                "ACGT" * 100 + "X" + "ACGT" * 100,
                mesh=data_mesh(2),
                skip_ambiguous=True,
            )

    def test_short(self):
        from kmers_tpu.parallel.minimizers import sharded_minimizer_select

        v, p = sharded_minimizer_select("ACGT", K=15, W=10, mesh=data_mesh(2))
        assert v.size == 0


class TestShardedMultiword:
    @pytest.mark.parametrize("n_dev,K", [(1, 33), (3, 47), (8, 63)])
    def test_parity_with_single_chip(self, n_dev, K):
        from kmers_tpu.parallel import sharded_canonical_count_mw
        from kmers_tpu.pipelines.canonical_count import (
            CountConfig,
            canonical_count_bytes,
        )

        rng = np.random.default_rng(42)
        s = rand_dna(rng, 5000)
        mesh = data_mesh(n_dev)
        k, c = sharded_canonical_count_mw(s, K=K, mesh=mesh)
        k1, c1 = canonical_count_bytes(s, CountConfig(K=K))
        assert [int(x) for x in k] == [int(x) for x in k1]
        assert np.array_equal(c, c1)

    def test_k32_allones_kmer(self):
        # K=32 fills the register exactly: the all-T kmer is the all-ones
        # value, which must not be confused with padding
        from kmers_tpu.parallel import sharded_canonical_count_mw

        s = "T" * 64 + "ACGTACGTACGTACGTACGTACGTACGTACGTAC"
        mesh = data_mesh(4)
        k, c = sharded_canonical_count_mw(s, K=32, mesh=mesh)
        allones = (1 << 64) - 1
        # canonical(all-T) = all-A = 0
        d = dict(zip([int(x) for x in k], c.tolist()))
        assert d[0] == 64 - 32 + 1
        assert allones not in d

    def test_vs_scalar_oracle(self):
        from kmers_tpu import UnambiguousDNAMers
        from kmers_tpu.parallel import sharded_canonical_count_mw

        rng = np.random.default_rng(9)
        s = rand_dna(rng, 2000)
        K = 41
        mesh = data_mesh(8)
        k, c = sharded_canonical_count_mw(s, K=K, mesh=mesh)
        oracle = collections.Counter(
            x.canonical().value for x, _ in UnambiguousDNAMers(K, s)
        )
        assert dict(zip([int(x) for x in k], c.tolist())) == {
            int(x): v for x, v in oracle.items()
        }

    def test_short_and_errors(self):
        from kmers_tpu import EncodeError
        from kmers_tpu.parallel import sharded_canonical_count_mw

        mesh = data_mesh(2)
        k, c = sharded_canonical_count_mw("ACG", K=33, mesh=mesh)
        assert k.size == 0
        with pytest.raises(ValueError):
            sharded_canonical_count_mw("ACGT" * 100, K=31, mesh=mesh)
        with pytest.raises(EncodeError):
            sharded_canonical_count_mw("ACGT!" * 100, K=33, mesh=mesh)


class TestShardedChunked:
    @pytest.mark.parametrize("n_dev", [1, 3])
    def test_streamed_matches_single_dispatch(self, sample, n_dev):
        # 1024-base chunks per device vs one dispatch per device
        mesh = data_mesh(n_dev)
        cfg = ShardedCountConfig(K=31, chunk_size=1024)
        k, c = sharded_canonical_count(sample[:6000], cfg, mesh)
        k1, c1 = sharded_canonical_count(
            sample[:6000], ShardedCountConfig(K=31), mesh
        )
        assert np.array_equal(k, k1) and np.array_equal(c, c1)
