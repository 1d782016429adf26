"""Checked mode: unsafe-surface preconditions become loud errors.

The reference's ``Unsafe`` trait (/root/reference/src/Kmers.jl:103-110)
documents but never validates safety obligations; checked mode
(KMERS_TPU_CHECKED=1) validates them — SURVEY.md §5 "race detection /
sanitizers".
"""

import numpy as np
import pytest

from kmers_tpu import DNAAlphabet2, unsafe_extract, unsafe_shift_from, mer
from kmers_tpu.construction import AsciiEncode, recoding_scheme
from kmers_tpu.utils import checked, checked_mode, set_checked


class TestScalarBounds:
    def test_extract_oob_caught(self):
        src = b"TAGCTAGA"
        scheme = AsciiEncode()
        with checked():
            # planted out-of-bounds: negative start (silently wraps in
            # Python when unchecked) and window past the end
            with pytest.raises(IndexError, match="checked mode"):
                unsafe_extract(scheme, DNAAlphabet2(), 4, src, -1)
            with pytest.raises(IndexError, match="checked mode"):
                unsafe_extract(scheme, DNAAlphabet2(), 4, src, 6)
            # in-bounds still works
            assert str(unsafe_extract(scheme, DNAAlphabet2(), 4, src, 1)) == "AGCT"
        # unchecked: the negative index wraps silently (the quiet bug)
        k = unsafe_extract(scheme, DNAAlphabet2(), 4, src, -1)
        assert str(k) == "ATAG"  # wrapped read, not an error

    def test_shift_from_oob_caught(self):
        k = mer("TAGC", "d")
        scheme = AsciiEncode()
        with checked():
            with pytest.raises(IndexError, match="checked mode"):
                unsafe_shift_from(scheme, k, b"ACGT", 3, 2)

    def test_seq_source(self):
        from kmers_tpu import Seq, DNAAlphabet4

        s = Seq(DNAAlphabet4(), "TGCA")
        scheme = recoding_scheme(DNAAlphabet2(), s)
        with checked():
            with pytest.raises(IndexError, match="checked mode"):
                unsafe_extract(scheme, DNAAlphabet2(), 3, s, 2)


class TestArrayPlane:
    def test_window_u64_short_stream_caught(self):
        import jax.numpy as jnp

        from kmers_tpu.ops.windows import window_u64

        words = jnp.zeros(3, jnp.uint32)  # 2 real words, no carry pad
        with checked():
            with pytest.raises(IndexError, match="checked mode"):
                window_u64(words, L=32, K=5, bps=2)

    def test_pipeline_conservation_clean(self, rng):
        from kmers_tpu.pipelines.canonical_count import (
            CountConfig,
            canonical_count_bytes,
        )

        seq = "".join("ACGTN"[i] for i in rng.integers(0, 5, 3000))
        cfg = CountConfig(K=9, chunk_size=1024)
        k0, c0 = canonical_count_bytes(seq, cfg)
        with checked():
            k1, c1 = canonical_count_bytes(seq, cfg)
        assert np.array_equal(k0, k1) and np.array_equal(c0, c1)

    def test_conservation_violation_detected(self):
        # plant a sentinel collision: a "valid" all-ones register is
        # silently dropped by the counter — checked mode's conservation
        # invariant (n_valid == n_counted) is exactly what catches it
        import jax.numpy as jnp

        from kmers_tpu.ops.count import SENTINEL, sort_count

        hi = jnp.asarray([1, SENTINEL, 2], jnp.uint32)
        lo = jnp.asarray([5, SENTINEL, 6], jnp.uint32)
        valid = jnp.asarray([True, True, True])
        uh, ul, cnt, nu = sort_count(hi, lo, valid)
        assert int(jnp.sum(cnt)) != int(jnp.sum(valid))  # the quiet drop


class TestShardedPlane:
    """Checked mode reaching the SPMD plane (VERDICT r3 item 7)."""

    def test_sharded_conservation_clean(self, rng):
        from kmers_tpu.parallel import (
            ShardedCountConfig,
            data_mesh,
            sharded_canonical_count,
        )

        seq = "".join("ACGTN"[i] for i in rng.integers(0, 5, 12000))
        mesh = data_mesh(4)
        cfg = ShardedCountConfig(K=11)
        k0, c0 = sharded_canonical_count(seq, cfg, mesh)
        with checked():
            k1, c1 = sharded_canonical_count(seq, cfg, mesh)
        assert np.array_equal(k0, k1) and np.array_equal(c0, c1)

    def test_streamed_sharded_conservation_clean(self, rng):
        from kmers_tpu.parallel import (
            ShardedCountConfig,
            data_mesh,
            sharded_canonical_count,
        )

        seq = "".join("ACGTN"[i] for i in rng.integers(0, 5, 40000))
        mesh = data_mesh(4)
        # >= 3 chunks per device
        cfg = ShardedCountConfig(K=11, chunk_size=4096)
        k0, c0 = sharded_canonical_count(seq, cfg, mesh)
        with checked():
            k1, c1 = sharded_canonical_count(seq, cfg, mesh)
        assert np.array_equal(k0, k1) and np.array_equal(c0, c1)

    def test_sharded_violation_detected(self, rng, monkeypatch):
        # poison the exchange so counts are lost: checked mode's
        # end-to-end conservation assert must trip
        from kmers_tpu.parallel import (
            ShardedCountConfig,
            data_mesh,
            sharded_canonical_count,
        )
        from kmers_tpu.parallel import pipeline as pl

        real = pl.exchange_and_merge

        def poisoned(uh, ul, cnt, n_dev, cap, axis):
            uh2, ul2, cnt2, nu, overflow = real(uh, ul, cnt, n_dev, cap, axis)
            import jax.numpy as jnp

            # silently drop one count on every device
            cnt2 = jnp.where(
                jnp.arange(cnt2.shape[0]) == 0,
                jnp.maximum(cnt2 - 1, 0),
                cnt2,
            )
            return uh2, ul2, cnt2, nu, overflow

        monkeypatch.setattr(pl, "exchange_and_merge", poisoned)
        seq = "".join("ACGT"[i] for i in rng.integers(0, 4, 9000))
        mesh = data_mesh(2)
        cfg = ShardedCountConfig(K=13)
        with checked():
            with pytest.raises(RuntimeError, match="conservation"):
                sharded_canonical_count(seq, cfg, mesh)


class TestFlagPlumbing:
    def test_env_default_off(self):
        assert not checked_mode()

    def test_set_and_restore(self):
        set_checked(True)
        assert checked_mode()
        set_checked(False)
        assert not checked_mode()
        with checked():
            assert checked_mode()
            with checked(False):
                assert not checked_mode()
            assert checked_mode()
        assert not checked_mode()
