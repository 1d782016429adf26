"""chip_smoke.py on the CPU: its numpy reference against the scalar
oracle, each phase at a small size, and its refusals (no GPU, no
checkout around it)."""

import collections
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs
import kmers_tpu as kt


@pytest.mark.parametrize("K", [1, 5, 16, 31, 32, 33, 47, 63])
def test_reference_vs_scalar_oracle(K):
    seq, offsets = cs.make_genome(3000, 3, K)
    want = collections.Counter()
    for i in range(offsets.size - 1):
        rec = seq[offsets[i] : offsets[i + 1]].tobytes().decode()
        for k, _ in kt.UnambiguousDNAMers(K, rec):
            want[k.canonical().value] += 1
    ref = cs.reference_counts(seq, offsets, K)
    if K <= 32:
        got = dict(zip(map(int, ref[0]), map(int, ref[1])))
        assert list(ref[0]) == sorted(ref[0])
    else:
        got = {(int(h) << 64) | int(lo): int(c) for h, lo, c in zip(*ref)}
        keys = [(int(h) << 64) | int(lo) for h, lo in zip(ref[0], ref[1])]
        assert keys == sorted(keys)
        assert cs.same_table(cs.split_wide(keys), ref[:2])
    assert got == dict(want)


def test_genome_fasta_round_trip(tmp_path):
    from kmers_tpu.io import read_fastx

    seq, offsets = cs.make_genome(10_000, 4, 9)
    assert offsets[0] == 0 and offsets[-1] == seq.size and offsets.size == 5
    assert np.isin(seq, list(b"Nn")).any() and (seq >= ord("a")).any()
    path = str(tmp_path / "g.fa")
    cs.write_fasta(path, seq, offsets, width=60)
    got_seq, got_off = read_fastx(path)
    assert np.array_equal(np.asarray(got_seq), seq)
    assert np.array_equal(np.asarray(got_off), offsets)
    assert cs.joined(seq, offsets).count(b"N") >= offsets.size - 2


def test_phase_genome_small(tmp_path):
    cs.phase_genome(n_bases=1 << 15, n_records=4, seed=1, tmpdir=str(tmp_path))


def test_phase_k47_small():
    cs.phase_k47(n_bases=1 << 14)


def test_phase_pipelines_small():
    cs.phase_pipelines(n=1 << 12, n_six=1 << 11)


def test_phase_multi_small():
    cs.phase_multi(n_bases=1 << 15, n_six=1 << 12, n47=1 << 13, n_dev=4)


def test_check_raises():
    with pytest.raises(cs.SmokeFailure):
        cs.check(False, "differs")


def test_refuses_cpu(capsys):
    with pytest.raises(SystemExit) as e:
        cs.main([])
    assert e.value.code not in (0, None)
    assert '"ok": true' not in capsys.readouterr().out


def test_fails_outside_a_checkout(tmp_path):
    shutil.copy(cs.__file__, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
