"""chip_smoke.py off the card: it refuses to run without a GPU or
without the repository, and its phases run at a tiny size on the CPU."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_exits_nonzero_without_a_gpu():
    proc = _run(REPO, REPO / "chip_smoke.py")
    assert proc.returncode != 0
    assert "no GPU found" in proc.stderr + proc.stdout
    assert '"ok"' not in proc.stdout


def test_exits_nonzero_without_the_repository(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run(tmp_path, tmp_path / "chip_smoke.py")
    assert proc.returncode != 0 and '"ok"' not in proc.stdout


def test_kernel_and_sort_phases_tiny():
    import chip_smoke as cs

    rng = np.random.default_rng(0)
    rows = cs.phase_kernels(rng, lengths=(200, 600), batches=(3, 6), gold_reads=3, runs=1)
    assert len(rows) == 4 and all(r["exact_vs_jnp"] and r["exact_vs_numpy"] for r in rows)
    sorts = cs.phase_sorts(rng, B=8, runs=1)
    assert all(r["exact"] for r in sorts)


def test_main_path_phases_tiny(tmp_path, monkeypatch):
    """Build, CLI main path, CPU reference and steady state at a tiny
    size (the device build path forced on the CPU backend)."""
    import chip_smoke as cs
    from monica_tpu.align import runtime as rt
    from monica_tpu.evaluation import zymo_community

    monkeypatch.setenv("MONICA_TPU_DEVICE_BUILD", "1")
    rng = np.random.default_rng(1)
    seqs = zymo_community(rng, scale=0.004)
    built = cs.phase_build(seqs)["built"]
    lengths = cs.read_lengths(rng, 40, max_len=3000)
    samples = {name: cs.simulate_sample(rng, seqs, lengths, prof) for name, prof in cs.SAMPLES}
    assert all(len(r) == n for reads, _ in samples.values() for r, n in zip(reads, lengths))
    world = cs.write_world(tmp_path / "world", seqs, cs.ZYMO)
    cs.phase_main(tmp_path, world, samples, list(cs.ZYMO))
    clf = rt.Classifier(built, count_mode="matching")
    ref = cs.phase_reference(clf, samples, per_bucket=2)
    assert ref["rows"] == ref["identical"]
    steady = cs.phase_steady(clf, tmp_path, samples)
    assert steady["compiles"] == 0 and steady["reads"] == 3 * len(lengths)
