"""Multi-host correctness on CPU: a real 2-process jax.distributed run
(VERDICT r2 item 3 / BASELINE "linear to N hosts" axis).

Each subprocess owns 4 virtual CPU devices; the global (data=4,
index=2) mesh spans both; each process feeds its local rows per the
host-batch contract (parallel/mesh.py: shard_reads) and the replicated
psum count vector must equal the single-device golden on BOTH hosts.
"""

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.timeout(300)
def test_two_process_distributed_step(tmp_path):
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    worker = str(REPO / "tests" / "multihost_worker.py")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), "2", f"127.0.0.1:{port}", str(tmp_path)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in (0, 1)
    ]
    deadline = time.time() + 240
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=max(deadline - time.time(), 1))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
    # both processes computed (and agreed on) the same global counts
    c0 = (tmp_path / "ok_0").read_text()
    c1 = (tmp_path / "ok_1").read_text()
    assert c0 == c1 and c0


@pytest.mark.timeout(300)
def test_two_process_product_run_once(tmp_path):
    """The PRODUCT surface under jax.distributed (VERDICT r3 item 1):
    rt.Classifier + rt.run_once in both processes, each host routing
    its own (different) sample files, with per-sample counts and
    routed FASTQs equal to a single-device golden."""
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    worker = str(REPO / "tests" / "multihost_product_worker.py")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), "2", f"127.0.0.1:{port}", str(tmp_path)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in (0, 1)
    ]
    deadline = time.time() + 240
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=max(deadline - time.time(), 1))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
    ok0 = (tmp_path / "ok_0").read_text()
    ok1 = (tmp_path / "ok_1").read_text()
    # per-host tables cover each host's own samples (union = global)
    assert "alpha:" in ok0 and "beta:" in ok0
    assert "gamma:" in ok1


@pytest.mark.timeout(300)
def test_two_process_watch_synchronized_exit(tmp_path):
    """watch() under jax.distributed: a feeder drops a late batch on
    host 0 only; the synchronized idle counter must make BOTH hosts
    keep polling through it and then exit together (without the sync,
    host 1 would hit max_idle_polls first and leave host 0 hung on a
    collective)."""
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    worker = str(REPO / "tests" / "multihost_watch_worker.py")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), "2", f"127.0.0.1:{port}", str(tmp_path)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in (0, 1)
    ]
    deadline = time.time() + 240
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=max(deadline - time.time(), 1))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
    assert (tmp_path / "watch_ok_0").read_text() == "h0b1,h0b2"
    assert (tmp_path / "watch_ok_1").read_text() == "h1b1"


@pytest.mark.timeout(300)
def test_two_process_schedule_overflow_raises_on_both(tmp_path):
    """ADVICE r4 item 2: a host whose sample overflows the lockstep
    plan must NOT raise before the allgather (its peer would hang in
    the collective) — both processes gather the overflow flag and then
    raise the same error together."""
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    worker = str(REPO / "tests" / "multihost_overflow_worker.py")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), "2", f"127.0.0.1:{port}",
             str(tmp_path)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in (0, 1)
    ]
    deadline = time.time() + 240
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=max(deadline - time.time(), 1))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
    # BOTH processes raised the synchronized error (incl. the one whose
    # own sample fit the plan)
    assert (tmp_path / "raised_0").exists()
    assert (tmp_path / "raised_1").exists()
