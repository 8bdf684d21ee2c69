"""Multi-process distributed runtime tests (SURVEY.md §5 failure
detection: "fault injection = dropping a host in multi-process tests").

Two real OS processes bootstrap through parallel.multihost.initialize on
localhost (CPU backend, 1 device each), run cross-process psum steps, and
checkpoint progress. The fault run kills process 1 mid-loop and asserts the
survivor stops making progress (collective stall/error = the failure
signal); the recovery run restarts both processes from the checkpoint and
asserts completion. This exercises jax.distributed bootstrap, a real
cross-process collective, the detection signal, and checkpoint-restart as
the recovery unit.
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import os, sys, time
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")

addr, pid, steps, ckpt, fault_step = (
    sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
    int(sys.argv[5]))

from visualslam.parallel import multihost

started = multihost.initialize(addr, num_processes=2, process_id=pid)
assert started, "multi-process init did not start"
assert jax.process_count() == 2
assert multihost.is_coordinator() == (pid == 0)

import jax.numpy as jnp

f = jax.pmap(lambda x: jax.lax.psum(x, "i"), axis_name="i")

start = 0
if os.path.exists(ckpt):
    start = int(np.load(ckpt)["step"]) + 1

for step in range(start, steps):
    y = f(jnp.ones((1, 4)) * (pid + 1))
    np.testing.assert_allclose(np.asarray(y)[0], 3.0)   # 1 + 2 psum'd
    if pid == 0:
        np.savez(ckpt + ".tmp.npz", step=step)   # savez appends .npz itself
        os.replace(ckpt + ".tmp.npz", ckpt)
        with open(ckpt + ".progress", "a") as fh:
            fh.write(f"{step}\n")
    if pid == 1 and fault_step >= 0 and step == fault_step:
        os._exit(17)          # simulated host loss mid-run
    time.sleep(0.05)
print("DONE", pid, flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(pid, addr, steps, ckpt, fault_step, tmp_path):
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)          # conftest's 8 virtual devices would
    env["JAX_PLATFORMS"] = "cpu"        # break the 1-device-per-process pmap
    env["PYTHONPATH"] = REPO + (
        os.pathsep + env["PYTHONPATH"] if "PYTHONPATH" in env else "")
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    return subprocess.Popen(
        [sys.executable, str(script), addr, str(pid), str(steps),
         str(ckpt), str(fault_step)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO)


def _progress(ckpt):
    try:
        with open(str(ckpt) + ".progress") as fh:
            lines = fh.read().split()
        return int(lines[-1]) if lines else -1
    except FileNotFoundError:
        return -1


def test_multihost_initialize_noop_paths(monkeypatch):
    from visualslam.parallel import multihost

    monkeypatch.delenv("SLAM_COORDINATOR", raising=False)
    assert multihost.initialize() is False          # no coordinator set
    assert multihost.initialize("127.0.0.1:1", num_processes=1) is False
    monkeypatch.setenv("SLAM_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("SLAM_NUM_PROCESSES", "1")
    assert multihost.initialize() is False          # single process: no-op
    assert multihost.is_coordinator()


def test_fault_injection_and_checkpoint_recovery(tmp_path):
    addr = f"127.0.0.1:{_free_port()}"
    ckpt = tmp_path / "state.npz"
    steps, fault_step = 40, 8

    # --- phase 1: run with a fault injected at step 8 on process 1 ---
    p0 = _spawn(0, addr, steps, ckpt, -1, tmp_path)
    p1 = _spawn(1, addr, steps, ckpt, fault_step, tmp_path)
    assert p1.wait(timeout=120) == 17, "fault process should self-kill"
    t_fault = time.time()
    # survivor must STOP making progress (the stalled collective is the
    # failure-detection signal) — give it a grace window, then require the
    # step counter to be frozen at/near the fault step
    time.sleep(8)
    prog_a = _progress(ckpt)
    time.sleep(4)
    prog_b = _progress(ckpt)
    assert prog_a <= fault_step + 2, f"survivor ran past fault: {prog_a}"
    assert prog_b == prog_a, "survivor kept advancing without its peer"
    p0.kill()
    p0.wait()

    # --- phase 2: restart both processes; they resume from checkpoint ---
    addr2 = f"127.0.0.1:{_free_port()}"
    q0 = _spawn(0, addr2, steps, ckpt, -1, tmp_path)
    q1 = _spawn(1, addr2, steps, ckpt, -1, tmp_path)
    out0, _ = q0.communicate(timeout=180)
    out1, _ = q1.communicate(timeout=180)
    assert q0.returncode == 0, out0[-2000:]
    assert q1.returncode == 0, out1[-2000:]
    assert "DONE 0" in out0 and "DONE 1" in out1
    assert _progress(ckpt) == steps - 1
    # resumed, not restarted from scratch: first resumed step > fault step
    with open(str(ckpt) + ".progress") as fh:
        prog = [int(x) for x in fh.read().split()]
    resumed_at = prog[prog.index(max(prog[:prog.index(steps - 1) + 1]))]
    assert max(prog) == steps - 1
    # the sequence contains no restart from 0 after the fault
    assert prog.count(0) == 1
