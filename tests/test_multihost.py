"""REAL multi-process execution: two jax.distributed processes (4
virtual CPU devices each) form one global 8-device particle mesh and run
the sharded FastSLAM1 filter — cross-process psum + ppermute-ring
resampling over the distributed runtime, the CPU stand-in for a
multi-host cluster (SURVEY.md §4 multiprocess-testing prescription; no
reference counterpart — the reference is single-threaded, §2.9). CPU
only: several JAX processes must not share one GPU.

Correctness oracle: the SAME global mesh shape run in ONE process must
produce the same trajectory — the partitioned XLA program is identical,
only the transport differs.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tools", "multihost_worker.py")

PARTICLES = 4096
SUPERSTEPS = 6
SEED = 7


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(port, pid, nproc, local_devices, out):
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "JAX_NUM_THREADS")}
    env["PYTHONPATH"] = REPO
    cmd = [sys.executable, WORKER,
           "--coordinator", f"localhost:{port}",
           "--num-processes", str(nproc),
           "--process-id", str(pid),
           "--local-devices", str(local_devices),
           "--particles", str(PARTICLES),
           "--supersteps", str(SUPERSTEPS),
           "--seed", str(SEED)]
    if out:
        cmd += ["--out", out]
    return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.mark.slow
def test_two_process_mesh_matches_single_process(tmp_path):
    port = _free_port()
    out2 = str(tmp_path / "mh2.npz")
    procs = [_spawn(port, 0, 2, 4, out2), _spawn(port, 1, 2, 4, None)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=600)
            assert p.returncode == 0, err
    finally:
        # A failed assert (or timeout) must not leak the sibling worker
        # hung on the dead coordinator.
        for q in procs:
            if q.poll() is None:
                q.kill()
                q.wait()
    assert os.path.exists(out2)

    # Single-process oracle on the same 8-device global mesh.
    port1 = _free_port()
    out1 = str(tmp_path / "mh1.npz")
    p = _spawn(port1, 0, 1, 8, out1)
    _, err = p.communicate(timeout=600)
    assert p.returncode == 0, err

    two = np.load(out2)
    one = np.load(out1)
    np.testing.assert_allclose(two["true_pose"], one["true_pose"],
                               atol=1e-6)
    # Same partitioned program, same per-shard RNG streams — the
    # cross-process collectives must reproduce the in-process result.
    np.testing.assert_allclose(two["est_pose"], one["est_pose"],
                               atol=1e-4)
    assert np.isfinite(two["ate"]) and two["ate"] < 2.0
