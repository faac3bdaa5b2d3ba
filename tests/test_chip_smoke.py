"""chip_smoke.py and the device helpers on the CPU: the device check
refuses the CPU, the compile cache follows JAX_COMPILATION_CACHE_DIR,
and every phase runs end to end at tiny sizes (the GPU-vs-CPU checks
then compare the CPU with itself)."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke as cs
from slam_tpu.runtime import device


@pytest.fixture
def smoke_out(tmp_path, monkeypatch):
    monkeypatch.setattr(cs, "OUT_DIR", str(tmp_path))
    return tmp_path


def test_require_gpu_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        device.require_gpu()


def test_main_refuses_cpu_and_prints_no_result(smoke_out, capsys):
    with pytest.raises(RuntimeError, match="no GPU"):
        cs.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_script_alone_fails(tmp_path):
    """In a directory holding only chip_smoke.py the import of the
    package fails: non-zero exit, no result line."""
    shutil.copy(cs.__file__, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_compile_cache_dir_from_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert device.compile_cache_dir() == str(tmp_path)


def test_compile_cache_dir_default(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert device.compile_cache_dir() == os.path.join(device.REPO_ROOT,
                                                      ".jax_cache")
    assert os.path.isfile(os.path.join(device.REPO_ROOT, "chip_smoke.py"))


def test_enable_compile_cache_sets_jax_config(monkeypatch, tmp_path):
    old = (jax.config.jax_compilation_cache_dir,
           jax.config.jax_persistent_cache_min_compile_time_secs)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert device.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", old[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          old[1])


def test_phase_cli_tiny(smoke_out, capsys):
    cs.phase_cli(particles=16, ticks=160, ref_ticks=80)
    out = capsys.readouterr().out
    for method in ("EKF1", "FASTSLAM1", "FASTSLAM2"):
        assert f"[2 cli {method} p=16] wall" in out
        assert (smoke_out / f"cli_{method.lower()}_16" / "results.txt"
                ).exists()
    assert "peak_bytes_in_use" in out


def test_phase_fastslam_tiny(smoke_out, capsys):
    cs.phase_fastslam(fs1_particles=256, fs2_particles=128, ticks=64,
                      ref_particles=64)
    out = capsys.readouterr().out
    assert "[3 cli FASTSLAM1 p=256]" in out
    assert "[3 Runner FASTSLAM2 p=128]" in out
    assert "[3 FASTSLAM1/2 gpu-vs-cpu]" in out


def test_phase_ekf_tiny(smoke_out, capsys):
    cs.phase_ekf(n_landmarks=200, supersteps=2)
    assert "[4 sharded-vs-dense EKF]" in capsys.readouterr().out


def test_phase_ba_tiny(smoke_out, capsys):
    cs.phase_ba(n_keyframes=32, n_landmarks=200, iters=10)
    assert "[5 BA T=32 L=200]" in capsys.readouterr().out


def test_four_card_paths_tiny(smoke_out, capsys):
    """The --four-cards comparisons on 4 of the virtual CPU devices."""
    a, b = cs.four_config5(n_particles=64, capacity=8, n_landmarks=400,
                           supersteps=4)
    assert a.n_landmarks_observed == b.n_landmarks_observed
    assert cs.four_ekf(n_landmarks=200, supersteps=2) < 5e-3
    assert cs.four_ba(n_keyframes=16, n_landmarks=64, iters=4) < 5e-3
    out = capsys.readouterr().out
    assert "[four config5 mesh=(2, 2) p=64]" in out


def test_phase_kernel_tiny(smoke_out, capsys, monkeypatch):
    """Phase 6 at small widths, with the kernel in interpret mode."""
    from functools import partial

    from slam_tpu.models import rbpf
    monkeypatch.setattr(rbpf, "fused_observe_update",
                        partial(rbpf.fused_observe_update, interpret=True,
                                block=128))
    cs.phase_kernel(sizes=((300, 40, None), (130, 200, 24)))
    out = capsys.readouterr().out
    assert "[6 fused update P=300 L=40 K=" in out
    assert "[6 fused update P=130 L=200 K=24]" in out
