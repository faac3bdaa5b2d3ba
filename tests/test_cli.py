"""CLI shell tests (SLAMBackendApplication parity)."""

import numpy as np

from slam_tpu.cli import main


def test_cli_headless_run(tmp_path, map_path):
    rc = main(["-m", map_path("loop1_like"), "-method", "FASTSLAM1",
               "-particles", "20", "-ticks", "800", "-seed", "2",
               "-n", "clitest", "-out", str(tmp_path)])
    assert rc == 0
    out = tmp_path / "clitest"
    assert (out / "results.txt").exists()
    errors = np.loadtxt(out / "errors.txt")
    assert np.isfinite(errors).all()


def test_cli_config_override(tmp_path, map_path):
    """Reference-style -KEY value overrides reach the config
    (utils.cpp:1032-1046 semantics, e.g. -SWITCH_HEADING_KNOWN 0)."""
    rc = main(["-m", map_path("loop1_like"), "-method", "EKF1",
               "-ticks", "400", "-SWITCH_HEADING_KNOWN", "0",
               "-n", "clitest2", "-out", str(tmp_path)])
    assert rc == 0
    assert (tmp_path / "clitest2" / "positions.txt").exists()


def test_cli_requires_map():
    assert main([]) == 2


def test_cli_help(capsys):
    assert main(["-h"]) == 0
    assert "slam_tpu backend" in capsys.readouterr().out
