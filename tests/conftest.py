"""Test configuration: run everything on a virtual 8-device CPU mesh.

The tests check semantics on the CPU, even on a machine that has a GPU;
``python chip_smoke.py`` exercises the card. Eight virtual CPU devices
cover the sharding paths without cards (SURVEY.md §4 note on multi-host
testing). The device count is read when jax starts its CPU backend, so
it is set before jax is imported.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# The in-repo maps under data/, generated by tools/make_maps.py with the
# shapes and parameters of the reference's four example maps.


@pytest.fixture(scope="session")
def map_path():
    """``map_path("loop1_like")`` -> the .mat path; ``ext="ini"`` for
    its config."""
    from slam_tpu.maps import DATA_DIR

    def path(name: str, ext: str = "mat") -> str:
        return os.path.join(DATA_DIR, f"{name}.{ext}")
    return path


@pytest.fixture(scope="session")
def workload():
    """``workload("loop1_like")`` -> (SlamConfig, SlamMap)."""
    from slam_tpu.maps import load_reference_like
    return load_reference_like


@pytest.fixture(scope="session")
def loop1_map(workload):
    return workload("loop1_like")[1]


@pytest.fixture(scope="session")
def webmap_map(workload):
    return workload("webmap_like")[1]


@pytest.fixture(scope="session")
def loop1_config(workload):
    return workload("loop1_like")[0]


@pytest.fixture(scope="session")
def webmap_config(workload):
    return workload("webmap_like")[0]


@pytest.fixture
def rng():
    return np.random.default_rng(42)
