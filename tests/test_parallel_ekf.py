"""Landmark-sharded EKF vs dense single-device EKF equality.

The sharded estimator (slam_tpu.parallel.ekf) decomposes the joint
covariance into replicated pose blocks + a row-sharded landmark block;
these tests run the same workload through both implementations on the
virtual 8-device CPU mesh and require matching trajectories and
covariances (up to f32 reduction-order drift).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slam_tpu.config import SlamConfig
from slam_tpu.maps import synthetic_map
from slam_tpu.models import EkfSlam
from slam_tpu.parallel.ekf import ShardedEkfSlam, dense_covariance
from slam_tpu.parallel.mesh import make_mesh
from slam_tpu.runtime import Runner, compute_metrics


@pytest.fixture(scope="module")
def mesh4():
    return make_mesh(4, axis="l")


def _run_both(cfg, slam_map, mesh, n_ticks):
    dense = Runner(cfg, slam_map, "EKF1")
    res_d = dense.run(seed=5, n_ticks=n_ticks)

    est = ShardedEkfSlam(cfg, slam_map.n_landmarks, mesh)
    sharded = Runner(cfg, slam_map, "EKF1", estimator=est)
    res_s = sharded.run(seed=5, n_ticks=n_ticks)
    return res_d, res_s


def test_sharded_ekf_matches_dense(mesh4):
    slam_map = synthetic_map(16, 12, radius=40.0, seed=7)
    cfg = SlamConfig(SWITCH_HEADING_KNOWN=1, max_landmarks=16)
    res_d, res_s = _run_both(cfg, slam_map, mesh4, n_ticks=30 * 8)

    # Same trajectory (f32 reduction-order drift only).
    np.testing.assert_allclose(res_s.est_pose, res_d.est_pose,
                               atol=5e-3)

    # Same joint covariance and landmark count at the end.
    d = res_d.final_state
    s = res_s.final_state
    assert int(s.n) == int(d.n)
    L = d.capacity
    Ps = np.asarray(dense_covariance(s))
    Pd = np.asarray(d.P)
    np.testing.assert_allclose(Ps[:3, :3], Pd[:3, :3], atol=5e-4)
    np.testing.assert_allclose(Ps, Pd, atol=5e-3)
    np.testing.assert_allclose(np.asarray(s.x), np.asarray(d.x),
                               atol=5e-3)


def test_sharded_ekf_gated_association(mesh4):
    """Unknown association exercises the psum'd innovation statistics."""
    slam_map = synthetic_map(12, 10, radius=35.0, seed=3)
    cfg = SlamConfig(SWITCH_HEADING_KNOWN=1, max_landmarks=12,
                     SWITCH_ASSOCIATION_KNOWN=0)
    res_d, res_s = _run_both(cfg, slam_map, mesh4, n_ticks=25 * 8)
    np.testing.assert_allclose(res_s.est_pose, res_d.est_pose, atol=1e-2)
    assert int(res_s.final_state.n) == int(res_d.final_state.n)


def test_sharded_ekf_capacity_padding(mesh4):
    """Capacity not divisible by the mesh gets padded, and padded slots
    never participate."""
    slam_map = synthetic_map(10, 8, radius=30.0, seed=1)
    cfg = SlamConfig(SWITCH_HEADING_KNOWN=1, max_landmarks=10)
    est = ShardedEkfSlam(cfg, slam_map.n_landmarks, mesh4)
    assert est.capacity % 4 == 0 and est.capacity >= 10
    runner = Runner(cfg, slam_map, "EKF1", estimator=est)
    res = runner.run(seed=2, n_ticks=20 * 8)
    m = compute_metrics(res)
    assert np.isfinite(m.ate_rmse)
    assert int(res.final_state.n) <= 10


@pytest.mark.slow
def test_sharded_ekf_10k_landmarks_smoke():
    """The scale the component exists for: a 10k-landmark map on the
    8-way CPU landmark mesh — joint covariance 2L x 2L = 20k x 20k
    (1.6 GB), row-sharded 8 ways. Two supersteps must run, instantiate
    landmarks, and keep the pose finite. (The single-card run is
    chip_smoke.py's phase 4.)"""
    from slam_tpu.runtime.config5 import config5_setup
    cfg, slam_map = config5_setup(10_000, capacity=10_000, max_obs=96)
    mesh = make_mesh(8, axis="l")
    est = ShardedEkfSlam(cfg, slam_map.n_landmarks, mesh)
    runner = Runner(cfg, slam_map, "EKF1", estimator=est)
    res = runner.run(seed=3, n_ticks=2 * cfg.steps_per_observe)
    assert int(res.final_state.n) > 0
    assert np.isfinite(res.est_pose).all()
    m = compute_metrics(res)
    assert m.ate_rmse < 1.0
