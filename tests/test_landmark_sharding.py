"""Landmark-axis-sharded FastSLAM vs particle-axis-only sharding.

The (p, l) mesh filters (slam_tpu.parallel.landmarks) must produce the
same trajectories as the 1-D particle-sharded filters — the landmark
axis split is pure layout, all collectives reconstruct exact values
(masked psums of disjoint owners). Verified on the 8-device CPU mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slam_tpu.config import SlamConfig
from slam_tpu.maps import synthetic_map
from slam_tpu.parallel import ShardedFastSlam1, make_mesh
from slam_tpu.parallel.landmarks import (
    LandmarkShardedFastSlam1,
    LandmarkShardedFastSlam2,
    make_mesh_2d,
)
from slam_tpu.runtime import Runner, compute_metrics


@pytest.fixture(scope="module")
def slam_map():
    return synthetic_map(12, 10, radius=35.0, seed=11)


@pytest.fixture(scope="module")
def cfg():
    return SlamConfig(SWITCH_HEADING_KNOWN=1, max_landmarks=12,
                      NPARTICLES=64, NEFFECTIVE=48)


def _run(cfg, slam_map, est, n_particles, n_ticks=25 * 8, seed=9):
    runner = Runner(cfg, slam_map, "FASTSLAM1", estimator=est,
                    n_particles=n_particles)
    return runner.run(seed=seed, n_ticks=n_ticks)


def test_fs1_landmark_sharding_matches_particle_only(cfg, slam_map):
    """(p=4, l=2) == (p=4): the l split must be invisible (same RNG
    stream per particle shard, same resampling decisions)."""
    P = 64
    est1 = ShardedFastSlam1(cfg, slam_map.n_landmarks,
                            make_mesh(4), n_particles=P)
    est2 = LandmarkShardedFastSlam1(cfg, slam_map.n_landmarks,
                                    make_mesh_2d(4, 2), n_particles=P)
    r1 = _run(cfg, slam_map, est1, P)
    r2 = _run(cfg, slam_map, est2, P)
    np.testing.assert_allclose(r2.est_pose, r1.est_pose, atol=2e-3)
    assert int(r2.final_state.n) == int(r1.final_state.n)


def test_fs1_landmark_shard_degree_invariance(cfg, slam_map):
    """(p=2, l=1) == (p=2, l=4): changing only the landmark split."""
    P = 64
    e1 = LandmarkShardedFastSlam1(cfg, slam_map.n_landmarks,
                                  make_mesh_2d(2, 1), n_particles=P)
    e4 = LandmarkShardedFastSlam1(cfg, slam_map.n_landmarks,
                                  make_mesh_2d(2, 4), n_particles=P)
    r1 = _run(cfg, slam_map, e1, P)
    r4 = _run(cfg, slam_map, e4, P)
    np.testing.assert_allclose(r4.est_pose, r1.est_pose, atol=2e-3)
    # landmark means agree shard-for-shard after re-assembly
    lm1 = np.asarray(r1.final_state.lm)
    lm4 = np.asarray(r4.final_state.lm)
    np.testing.assert_allclose(lm4, lm1, atol=5e-3)


def test_fs2_landmark_shard_degree_invariance(cfg, slam_map):
    """FastSLAM2's sequential proposal refinement survives the landmark
    split (psum-reconstructed gathered planes)."""
    P = 32
    e1 = LandmarkShardedFastSlam2(cfg, slam_map.n_landmarks,
                                  make_mesh_2d(2, 1), n_particles=P)
    e4 = LandmarkShardedFastSlam2(cfg, slam_map.n_landmarks,
                                  make_mesh_2d(2, 4), n_particles=P)
    r1 = _run(cfg, slam_map, e1, P)
    r4 = _run(cfg, slam_map, e4, P)
    np.testing.assert_allclose(r4.est_pose, r1.est_pose, atol=5e-3)


def test_fs1_10k_landmark_map_runs():
    """The 10k-landmark BASELINE map runs under the landmark-sharded
    filter (small particle count on CPU; the point is the landmark-axis
    memory path and capacity padding)."""
    slam_map = synthetic_map(10_000, 24, radius=30.0, seed=0)
    cfg = SlamConfig(SWITCH_HEADING_KNOWN=1, NPARTICLES=16,
                     NEFFECTIVE=12, V=3.0, WHEELBASE=4.0,
                     MAX_RANGE=60.0, max_observations=24)
    est = LandmarkShardedFastSlam1(cfg, slam_map.n_landmarks,
                                   make_mesh_2d(2, 4), n_particles=16)
    assert est.capacity % 4 == 0
    runner = Runner(cfg, slam_map, "FASTSLAM1", estimator=est,
                    n_particles=16)
    res = runner.run(seed=1, n_ticks=10 * 8)
    m = compute_metrics(res)
    assert np.isfinite(m.ate_rmse)
    assert int(res.final_state.n) > 0
