"""BASELINE config #5 composed end-to-end: sharded FastSLAM1 over a
(particles x landmarks) device mesh on a 10k-landmark synthetic map,
feeding the SAME device set, repartitioned as a 1-D landmark mesh, for
distributed Schur bundle adjustment.

This is the pipeline the reference ships as its FPGA-accelerated chain
(sim -> estimator -> refinement; fastslam1wrapper.cpp:32-109 drives the
estimator, the offline smoother is the analog of our BA stage), composed
here as one program over one mesh:

  sim ticks -> LandmarkShardedFastSlam1 (2-D mesh, shard_map)
            -> problem_from_run (keyframes = observe supersteps)
            -> solve_ba_sharded (landmark-sharded Schur, device-side LM)

Memory note (why the single-card run uses a bounded per-particle
capacity): FastSLAM stores a 2x2-EKF per (particle, landmark) — 5 f32
planes in our packed layout. A FULL 2^20 x 10k map is
5 * 4 B * 2^20 * 1e4 = 210 GB of landmark planes, more than two 80 GB
cards hold by memory alone; the reference's per-particle std::vector
grows the same way (fastslam1.cpp's per-particle landmark vectors). The
single-card point is 2^20 particles with per-particle capacity sized to
the landmarks the trajectory actually instantiates (the reference's
vectors hold exactly that set too); the full 10k capacity runs on one
card at 32k particles and scales over the landmark mesh axis (each
l-shard holds capacity/n_l slots).
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np

from slam_tpu.config import SlamConfig
from slam_tpu.maps import SlamMap, synthetic_map
from slam_tpu.runtime.loop import Runner
from slam_tpu.runtime.metrics import compute_metrics


class Config5Result(NamedTuple):
    steps_per_second: float       # filter control ticks / s
    particle_steps_per_second: float
    ate_filter: float             # keyframe ATE RMSE, filter estimate
    ate_refined: float            # keyframe ATE RMSE after sharded BA
    n_keyframes: int
    n_landmarks_map: int          # landmarks in the world map
    n_landmarks_observed: int     # landmarks instantiated by the run
    ba_seconds: float
    ba_iters: int
    filter_compile_seconds: float


def config5_setup(n_landmarks: int = 10_000, capacity: int = 256,
                  max_obs: int = 96, seed: int = 5):
    """World + config for the scaling workload: 10k landmarks scattered
    around a loop corridor, sensor range chosen so the per-observe
    visible set and the per-particle instantiated set stay bounded
    (MAX_RANGE 30 m over ~0.05 landmarks/m^2 => ~70 visible/observe)."""
    slam_map = synthetic_map(n_landmarks, n_waypoints=17, radius=200.0,
                             seed=seed)
    # The vehicle starts at the origin (SimState init); synthetic_map
    # centers the loop there, 200 m from the corridor. Shift the world
    # so waypoint 0 is at the start and landmarks are in range from
    # tick 0 (the reference maps are authored this way too).
    shift = slam_map.waypoints[0].copy()
    slam_map = SlamMap(landmarks=slam_map.landmarks - shift,
                       waypoints=slam_map.waypoints - shift)
    cfg = SlamConfig(V=3.0, WHEELBASE=4.0, MAX_RANGE=30.0,
                     SWITCH_HEADING_KNOWN=1,
                     max_landmarks=capacity,
                     max_observations=max_obs)
    return cfg, slam_map


def run_config5(n_particles: int = 1_000_000,
                mesh_shape: tuple[int, int] = (1, 1),
                n_landmarks: int = 10_000,
                capacity: int = 192,
                n_supersteps: int = 32,
                ba_iters: int = 12,
                seed: int = 3,
                rng_impl: str | None = None,
                devices=None) -> Config5Result:
    """Run the composed pipeline.

    mesh_shape = (n_particle_shards, n_landmark_shards). The BA stage
    reuses the same devices as a flat 1-D landmark mesh (BA has no
    particle axis; the landmark system is the big one, so every device
    takes landmark rows there).
    """
    import jax
    from slam_tpu.parallel.landmarks import (LandmarkShardedFastSlam1,
                                             make_mesh_2d)
    from slam_tpu.posegraph import problem_from_run
    from slam_tpu.posegraph.distributed import solve_ba_sharded
    from jax.sharding import Mesh

    cfg, slam_map = config5_setup(n_landmarks, capacity=capacity)
    n_p, n_l = mesh_shape
    devs = list(devices if devices is not None
                else jax.devices()[: n_p * n_l])
    mesh2d = make_mesh_2d(n_p, n_l, devices=devs)
    est = LandmarkShardedFastSlam1(cfg, slam_map.n_landmarks, mesh2d,
                                   n_particles=n_particles)
    runner = Runner(cfg, slam_map, "FASTSLAM1", estimator=est,
                    n_particles=n_particles, rng_impl=rng_impl)
    n_ticks = n_supersteps * cfg.steps_per_observe
    result = runner.run(seed=seed, n_ticks=n_ticks)
    m = compute_metrics(result)

    prob = problem_from_run(result, cfg, slam_map)
    t0 = time.time()
    # Always the SHARDED solver — on one device the mesh is (1,), so
    # the measured BA stage is the distributed code path at every
    # device count. ba_iters reports ACCEPTED LM iterations.
    ba_mesh = Mesh(np.asarray(devs), ("l",))
    poses_ref, _, info = solve_ba_sharded(prob, ba_mesh,
                                          iters=ba_iters,
                                          return_info=True)
    n_ba = int(info["n_iters"])
    jax.block_until_ready(poses_ref)
    ba_seconds = time.time() - t0

    act = result.active
    truth = result.true_pose[act, :2]
    d_ref = np.asarray(poses_ref)[:, :2] - truth
    ate_ref = float(np.sqrt(np.mean(np.sum(d_ref ** 2, axis=1))))
    n_seen = len(np.unique(np.asarray(result.obs_ids)[np.asarray(
        result.obs_mask)]))
    return Config5Result(
        steps_per_second=m.steps_per_second,
        particle_steps_per_second=m.steps_per_second * n_particles,
        ate_filter=m.ate_rmse,
        ate_refined=ate_ref,
        n_keyframes=int(act.sum()),
        n_landmarks_map=slam_map.n_landmarks,
        n_landmarks_observed=n_seen,
        ba_seconds=ba_seconds,
        ba_iters=n_ba,
        filter_compile_seconds=result.compile_seconds,
    )
