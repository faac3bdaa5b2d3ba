"""Synthetic bundle-adjustment workload (BASELINE config #5's BA stage).

Used by bench.py, chip_smoke.py and the tests: a seeded, drifted
cold-start problem whose solution quality can be checked against the MAP
floor (the error a solve reaches when started at truth).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from slam_tpu.posegraph.ba import BAProblem, to_local


def make_ba_problem(n_keyframes=256, n_landmarks=10_000, K=24,
                    loops=2, seed=0):
    """Synthetic BA workload (BASELINE config #5): `loops` passes around
    a 200 m-radius circle (matching the reference's NUMBER_LOOPS=2 —
    cross-pass landmark reobservation braces the graph), noisy
    range-bearing obs of the K nearest landmarks, noisy odometry, and a
    dead-reckoned initial trajectory that carries real accumulated
    drift. Returns (problem, poses_true, poses0, lms_true)."""
    rng = np.random.default_rng(seed)
    T, L = n_keyframes, n_landmarks
    ang = np.linspace(0, loops * 2 * np.pi, T)
    th = np.mod(ang + np.pi / 2 + np.pi, 2 * np.pi) - np.pi
    poses = np.stack([200 * np.cos(ang), 200 * np.sin(ang), th],
                     -1).astype(np.float32)
    lms = rng.uniform(-300, 300, (L, 2)).astype(np.float32)
    # Each keyframe observes its K nearest landmarks (realistic ranges;
    # far random assignments make the linearization useless).
    d_all = np.linalg.norm(lms[None, :, :] - poses[:, None, :2], axis=-1)
    idx = np.argsort(d_all, axis=1)[:, :K].astype(np.int32)
    d = lms[idx] - poses[:, None, :2]
    z = np.stack([np.linalg.norm(d, axis=-1),
                  np.arctan2(d[..., 1], d[..., 0]) - poses[:, 2:3]],
                 -1).astype(np.float32)
    # Measurement noise consistent with R = diag(0.1^2 m, ~1deg^2).
    z[..., 0] += rng.normal(scale=0.1, size=z[..., 0].shape)
    z[..., 1] += rng.normal(scale=0.017, size=z[..., 1].shape)
    # Noisy odometry consistent with odom_info (sigma 5 cm / ~0.6 deg
    # per keyframe step). Pose 0 = truth (it defines the frame; the
    # solver anchors its gauge prior there).
    odom = np.asarray(to_local(jnp.asarray(poses[:-1]),
                               jnp.asarray(poses[1:])))
    odom = odom + np.stack(
        [rng.normal(scale=0.05, size=(T - 1,)),
         rng.normal(scale=0.05, size=(T - 1,)),
         rng.normal(scale=0.01, size=(T - 1,))], -1).astype(np.float32)
    poses0 = np.empty_like(poses)
    poses0[0] = poses[0]
    for t in range(T - 1):
        c, s = np.cos(poses0[t, 2]), np.sin(poses0[t, 2])
        poses0[t + 1] = (poses0[t, 0] + c * odom[t, 0] - s * odom[t, 1],
                         poses0[t, 1] + s * odom[t, 0] + c * odom[t, 1],
                         poses0[t, 2] + odom[t, 2])
    # Landmarks initialized by back-projecting the (noisy) observations
    # from the drifted dead-reckoned poses — the realistic cold start.
    ang_w = poses0[:, 2:3] + z[..., 1]
    wx = poses0[:, 0:1] + z[..., 0] * np.cos(ang_w)
    wy = poses0[:, 1:2] + z[..., 0] * np.sin(ang_w)
    sums = np.zeros((L, 2))
    counts = np.zeros(L)
    np.add.at(sums, idx.reshape(-1),
              np.stack([wx.reshape(-1), wy.reshape(-1)], -1))
    np.add.at(counts, idx.reshape(-1), 1.0)
    lms0 = np.where(counts[:, None] > 0,
                    sums / np.maximum(counts, 1.0)[:, None],
                    lms).astype(np.float32)
    prob = BAProblem(
        poses0=jnp.asarray(poses0),
        landmarks0=jnp.asarray(lms0),
        odom=jnp.asarray(odom),
        odom_info=jnp.asarray(np.diag([400., 400., 10000.]),
                              jnp.float32),
        z=jnp.asarray(z), lm_idx=jnp.asarray(idx),
        mask=jnp.ones((T, K), bool),
        R=jnp.asarray(np.diag([0.01, 0.0003]), jnp.float32))
    return prob, poses, poses0, lms
