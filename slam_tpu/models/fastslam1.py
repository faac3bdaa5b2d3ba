"""FastSLAM 1.0 — RBPF with likelihood weighting (plane form).

Re-design of the reference FastSLAM1
(src/backend/algorithms/fastslam1.cpp): the per-particle loops become
plane arithmetic over the trailing particle axis; weights live in log
space; the per-landmark 2x2 EKFs run as one [K, P] batch.

Pipeline per observe tick (fastslam1wrapper.cpp:55-109):
  predict (noisy motion sample, forced on: fastslam1wrapper.cpp:20)
  -> optional per-particle heading observe (fastslam1.cpp:74-86)
  -> known data association (fastslam1wrapper.cpp:76-79)
  -> weight *= likelihood of matched obs (computeWeight, fastslam1.cpp:91-118)
  -> per-landmark feature EKF updates (core.cpp:132-175)
  -> new-feature initialization (core.cpp:479-509)
  -> Neff-gated stratified resampling (core.cpp:718-749)
"""

from __future__ import annotations

from functools import partial
import jax
import jax.numpy as jnp

from slam_tpu.config import SlamConfig
from slam_tpu.models import rbpf
from slam_tpu.models.particles import (
    ParticleState,
    estimate_position,
    init_particles,
)


def fs1_predict(state: ParticleState, key, vn, gn, Q,
                *, wheelbase: float, dt: float, add_noise: bool = True
                ) -> ParticleState:
    """Sample per-particle controls and propagate poses
    (FastSLAM1::predictState, fastslam1.cpp:37-54). The FS1 wrapper forces
    noise on unconditionally (fastslam1wrapper.cpp:20)."""
    shp = rbpf.tile_shape(state.n_particles)
    V, G = rbpf.sample_controls(key, vn, gn, Q, shp, add_noise)
    xv = rbpf.propagate_poses(state.xv.reshape(3, *shp), V, G,
                              wheelbase, dt)
    return state._replace(xv=xv.reshape(3, state.n_particles))


def fs1_update(state: ParticleState, key, z, ids, zmask, R, n_min,
               *, do_resample: bool = True,
               resample_fn=None) -> ParticleState:
    """Weight, per-landmark EKF update, new features, resample
    (FastSLAM1::update, fastslam1.cpp:18-35).

    ``resample_fn(state, key, n_min)``: override for the sharded
    collective resampler."""
    assoc, is_new = rbpf.associate_known(state, ids, zmask)
    matched = assoc >= 0
    slot = jnp.where(matched, assoc, 0)
    slot_new, ok = rbpf.new_feature_slots(state.n, is_new, state.capacity)
    # Weights, matched 2x2 EKFs and new features, batched over particles
    # (the reference's per-particle computeJacobians/computeWeight/
    # featureUpdate loops, fastslam1.cpp:91-118, core.cpp:132-175).
    state = rbpf.observe_update(state, z, slot, matched, slot_new, ok, R)
    state = rbpf.register_new_features(state, ids, slot_new, ok)
    if resample_fn is not None:
        return resample_fn(state, key, n_min)
    return rbpf.resample(state, key, n_min, do_resample)


class FastSlam1:
    """Config-bound FastSLAM 1.0 with jitted step functions."""

    # Fields the per-tick predict may modify (run-loop freeze hint).
    # FS1 never maintains a pose covariance (Pv starts zero and no FS1
    # path writes a nonzero value — the heading Joseph update is an
    # exact no-op at Pv == 0), so the freeze select skips Pv: at 1M
    # particles that is 48 MB/tick of pure select traffic.
    PREDICT_TOUCHED = ("xv",)

    def __init__(self, config: SlamConfig, n_map_landmarks: int):
        self.config = config
        self.n_map = n_map_landmarks
        self.capacity = config.max_landmarks or n_map_landmarks
        cfg = config
        self._predict = jax.jit(partial(
            fs1_predict, wheelbase=cfg.WHEELBASE, dt=cfg.DT_CONTROLS,
            add_noise=True))
        self._update = jax.jit(partial(
            fs1_update, do_resample=bool(cfg.SWITCH_RESAMPLE)))
        self._observe_heading = jax.jit(rbpf.observe_heading_particles)

    def init(self, n_particles: int | None = None) -> ParticleState:
        n = n_particles or self.config.NPARTICLES
        return init_particles(n, self.capacity, self.n_map)

    def predict(self, state, key, vn, gn, phi_true) -> ParticleState:
        """Per control tick: noisy motion sample; under
        SWITCH_HEADING_KNOWN also a per-particle heading Joseph update
        against the TRUE heading (FastSLAM1::predict,
        fastslam1.cpp:57-65 — a no-op while Pv stays zero, as in the
        reference)."""
        state = self._predict(state, key, vn, gn,
                              jnp.diag(jnp.asarray(self.config.Qe,
                                                   jnp.float32)))
        if self.config.SWITCH_HEADING_KNOWN:
            state = self._observe_heading(state, phi_true,
                                          self.config.sigmaT)
        return state

    def update(self, state, key, z, ids, zmask, phi=None) -> ParticleState:
        cfg = self.config
        n_min = cfg.NEFFECTIVE * state.n_particles / cfg.NPARTICLES \
            if cfg.NPARTICLES else cfg.NEFFECTIVE
        return self._update(state, key, z, ids, zmask,
                            jnp.diag(jnp.asarray(cfg.Re, jnp.float32)),
                            jnp.float32(n_min))

    def pose(self, state) -> jnp.ndarray:
        """Estimated pose from the particle cloud
        (computeEstimatedPosition, ParticleSLAMWrapper.cpp:56-119)."""
        return estimate_position(state, self.config.POSE_ESTIMATE)
