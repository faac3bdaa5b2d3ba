"""FastSLAM 2.0 — RBPF with the optimal (observation-driven) proposal,
in plane form.

Re-design of the reference FastSLAM2
(src/backend/algorithms/fastslam2.cpp). Structure per observe tick
(fastslam2wrapper.cpp:31-122, fastslam2.cpp:21-48):

  predict: pose + pose-covariance propagation
           Pv <- Gv Pv Gv' + Gu Q Gu'        (fastslam2.cpp:70-105)
  proposal refinement per matched feature (sequential, pose re-linearized
  after each feature, exactly like sampleProposal fastslam2.cpp:290-368,
  but in covariance form — the Woodbury-equivalent of the reference's
  information form, which inverts the near-singular Pv and NaNs in f32;
  see ops.planes.refine_pose_planes):
           K  = Pv Hv' (Sf + Hv Pv Hv')^-1
           xv <- xv + K v ;  Pv <- Pv - K (Hv Pv)'
  sample xvs ~ N(xv, Pv); Pv <- 0
  w *= likelihood(z | xvs) * prior / proposal (log-space; the reference's
           gaussEvaluate Cholesky+SVD dance, fastslam2.cpp:127-163,
           collapses to closed adjugate/Cholesky plane forms)
  feature EKF updates + new features at the sampled pose
  Neff-gated stratified resampling

All 3x3 algebra is packed-symmetric plane arithmetic
(slam_tpu.ops.planes) over the trailing particle axis — no batched
linalg calls, no [P, 3, 3] layouts. The K-observation refinement loop is
a masked ``lax.fori_loop`` (static bound = max_obs), so one compiled
program serves every tick. The reference's MULTIPARTICLE_ACCELERATOR
FPGA batch (fastslam2.cpp:168-287) corresponds to the batched
Jacobian+likelihood evaluation here.

A unified-path observation: with zero matched features the refinement
loop is an identity, so "sample from N(xv, Pv)" (the reference's
new-only branch, fastslam2.cpp:36-42) and the prior/proposal weight
terms (which cancel exactly) fall out of the same code path.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from slam_tpu.config import SlamConfig
from slam_tpu.geometry import wrap_angle
from slam_tpu.models import rbpf
from slam_tpu.models.particles import (
    ParticleState,
    estimate_position,
    init_particles,
)
from slam_tpu.ops import planes as pk

_PV_JITTER = 1e-9


def fs2_predict(state: ParticleState, key, vn, gn, Q,
                *, wheelbase: float, dt: float, add_noise: bool
                ) -> ParticleState:
    """Propagate poses and pose covariances (FastSLAM2::predictState,
    fastslam2.cpp:70-105), packed-symmetric expansion of
    Pv <- Gv Pv Gv' + Gu Q Gu'. Control-noise sampling is gated by
    SWITCH_PREDICT_NOISE (fastslam2wrapper.cpp:18)."""
    P = state.n_particles
    shp = rbpf.tile_shape(P)      # [8, P/8] full-tile view (rbpf)
    xv_b = state.xv.reshape(3, *shp)
    V, G = rbpf.sample_controls(key, vn, gn, Q, shp, add_noise)
    theta = xv_b[2]
    sgt, cgt = jnp.sin(G + theta), jnp.cos(G + theta)
    al = -V * dt * sgt          # Gv[0,2]
    be = V * dt * cgt           # Gv[1,2]

    a, b, c, d, e, f = state.Pv.reshape(6, *shp)
    # Gv Pv Gv' with Gv = I + al*e0 e2' + be*e1 e2'.
    n00 = a + 2.0 * al * c + al * al * f
    n01 = b + al * e + be * c + al * be * f
    n02 = c + al * f
    n11 = d + 2.0 * be * e + be * be * f
    n12 = e + be * f
    n22 = f

    # + Gu Q Gu', Gu rows g0=(dt cgt, al), g1=(dt sgt, be),
    # g2=(dt sin(G)/WB, V dt cos(G)/WB)  (fastslam2.cpp:74-77).
    Qm = jnp.asarray(Q, state.Pv.dtype)
    q00, q01, q11 = Qm[0, 0], Qm[0, 1], Qm[1, 1]
    g00, g01 = dt * cgt, al
    g10, g11 = dt * sgt, be
    g20 = dt * jnp.sin(G) / wheelbase
    g21 = V * dt * jnp.cos(G) / wheelbase

    def gq(gi0, gi1, gj0, gj1):
        return (gi0 * (q00 * gj0 + q01 * gj1)
                + gi1 * (q01 * gj0 + q11 * gj1))

    Pv = jnp.stack([
        n00 + gq(g00, g01, g00, g01),
        n01 + gq(g00, g01, g10, g11),
        n02 + gq(g00, g01, g20, g21),
        n11 + gq(g10, g11, g10, g11),
        n12 + gq(g10, g11, g20, g21),
        n22 + gq(g20, g21, g20, g21),
    ])

    xv = rbpf.propagate_poses(xv_b, V, G, wheelbase, dt)
    return state._replace(xv=xv.reshape(3, P), Pv=Pv.reshape(6, P))


def _refine_proposal(state: ParticleState, z, matched, gathered, R):
    """Sequential per-feature Gaussian proposal refinement, batched over
    particles (sampleProposal core loop, fastslam2.cpp:321-357).
    ``gathered``: the (lmx, lmy, p00, p01, p11) [K, P] planes from
    rbpf.gather_landmarks — pre-gathered so the landmark-sharded filter
    (slam_tpu.parallel.landmarks) can psum-reconstruct them.
    Returns (xv_r [3, P], Pv_r (6-tuple of [P] planes))."""
    r00, r01, r11 = R[0, 0], R[0, 1], R[1, 1]
    lmx, lmy, p00, p01, p11 = gathered
    K = z.shape[0]

    def body(k, carry):
        xv, Pv = carry
        J = pk.jacobians_planes(
            xv[0], xv[1], xv[2],
            lmx[k], lmy[k], p00[k], p01[k], p11[k],
            r00, r01, r11)
        v0 = z[k, 0] - J.zr
        v1 = wrap_angle(z[k, 1] - J.zb)

        Pv_t = tuple(Pv)
        (dx0, dx1, dx2), Pv_new = pk.refine_pose_planes(J, Pv_t, v0, v1)
        xv_new = jnp.stack([xv[0] + dx0, xv[1] + dx1,
                            wrap_angle(xv[2] + dx2)])

        keep = matched[k]
        Pv_out = jnp.stack([jnp.where(keep, n, o)
                            for n, o in zip(Pv_new, Pv_t)])
        return jnp.where(keep, xv_new, xv), Pv_out

    xv_r, Pv_r = jax.lax.fori_loop(0, K, body, (state.xv, state.Pv))
    return xv_r, Pv_r


def fs2_update(state: ParticleState, key, z, ids, zmask, R, n_min,
               *, do_resample: bool = True,
               resample_fn=None) -> ParticleState:
    """Proposal sampling, weighting, map update, resampling
    (FastSLAM2::update, fastslam2.cpp:21-48)."""
    assoc, is_new = rbpf.associate_known(state, ids, zmask)
    matched = assoc >= 0
    slot = jnp.where(matched, assoc, 0)
    any_obs = jnp.any(zmask)

    xv0, Pv0 = state.xv, state.Pv
    gathered = rbpf.gather_landmarks(state, slot)
    xv_r, Pv_r = _refine_proposal(state, z, matched, gathered, R)
    Pv_r_t = tuple(Pv_r)

    # Sample the proposal (multivariateGauss, fastslam2.cpp:353).
    key, sub = jax.random.split(key)
    Lch = pk.sym3_chol(Pv_r_t, _PV_JITTER)
    eps = jax.random.normal(sub, (3, state.n_particles),
                            dtype=xv_r.dtype)
    s0, s1, s2 = pk.chol3_mul_vec(Lch, eps[0], eps[1], eps[2])
    xvs = jnp.stack([xv_r[0] + s0, xv_r[1] + s1,
                     wrap_angle(xv_r[2] + s2)])
    xvs = jnp.where(any_obs, xvs, xv0)

    # Importance weight: likelihood * prior / proposal, log-space
    # (fastslam2.cpp:359-367).
    dp2 = wrap_angle(xv0[2] - xvs[2])
    log_prior = pk.log_gauss3_planes(tuple(Pv0), xv0[0] - xvs[0],
                                     xv0[1] - xvs[1], dp2, _PV_JITTER)
    dq2 = wrap_angle(xv_r[2] - xvs[2])
    log_prop = pk.log_gauss3_planes(Pv_r_t, xv_r[0] - xvs[0],
                                    xv_r[1] - xvs[1], dq2, _PV_JITTER)
    corr = jnp.where(any_obs, log_prior - log_prop, 0.0)
    state = state._replace(
        logw=state.logw + corr,
        xv=xvs,
        Pv=jnp.where(any_obs, jnp.zeros_like(state.Pv), Pv0),
    )

    # Likelihood weighting + map update at the sampled pose
    # (likelihoodGivenXv + featureUpdate + addFeature).
    slot_new, ok = rbpf.new_feature_slots(state.n, is_new, state.capacity)
    state = rbpf.observe_update(state, z, slot, matched, slot_new, ok, R)
    state = rbpf.register_new_features(state, ids, slot_new, ok)
    if resample_fn is not None:
        return resample_fn(state, key, n_min)
    return rbpf.resample(state, key, n_min, do_resample)


class FastSlam2:
    """Config-bound FastSLAM 2.0 with jitted step functions."""

    # Fields the per-tick predict may modify (run-loop freeze hint).
    PREDICT_TOUCHED = ("xv", "Pv")
    # Two supersteps per scan body: the update's resample cond writes
    # fresh landmark buffers, so a 1-superstep body can pay a carry copy
    # every iteration; A -> B -> A keeps the carry allocation stable
    # (see Runner._build).
    SCAN_PAIR = True

    def __init__(self, config: SlamConfig, n_map_landmarks: int):
        self.config = config
        self.n_map = n_map_landmarks
        self.capacity = config.max_landmarks or n_map_landmarks
        cfg = config
        self._predict = jax.jit(partial(
            fs2_predict, wheelbase=cfg.WHEELBASE, dt=cfg.DT_CONTROLS,
            add_noise=bool(cfg.SWITCH_PREDICT_NOISE)))
        self._update = jax.jit(partial(
            fs2_update, do_resample=bool(cfg.SWITCH_RESAMPLE)))
        self._observe_heading = jax.jit(rbpf.observe_heading_particles)

    def init(self, n_particles: int | None = None) -> ParticleState:
        n = n_particles or self.config.NPARTICLES
        return init_particles(n, self.capacity, self.n_map)

    def predict(self, state, key, vn, gn, phi_true) -> ParticleState:
        """Per control tick: pose + covariance propagation; under
        SWITCH_HEADING_KNOWN also a per-particle heading Joseph update
        against the TRUE heading (FastSLAM2::predict,
        fastslam2.cpp:50-60)."""
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
