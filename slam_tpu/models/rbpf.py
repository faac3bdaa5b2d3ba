"""Shared Rao-Blackwellized particle filter building blocks (plane form).

Used by both FastSLAM 1 (slam_tpu.models.fastslam1) and FastSLAM 2
(slam_tpu.models.fastslam2). The reference's per-particle for-loops
(fastslam1.cpp:21-32, fastslam2.cpp:26-45) become batched plane arithmetic
over the trailing particle axis — see slam_tpu.models.particles for the
layout rationale — which vmap-free XLA fuses into a few elementwise
loops and shard_map distributes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from slam_tpu.geometry import wrap_angle
from slam_tpu.models.particles import ParticleState, gather_particles
from slam_tpu.ops import planes as pk
from slam_tpu.ops.fused_update import fused_observe_update


def tile_shape(P: int):
    """Blocked particle shape [8, P/8] (or [4, ...], [2, ...]) when P
    tiles by 128-wide rows, else the flat (P,). The reshape of the
    trailing particle axis is a free row-major bitcast, and the PRNG
    draws the same stream (its counters are linear-index based), so the
    per-tick predict math is identical in either shape."""
    for sub in (8, 4, 2):
        if P % (sub * 128) == 0:
            return (sub, P // sub)
    return (P,)


def sample_controls(key, vn, gn, Q, shape, add_noise):
    """Per-particle control sample ~ N((vn, gn), Q) (the multivariateGauss
    draw in predictState, fastslam1.cpp:37-54). Q is diagonal in every
    shipped config; the general 2x2 Cholesky costs nothing extra.
    ``shape``: particle-axis shape — (P,) or the blocked tile_shape."""
    if isinstance(shape, int):
        shape = (shape,)
    Q = jnp.asarray(Q, jnp.float32)
    L = jnp.linalg.cholesky(Q + 1e-20 * jnp.eye(2, dtype=Q.dtype))
    eps = jax.random.normal(key, (2,) + tuple(shape), dtype=Q.dtype)
    n0 = L[0, 0] * eps[0]
    n1 = L[1, 0] * eps[0] + L[1, 1] * eps[1]
    on = jnp.asarray(add_noise, Q.dtype)
    return vn + on * n0, gn + on * n1


def propagate_poses(xv, V, G, wheelbase: float, dt: float):
    """Batched bicycle step over particles (predictState,
    fastslam1.cpp:37-54 / fastslam2.cpp:70-105). ``xv``: [3, P].

    DESIGN DECISION (SURVEY.md §7 hard-part d): the reference's particle
    predict uses ``sin(G / wheelBase)`` (fastslam1.cpp:52,
    fastslam2.cpp:103) while its own truth propagation and EKF use the
    correct ``sin(G) / wheelBase`` (core.cpp:38, ekfslam.cpp:76). We use
    the correct form everywhere: the estimator's motion model then matches
    the simulator's, which can only improve ATE.
    """
    theta = xv[2]
    return jnp.stack([
        xv[0] + V * dt * jnp.cos(G + theta),
        xv[1] + V * dt * jnp.sin(G + theta),
        wrap_angle(theta + V * dt * jnp.sin(G) / wheelbase),
    ])


def observe_heading_particles(state: ParticleState, phi, sigma_phi
                              ) -> ParticleState:
    """Per-particle scalar heading Joseph update on (xv, Pv)
    (fastslam1.cpp:74-86; a no-op while Pv == 0, exactly like the
    reference). Packed-symmetric Joseph form, fully expanded."""
    P = state.n_particles
    shp = tile_shape(P)
    xv_b = state.xv.reshape(3, *shp)
    r = sigma_phi * sigma_phi
    a, b, c, d, e, f = state.Pv.reshape(6, *shp)
    s = f + r
    k0, k1, k2 = c / s, e / s, f / s
    v = wrap_angle(phi - xv_b[2])

    xv = jnp.stack([xv_b[0] + k0 * v,
                    xv_b[1] + k1 * v,
                    wrap_angle(xv_b[2] + k2 * v)])

    # P' = (I - K e3') P (I - K e3')' + r K K'.
    q2 = 1.0 - k2
    Pv = jnp.stack([
        a - 2.0 * k0 * c + k0 * k0 * f + r * k0 * k0,
        b - k0 * e - k1 * c + k0 * k1 * f + r * k0 * k1,
        q2 * (c - k0 * f) + r * k0 * k2,
        d - 2.0 * k1 * e + k1 * k1 * f + r * k1 * k1,
        q2 * (e - k1 * f) + r * k1 * k2,
        q2 * q2 * f + r * k2 * k2,
    ])
    return state._replace(xv=xv.reshape(3, P), Pv=Pv.reshape(6, P))


def associate_known(state: ParticleState, ids, zmask):
    """Shared id-table association (core.cpp:91-120): returns
    (assoc [K] int32 with -1 for unmatched, is_new [K] bool)."""
    slot = state.da_table[jnp.clip(ids, 0, state.da_table.shape[0] - 1)]
    assoc = jnp.where(zmask & (slot >= 0), slot, -1)
    is_new = zmask & (slot < 0)
    return assoc, is_new


def scatter_slots(planes, tgt, vals, valid):
    """Write ``vals`` [C, K, P] into landmark slots ``tgt`` [K] of
    ``planes`` [C, L, P], masked by ``valid`` [K]: a row scatter of the
    K touched [P] rows (slots are unique; invalid rows are dropped)."""
    idx = jnp.where(valid, tgt, planes.shape[1])
    return planes.at[:, idx, :].set(vals, mode="drop")


def gather_landmarks(state: ParticleState, slot):
    """Gather [K]-indexed landmark planes: returns (lmx, lmy, p00, p01,
    p11), each [K, P]."""
    lm = state.lm[:, slot, :]      # [2, K, P]
    lm_P = state.lm_P[:, slot, :]  # [3, K, P]
    return lm[0], lm[1], lm_P[0], lm_P[1], lm_P[2]


def observe_planes(state: ParticleState, z, slot, R, gathered=None):
    """Jacobian planes + wrapped innovations at each particle's pose for
    each (gathered) observation slot. Returns (J, v0 [K,P], v1 [K,P]).
    Pass ``gathered`` (from gather_landmarks) to reuse a prior gather."""
    if gathered is None:
        gathered = gather_landmarks(state, slot)
    lmx, lmy, p00, p01, p11 = gathered
    r00, r01, r11 = R[0, 0], R[0, 1], R[1, 1]
    J = pk.jacobians_planes(state.xv[0][None, :], state.xv[1][None, :],
                            state.xv[2][None, :],
                            lmx, lmy, p00, p01, p11, r00, r01, r11)
    v0 = z[:, 0][:, None] - J.zr
    v1 = wrap_angle(z[:, 1][:, None] - J.zb)
    return J, v0, v1


def update_matched_features(state: ParticleState, slot, matched,
                            v0, v1, J, gathered=None) -> ParticleState:
    """Per-landmark 2x2 EKF updates for all (particle, matched-obs) pairs,
    then masked scatter back (featureUpdate, core.cpp:132-175).

    ``slot``/``matched``: [K]; ``v0``/``v1``/``J`` planes: [K, P].
    """
    if gathered is None:
        gathered = gather_landmarks(state, slot)
    lmx, lmy, p00, p01, p11 = gathered
    upd = pk.feature_update_planes(lmx, lmy, p00, p01, p11, v0, v1, J)

    lm = scatter_slots(state.lm, slot,
                       jnp.stack([upd.nx, upd.ny]), matched)
    lm_P = scatter_slots(state.lm_P, slot,
                         jnp.stack([upd.np00, upd.np01, upd.np11]),
                         matched)
    return state._replace(lm=lm, lm_P=lm_P)


def new_feature_slots(n, is_new, capacity: int):
    """Shared slots for this observation's new landmarks, in observation
    order from the live count ``n``: (slot_new [K], ok [K]); ``ok`` drops
    new landmarks beyond ``capacity``."""
    newi = is_new.astype(jnp.int32)
    slot_new = n + jnp.cumsum(newi) - newi
    return slot_new, is_new & (slot_new < capacity)


def init_new_features(state: ParticleState, z, slot_new, ok, R
                      ) -> ParticleState:
    """Initialize the landmark planes of new features at ``slot_new``
    for every particle from its own pose (addFeature, core.cpp:479-509).
    """
    R = jnp.asarray(R, state.lm.dtype)

    def do_add(state):
        nx, ny, p00, p01, p11 = pk.feature_init_planes(
            state.xv[0][None, :], state.xv[1][None, :],
            state.xv[2][None, :],
            z[:, 0][:, None], z[:, 1][:, None],
            R[0, 0], R[0, 1], R[1, 1])                        # [K, P]
        return state._replace(
            lm=scatter_slots(state.lm, slot_new, jnp.stack([nx, ny]), ok),
            lm_P=scatter_slots(state.lm_P, slot_new,
                               jnp.stack([p00, p01, p11]), ok))

    # New features only appear while the map is being discovered; once
    # the id table is complete the cond skips the [K, P] initialization
    # on every later observe.
    return jax.lax.cond(jnp.any(ok), do_add, lambda s: s, state)


def register_new_features(state: ParticleState, ids, slot_new, ok
                          ) -> ParticleState:
    """Advance the shared live count and id -> slot table."""
    table = state.da_table.at[
        jnp.where(ok, ids, state.da_table.shape[0])].set(slot_new,
                                                         mode="drop")
    return state._replace(n=state.n + jnp.sum(ok, dtype=jnp.int32),
                          da_table=table)


def add_new_features(state: ParticleState, z, ids, is_new, R
                     ) -> ParticleState:
    """Initialize new landmarks at shared slots and register them."""
    slot_new, ok = new_feature_slots(state.n, is_new, state.capacity)
    state = init_new_features(state, z, slot_new, ok, R)
    return register_new_features(state, ids, slot_new, ok)


def _plain_observe_update(state: ParticleState, z, slot, matched,
                          slot_new, ok, R) -> ParticleState:
    gathered = gather_landmarks(state, slot)
    J, v0, v1 = observe_planes(state, z, slot, R, gathered)
    # computeWeight: product over matched obs of N(v; 0, Sf) — a masked
    # log-sum (fastslam1.cpp:108-117 is linear-space and underflows).
    logl = jnp.where(matched[:, None],
                     pk.log_gauss2_planes(v0, v1, J.s00, J.s01, J.s11),
                     0.0)
    state = state._replace(logw=state.logw + jnp.sum(logl, axis=0))
    state = update_matched_features(state, slot, matched, v0, v1, J,
                                    gathered)
    return init_new_features(state, z, slot_new, ok, R)


def _fused_observe_update(state: ParticleState, z, slot, matched,
                          slot_new, ok, R) -> ParticleState:
    logw, lm, lm_P = fused_observe_update(
        state.logw, state.xv, state.lm, state.lm_P, z, slot, matched,
        slot_new, ok, R)
    return state._replace(logw=logw, lm=lm, lm_P=lm_P)


def observe_update(state: ParticleState, z, slot, matched, slot_new, ok,
                   R) -> ParticleState:
    """The observe update between association and resampling, at each
    particle's current pose: add the log-likelihood of every matched
    observation to ``logw`` (computeWeight, fastslam1.cpp:91-118), update
    the matched landmarks' 2x2 EKFs (featureUpdate, core.cpp:132-175) and
    initialize the new ones' planes (addFeature, core.cpp:479-509).

    The one place the update path is chosen, by the platform the program
    is lowered for: on a GPU one fused Pallas/Triton kernel
    (slam_tpu.ops.fused_update), which beat this plain path end to end
    at 100 and 2^20 particles on the H100; on the CPU the plain jnp
    path. Any other platform is an error at lowering."""
    return jax.lax.platform_dependent(
        state, z, slot, matched, slot_new, ok, jnp.asarray(R, state.lm.dtype),
        cpu=_plain_observe_update, cuda=_fused_observe_update)


def resample(state: ParticleState, key, n_min, do_resample) -> ParticleState:
    """Neff-gated stratified resampling + ancestor gather
    (resampleParticles, core.cpp:718-749).

    The ancestor gather permutes the FULL particle state along the
    particle axis — at 2^20 particles that is about a GB — so it runs
    under lax.cond and is skipped entirely on the (common)
    Neff >= n_min ticks."""
    from slam_tpu.ops import resampling as rs

    n = state.n_particles
    logw_n = rs.normalize_log_weights(state.logw)
    neff = jnp.exp(-jax.scipy.special.logsumexp(2.0 * logw_n, axis=-1))
    need = jnp.asarray(do_resample) & (neff < n_min)
    uniform = jnp.full_like(logw_n, -jnp.log(jnp.float32(n)))
    new_logw = jnp.where(need, uniform, logw_n)

    idx = jax.lax.cond(
        need,
        lambda: rs.stratified_indices(key, logw_n),
        lambda: jnp.arange(n, dtype=jnp.int32))
    state = jax.lax.cond(need,
                         lambda s: gather_particles(s, idx),
                         lambda s: s,
                         state)
    return state._replace(logw=new_logw)
