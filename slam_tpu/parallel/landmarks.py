"""FastSLAM with BOTH the particle axis and the landmark axis sharded.

Completes the TP analog from SURVEY.md §2.9: the per-particle landmark
planes [*, L, P] shard over a 2-D mesh ``(p, l)`` — particles over `p`
(data parallel), landmark SLOTS over `l` (tensor parallel). At the
10k-landmark BASELINE config the planes are ~200 KB per particle; a
2^20-particle map no longer fits one 80 GB card (5 planes x 10k x 2^20
x 4 B = 210 GB), so the landmark axis must shard.

Communication per observe tick is tiny because known association routes
every observation to exactly ONE landmark shard (the slot owner):

  - per-observation weight contributions psum over `l` ([K] scalars
    broadcast per particle block — one [P_local] psum);
  - FastSLAM2 additionally psums the K gathered landmark planes
    ([5K, P_local], masked to the owner) so the sequential proposal
    refinement runs replicated over `l` — the refinement chain is
    order-dependent in k, so each shard runs it on the full gathered
    set rather than ppermuting partial poses around the mesh;
  - feature updates and new-feature initialization are shard-local
    masked writes; the shared slot table and count are replicated
    (identical arithmetic on every shard — no collective needed);
  - resampling is the ppermute ring of slam_tpu.parallel.resampling
    over `p` alone; every `l` shard holds identical weights and makes
    the identical decision, exchanging only its own landmark slab.

Equality-tested against the single-device filters at small L/P on the
virtual 8-device CPU mesh (tests/test_landmark_sharding.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from slam_tpu.config import SlamConfig
from slam_tpu.models import rbpf
from slam_tpu.models.fastslam1 import fs1_predict
from slam_tpu.models.fastslam2 import fs2_predict
from slam_tpu.models.particles import ParticleState, init_particles
from slam_tpu.parallel.resampling import (
    ring_resample,
    sharded_estimate_position,
)

P_AXIS = "p"
L_AXIS = "l"



def make_mesh_2d(n_p: int, n_l: int, devices=None) -> Mesh:
    """(p, l) mesh, particle axis major. The cards of one host are joined
    all to all (NVLink), so the layout follows the algorithm alone: the
    ring resampler's ppermute over `p` and the weight psum over `l` see
    the same link rate whichever cards they pair."""
    import numpy as np
    devices = devices if devices is not None else jax.devices()
    devices = np.asarray(devices[: n_p * n_l]).reshape(n_p, n_l)
    return Mesh(devices, (P_AXIS, L_AXIS))


def state_specs_2d() -> ParticleState:
    return ParticleState(
        logw=P(P_AXIS),
        xv=P(None, P_AXIS),
        Pv=P(None, P_AXIS),
        lm=P(None, L_AXIS, P_AXIS),
        lm_P=P(None, L_AXIS, P_AXIS),
        n=P(),
        da_table=P(),
    )


def _local_slots(state: ParticleState, slot, matched):
    """Map global slots onto this shard's slab: (slot_local [K],
    own [K])."""
    L_local = state.capacity            # local view inside shard_map
    lo = lax.axis_index(L_AXIS) * L_local
    own = matched & (slot >= lo) & (slot < lo + L_local)
    return jnp.where(own, slot - lo, 0), own


def _observe_update_local(state: ParticleState, z, ids, slot, matched,
                          is_new, R):
    """rbpf.observe_update on this shard's landmark slab: each slot has
    one owner, so the weight delta of the owned observations psums over
    `l`; the new-feature slots are global, and each shard initializes the
    ones in its slab. The count/table update is identical replicated
    arithmetic (n and da_table are replicated over the mesh)."""
    L_local = state.capacity            # local view inside shard_map
    lo = lax.axis_index(L_AXIS) * L_local
    slot_l, own = _local_slots(state, slot, matched)
    slot_new, ok = rbpf.new_feature_slots(
        state.n, is_new, L_local * lax.psum(1, L_AXIS))
    ok_here = ok & (slot_new >= lo) & (slot_new < lo + L_local)
    slot_new_l = jnp.where(ok_here, slot_new - lo, 0)
    local = rbpf.observe_update(
        state._replace(logw=jnp.zeros_like(state.logw)),
        z.astype(state.xv.dtype), slot_l, own, slot_new_l, ok_here, R)
    state = local._replace(
        logw=state.logw + lax.psum(local.logw, L_AXIS))
    return rbpf.register_new_features(state, ids, slot_new, ok)


def _fs1_update_local(state: ParticleState, key, z, ids, zmask, R,
                      n_min, do_resample: bool, ring_p: int):
    """FastSLAM1 observe update with landmark slots sharded over `l`."""
    assoc, is_new = rbpf.associate_known(state, ids, zmask)
    matched = assoc >= 0
    slot = jnp.where(matched, assoc, 0)
    state = _observe_update_local(state, z, ids, slot, matched, is_new, R)
    return _resample_local(state, key, n_min, do_resample, ring_p)


def _fs2_update_local(state: ParticleState, key, z, ids, zmask, R,
                      n_min, do_resample: bool, ring_p: int):
    """FastSLAM2 observe update: psum-gather the owned landmark planes so
    the sequential proposal refinement (order-dependent in k) runs
    replicated over `l` (sampleProposal, fastslam2.cpp:290-368); the
    feature EKF writes stay shard-local."""
    from slam_tpu.geometry import wrap_angle
    from slam_tpu.models.fastslam2 import _PV_JITTER, _refine_proposal
    from slam_tpu.ops import planes as pk

    assoc, is_new = rbpf.associate_known(state, ids, zmask)
    matched = assoc >= 0
    slot = jnp.where(matched, assoc, 0)
    slot_l, own = _local_slots(state, slot, matched)
    any_obs = jnp.any(zmask)
    zf = z.astype(state.xv.dtype)

    # Full gathered planes on every l shard: each slot has one owner, so
    # a masked psum reconstructs the global gather.
    local = rbpf.gather_landmarks(state, slot_l)
    mask = own[:, None].astype(state.xv.dtype)
    gathered = tuple(lax.psum(g * mask, L_AXIS) for g in local)

    xv0, Pv0 = state.xv, state.Pv
    xv_r, Pv_r = _refine_proposal(state, zf, matched, gathered, R)
    Pv_r_t = tuple(Pv_r)

    # Sample the proposal. Per-particle noise: distinct across p shards,
    # IDENTICAL across l shards (they carry the same particles).
    key, sub = jax.random.split(key)
    sub = jax.random.fold_in(sub, lax.axis_index(P_AXIS))
    Lch = pk.sym3_chol(Pv_r_t, _PV_JITTER)
    eps = jax.random.normal(sub, (3, state.n_particles),
                            dtype=xv_r.dtype)
    s0, s1, s2 = pk.chol3_mul_vec(Lch, eps[0], eps[1], eps[2])
    xvs = jnp.stack([xv_r[0] + s0, xv_r[1] + s1,
                     wrap_angle(xv_r[2] + s2)])
    xvs = jnp.where(any_obs, xvs, xv0)

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

    # Likelihood weighting + shard-local feature updates at the sampled
    # pose.
    state = _observe_update_local(state, z, ids, slot, matched, is_new, R)
    return _resample_local(state, key, n_min, do_resample, ring_p)


def _resample_local(state: ParticleState, key, n_min, do_resample: bool,
                    ring_p: int):
    new_state, new_logw, _ = ring_resample(
        state, state.logw, key, n_min, do_resample, P_AXIS,
        static_ring_size=ring_p)
    return new_state._replace(logw=new_logw)


class _LandmarkShardedBase:
    """FastSLAM over a (p, l) mesh; Runner-compatible interface."""

    PREDICT_TOUCHED = ("xv", "Pv")

    _predict_fn = None
    _update_fn = None

    def __init__(self, config: SlamConfig, n_map_landmarks: int,
                 mesh: Mesh, n_particles: int,
                 predict_noise: bool = True):
        assert mesh.axis_names == (P_AXIS, L_AXIS), mesh.axis_names
        self.config = config
        self.n_map = n_map_landmarks
        self.mesh = mesh
        S_p = mesh.shape[P_AXIS]
        S_l = mesh.shape[L_AXIS]
        cap = config.max_landmarks or n_map_landmarks
        self.capacity = -(-cap // S_l) * S_l
        if n_particles % S_p:
            raise ValueError(f"n_particles={n_particles} must divide "
                             f"over {S_p} particle shards")
        self.n_particles = n_particles
        cfg = config
        specs = state_specs_2d()
        scalar = P()
        Qe = jnp.diag(jnp.asarray(cfg.Qe, jnp.float32))
        Re = jnp.diag(jnp.asarray(cfg.Re, jnp.float32))
        predict_fn = type(self)._predict_fn
        update_fn = type(self)._update_fn

        def predict_local(state, key, vn, gn, phi):
            # Fold in the particle shard only: l shards must draw the
            # SAME control noise for the same particle.
            key = jax.random.fold_in(key, lax.axis_index(P_AXIS))
            state = predict_fn(state, key, vn, gn, Qe,
                               wheelbase=cfg.WHEELBASE,
                               dt=cfg.DT_CONTROLS,
                               add_noise=predict_noise)
            if cfg.SWITCH_HEADING_KNOWN:
                state = rbpf.observe_heading_particles(state, phi,
                                                       cfg.sigmaT)
            return state

        def update_local(state, key, z, ids, zmask, n_min):
            return update_fn(state, key, z, ids, zmask, Re, n_min,
                             bool(cfg.SWITCH_RESAMPLE), S_p)

        def pose_local(state):
            return sharded_estimate_position(state.logw, state.xv,
                                             P_AXIS)

        self._predict = jax.jit(shard_map(
            predict_local, mesh=mesh,
            in_specs=(specs, scalar, scalar, scalar, scalar),
            out_specs=specs, check_vma=False))
        self._update = jax.jit(shard_map(
            update_local, mesh=mesh,
            in_specs=(specs, scalar, scalar, scalar, scalar, scalar),
            out_specs=specs, check_vma=False))
        self._pose = jax.jit(shard_map(
            pose_local, mesh=mesh, in_specs=(specs,), out_specs=P(),
            check_vma=False))

    def init(self, n_particles: int | None = None) -> ParticleState:
        n = n_particles or self.n_particles
        state = init_particles(n, self.capacity, self.n_map)
        shardings = jax.tree.map(
            lambda s: NamedSharding(self.mesh, s), state_specs_2d(),
            is_leaf=lambda x: isinstance(x, P))
        return jax.device_put(state, shardings)

    def predict(self, state, key, vn, gn, phi) -> ParticleState:
        return self._predict(state, key, vn, gn, phi)

    def update(self, state, key, z, ids, zmask, phi=None
               ) -> ParticleState:
        cfg = self.config
        n_min = cfg.NEFFECTIVE * self.n_particles / cfg.NPARTICLES \
            if cfg.NPARTICLES else cfg.NEFFECTIVE
        return self._update(state, key, z, ids, zmask,
                            jnp.float32(n_min))

    def pose(self, state):
        return self._pose(state)


class LandmarkShardedFastSlam1(_LandmarkShardedBase):
    _predict_fn = staticmethod(fs1_predict)
    _update_fn = staticmethod(_fs1_update_local)

    def __init__(self, config, n_map_landmarks, mesh, n_particles):
        super().__init__(config, n_map_landmarks, mesh, n_particles,
                         predict_noise=True)


class LandmarkShardedFastSlam2(_LandmarkShardedBase):
    _predict_fn = staticmethod(fs2_predict)
    _update_fn = staticmethod(_fs2_update_local)

    def __init__(self, config, n_map_landmarks, mesh, n_particles):
        super().__init__(config, n_map_landmarks, mesh, n_particles,
                         predict_noise=bool(config.SWITCH_PREDICT_NOISE))
