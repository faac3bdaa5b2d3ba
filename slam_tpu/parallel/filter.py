"""Sharded FastSLAM: the particle axis distributed over a device mesh.

Same estimator semantics as slam_tpu.models.fastslam{1,2} — the update
bodies are literally the same functions, applied to each shard's local
particle block under ``shard_map`` — with the two global synchronization
points replaced by collectives:

- Neff / weight normalization: psum scalars;
- stratified resampling: the ppermute ring of slam_tpu.parallel.resampling
  (no counterpart in the single-threaded reference; SURVEY.md §2.9).

Drop-in for the Runner: ShardedFastSlam{1,2} expose the same
init/predict/update/pose interface as the single-chip classes.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from slam_tpu.config import SlamConfig
from slam_tpu.models import rbpf
from slam_tpu.models.fastslam1 import fs1_predict, fs1_update
from slam_tpu.models.fastslam2 import fs2_predict, fs2_update
from slam_tpu.models.particles import ParticleState, init_particles
from slam_tpu.parallel.mesh import particle_state_specs
from slam_tpu.parallel.resampling import (
    ring_resample,
    sharded_estimate_position,
)


class _ShardedFastSlamBase:
    """Common scaffolding: builds shard_map'ed predict/update/pose."""

    # Fields the per-tick predict may modify (run-loop freeze hint).
    PREDICT_TOUCHED = ("xv", "Pv")

    _predict_fn = None   # staticmethod in subclasses
    _update_fn = None

    def __init__(self, config: SlamConfig, n_map_landmarks: int,
                 mesh: Mesh, n_particles: int,
                 predict_noise: bool = True):
        self.config = config
        self.n_map = n_map_landmarks
        self.capacity = config.max_landmarks or n_map_landmarks
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self.n_shards = mesh.devices.size
        if n_particles % self.n_shards:
            raise ValueError(
                f"n_particles={n_particles} must divide over "
                f"{self.n_shards} devices")
        self.n_particles = n_particles
        cfg = config
        axis = self.axis
        S = self.n_shards
        state_specs = particle_state_specs(axis)
        scalar = P()

        predict_fn = type(self)._predict_fn
        update_fn = type(self)._update_fn
        Qe = jnp.diag(jnp.asarray(cfg.Qe, jnp.float32))
        Re = jnp.diag(jnp.asarray(cfg.Re, jnp.float32))

        def predict_local(state, key, vn, gn, phi):
            key = jax.random.fold_in(key, jax.lax.axis_index(axis))
            state = predict_fn(state, key, vn, gn, Qe,
                               wheelbase=cfg.WHEELBASE,
                               dt=cfg.DT_CONTROLS,
                               add_noise=predict_noise)
            if cfg.SWITCH_HEADING_KNOWN:
                state = rbpf.observe_heading_particles(state, phi,
                                                       cfg.sigmaT)
            return state

        def collective_resample(state, key, n_min):
            new_state, new_logw, _ = ring_resample(
                state, state.logw, key, n_min,
                bool(cfg.SWITCH_RESAMPLE), axis,
                static_ring_size=S)
            return new_state._replace(logw=new_logw)

        def update_local(state, key, z, ids, zmask, n_min):
            return update_fn(state, key, z, ids, zmask, Re, n_min,
                             do_resample=bool(cfg.SWITCH_RESAMPLE),
                             resample_fn=collective_resample)

        def pose_local(state):
            return sharded_estimate_position(state.logw, state.xv, axis)

        self._predict = jax.jit(shard_map(
            predict_local, mesh=mesh,
            in_specs=(state_specs, scalar, scalar, scalar, scalar),
            out_specs=state_specs, check_vma=False))
        self._update = jax.jit(shard_map(
            update_local, mesh=mesh,
            in_specs=(state_specs, scalar, scalar, scalar, scalar,
                      scalar),
            out_specs=state_specs, check_vma=False))
        self._pose = jax.jit(shard_map(
            pose_local, mesh=mesh, in_specs=(state_specs,),
            out_specs=P(), check_vma=False))

    # -- estimator interface -------------------------------------------
    def init(self, n_particles: int | None = None) -> ParticleState:
        n = n_particles or self.n_particles
        state = init_particles(n, self.capacity, self.n_map)
        from slam_tpu.parallel.mesh import particle_sharding
        shardings = particle_sharding(self.mesh, self.axis)
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


class ShardedFastSlam1(_ShardedFastSlamBase):
    _predict_fn = staticmethod(fs1_predict)
    _update_fn = staticmethod(fs1_update)

    def __init__(self, config, n_map_landmarks, mesh, n_particles):
        # FS1 forces predict noise on (fastslam1wrapper.cpp:20).
        super().__init__(config, n_map_landmarks, mesh, n_particles,
                         predict_noise=True)


class ShardedFastSlam2(_ShardedFastSlamBase):
    _predict_fn = staticmethod(fs2_predict)
    _update_fn = staticmethod(fs2_update)

    def __init__(self, config, n_map_landmarks, mesh, n_particles):
        super().__init__(config, n_map_landmarks, mesh, n_particles,
                         predict_noise=bool(config.SWITCH_PREDICT_NOISE))
