"""Struct-of-planes particle state shared by FastSLAM 1 and 2.

The reference keeps a ``vector<Particle>`` of objects, each with
dynamically-growing per-landmark Eigen vectors (Particle.h:44-50,
Particle.cpp:61-73) and walks them in sequential loops. Here the particle
set is one pytree of fixed-capacity arrays with the PARTICLE AXIS LAST and
small-matrix components unpacked into planes:

    logw [P]          log weights (the reference's linear weights,
                      fastslam1.cpp:108-117, underflow at 1M particles)
    xv   [3, P]       poses (x, y, theta)
    Pv   [6, P]       pose covariance, packed symmetric
                      (00, 01, 02, 11, 12, 22)
    lm   [2, L, P]    landmark means (x-plane, y-plane)
    lm_P [3, L, P]    landmark covariances, packed symmetric (00, 01, 11)

Why planes and particle-last: every plane is a dense row of P floats, so
elementwise particle math reads and writes contiguous memory, a slot's
row for all particles is one contiguous [P] vector, and the particle
axis shards on its own (slam_tpu.parallel). Small trailing 2x2 or 3x3
blocks would instead interleave the components of each particle.

Landmark growth is a masked write at a shared slot: the reference uses
*known* association for both FastSLAM variants (fastslam1wrapper.cpp:76-79,
fastslam2wrapper.cpp:86), so all particles share one id->slot table.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

# Packed-symmetric index maps.
SYM3 = {(0, 0): 0, (0, 1): 1, (0, 2): 2,
        (1, 0): 1, (1, 1): 3, (1, 2): 4,
        (2, 0): 2, (2, 1): 4, (2, 2): 5}
SYM2 = {(0, 0): 0, (0, 1): 1, (1, 0): 1, (1, 1): 2}


class ParticleState(NamedTuple):
    """Fixed-capacity Rao-Blackwellized particle set (planes layout).

    ``n``: scalar int32 live landmark count (shared across particles under
    known association). ``da_table``: [n_map] int32 id -> slot, -1 unseen.
    """
    logw: jnp.ndarray   # [P]
    xv: jnp.ndarray     # [3, P]
    Pv: jnp.ndarray     # [6, P] packed symmetric 3x3
    lm: jnp.ndarray     # [2, L, P]
    lm_P: jnp.ndarray   # [3, L, P] packed symmetric 2x2
    n: jnp.ndarray
    da_table: jnp.ndarray

    @property
    def n_particles(self) -> int:
        return self.logw.shape[-1]

    @property
    def capacity(self) -> int:
        return self.lm.shape[-2]

    def lm_mask(self) -> jnp.ndarray:
        """[L] validity mask over landmark slots."""
        return jnp.arange(self.capacity) < self.n


def init_particles(n_particles: int, capacity: int, n_map_landmarks: int,
                   dtype=jnp.float32) -> ParticleState:
    """Uniform weights, origin poses, empty maps
    (ParticleSLAMWrapper::initializeParticles, ParticleSLAMWrapper.cpp:8-32)."""
    P = n_particles
    return ParticleState(
        logw=jnp.full((P,), -jnp.log(float(P)), dtype=dtype),
        xv=jnp.zeros((3, P), dtype=dtype),
        Pv=jnp.zeros((6, P), dtype=dtype),
        lm=jnp.zeros((2, capacity, P), dtype=dtype),
        lm_P=jnp.zeros((3, capacity, P), dtype=dtype),
        n=jnp.int32(0),
        da_table=jnp.full((n_map_landmarks,), -1, dtype=jnp.int32),
    )


def estimate_position(state: ParticleState,
                      mode: str = "weighted") -> jnp.ndarray:
    """Pose estimate; ``mode`` mirrors the reference's compile-time
    variants (computeEstimatedPosition, ParticleSLAMWrapper.cpp:56-119):

    - "mean":     unweighted mean x/y (the reference default),
    - "median":   per-axis median x/y (ESTIMATE_WITH_MEDIAN),
    - "weighted": weight-normalized mean x/y (ESTIMATE_WITH_WEIGHTS;
      our default — it coincides with "mean" right after resampling
      and is strictly more consistent between resamples).

    Heading always comes from the max-weight particle, as in all three
    reference variants."""
    if mode == "mean":
        xy = jnp.mean(state.xv[:2], axis=-1)
    elif mode == "median":
        xy = jnp.median(state.xv[:2], axis=-1)
    else:
        w = jax.nn.softmax(state.logw)
        xy = jnp.sum(w[None, :] * state.xv[:2], axis=-1)
    theta = state.xv[2, jnp.argmax(state.logw)]
    return jnp.concatenate([xy, theta[None]])


def pack_particle_planes(state: ParticleState) -> jnp.ndarray:
    """Concatenate all per-particle fields into one [C, P] matrix
    (C = 10 + 5L channels)."""
    P = state.n_particles
    L = state.capacity
    return jnp.concatenate([
        state.logw[None, :], state.xv, state.Pv,
        state.lm.reshape(2 * L, P), state.lm_P.reshape(3 * L, P)],
        axis=0)


def unpack_particle_planes(state: ParticleState, flat) -> ParticleState:
    """Inverse of pack_particle_planes."""
    P = state.n_particles
    L = state.capacity
    c1, c2, c3, c4 = 1, 4, 10, 10 + 2 * L
    return state._replace(
        logw=flat[0],
        xv=flat[c1:c2],
        Pv=flat[c2:c3],
        lm=flat[c3:c4].reshape(2, L, P),
        lm_P=flat[c4:].reshape(3, L, P),
    )


def gather_particles(state: ParticleState, idx) -> ParticleState:
    """Reindex the per-particle arrays by ancestor indices (the
    copy-and-keep step of resampleParticles, core.cpp:736-748). ``idx``
    indexes the trailing particle axis: the state is packed into one
    [C, P] matrix and gathered by a single XLA gather."""
    flat = pack_particle_planes(state)
    return unpack_particle_planes(state, flat[:, idx])


# ---------------------------------------------------------------------------
# Packing helpers (tests, telemetry, interop with the stacked-matrix ops)
# ---------------------------------------------------------------------------

def pack_sym2(M):
    """[..., 2, 2] symmetric -> planes (m00, m01, m11) stacked on axis 0."""
    return jnp.stack([M[..., 0, 0], M[..., 0, 1], M[..., 1, 1]])


def unpack_sym2(p, axis: int = 0):
    """Planes (3, ...) -> [..., 2, 2] symmetric."""
    m00, m01, m11 = jnp.moveaxis(p, axis, 0)
    return jnp.stack([jnp.stack([m00, m01], -1),
                      jnp.stack([m01, m11], -1)], -2)


def pack_sym3(M):
    """[..., 3, 3] symmetric -> planes (6, ...) in SYM3 order."""
    return jnp.stack([M[..., 0, 0], M[..., 0, 1], M[..., 0, 2],
                      M[..., 1, 1], M[..., 1, 2], M[..., 2, 2]])


def unpack_sym3(p, axis: int = 0):
    a, b, c, d, e, f = jnp.moveaxis(p, axis, 0)
    return jnp.stack([jnp.stack([a, b, c], -1),
                      jnp.stack([b, d, e], -1),
                      jnp.stack([c, e, f], -1)], -2)
