"""Mesh construction and sharding specs for the particle axis."""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

PARTICLE_AXIS = "p"


def make_mesh(n_devices: int | None = None, axis: str = PARTICLE_AXIS
              ) -> Mesh:
    """1-D device mesh over the particle axis. Multi-host: call
    jax.distributed.initialize() first; jax.devices() then spans hosts and
    the same mesh construction works unchanged (collectives ride NVLink
    between the cards of a host, all to all, and the network across
    hosts, so device order within a host does not matter)."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis,))


def particle_state_specs(axis: str = PARTICLE_AXIS):
    """PartitionSpecs for ParticleState fields: per-particle arrays are
    sharded on their TRAILING (particle) axis — see slam_tpu.models.particles
    for the planes layout; the shared landmark-count and association
    table are replicated."""
    from slam_tpu.models.particles import ParticleState
    return ParticleState(
        logw=P(axis),
        xv=P(None, axis),
        Pv=P(None, axis),
        lm=P(None, None, axis),
        lm_P=P(None, None, axis),
        n=P(),
        da_table=P(),
    )


def particle_sharding(mesh: Mesh, axis: str = PARTICLE_AXIS):
    """NamedShardings matching particle_state_specs, for device_put."""
    specs = particle_state_specs(axis)
    return jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                        is_leaf=lambda x: isinstance(x, P))
