"""Multi-host initialization and mesh construction.

One process per host, jax.distributed coordination; after initialize()
``jax.devices()`` spans every card of every host and the 1-D particle
mesh of slam_tpu.parallel.mesh works unchanged — collectives ride NVLink
between the cards of a host (all to all, one rate) and the network
between hosts. (The reference has no distributed compute at all; its
only networking is GUI telemetry — SURVEY.md §2.9.)
"""

from __future__ import annotations

import jax

from slam_tpu.parallel.mesh import make_mesh


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Initialize multi-host JAX. Pass all three arguments where the
    environment names no cluster (the coordinator as ``host:port``)."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def global_particle_mesh():
    """Mesh over every chip in the (possibly multi-host) slice."""
    return make_mesh()


def is_coordinator() -> bool:
    return jax.process_index() == 0
