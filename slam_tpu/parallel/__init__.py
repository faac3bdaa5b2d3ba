"""Device-mesh parallelism: sharded particle filters and collective
resampling.

No reference counterpart — the reference is single-threaded per process
(SURVEY.md §2.9); its only heterogeneous-parallel component is the FPGA
Jacobian offload. Here the particle axis is sharded over a
``jax.sharding.Mesh`` (NVLink between the cards of a host, the network
across hosts via ``jax.distributed``), per-particle math runs embarrassingly parallel under
``shard_map``, and the two global synchronization points — weight
normalization/Neff and stratified resampling — run as XLA collectives
(psum / all_gather of scalars) plus a memory-safe ppermute ring for the
cross-shard ancestor exchange.
"""

from slam_tpu.parallel.mesh import make_mesh, particle_sharding
from slam_tpu.parallel.resampling import ring_resample
from slam_tpu.parallel.filter import ShardedFastSlam1, ShardedFastSlam2
from slam_tpu.parallel.ekf import ShardedEkfSlam

__all__ = [
    "make_mesh",
    "particle_sharding",
    "ring_resample",
    "ShardedFastSlam1",
    "ShardedFastSlam2",
    "ShardedEkfSlam",
]
