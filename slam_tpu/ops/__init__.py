"""Estimation kernels: Jacobians, Kalman updates, Gaussians, resampling.

Pure-jnp batch-first implementations — the semantic source of truth,
golden-tested against closed forms (systematizing the reference's
DATA_DUMP FPGA-vs-software diffing, core.cpp:512-563) — which XLA
compiles for the CPU in tests and for the GPU in production.
"""

from slam_tpu.ops.jacobians import compute_jacobians
from slam_tpu.ops.kalman import (
    cholesky_update,
    feature_update_2x2,
    joseph_update,
    add_feature_init,
)
from slam_tpu.ops.resampling import (
    effective_particles,
    normalize_log_weights,
    resample_particles,
    stratified_indices,
)

__all__ = [
    "compute_jacobians",
    "cholesky_update",
    "feature_update_2x2",
    "joseph_update",
    "add_feature_init",
    "effective_particles",
    "normalize_log_weights",
    "resample_particles",
    "stratified_indices",
]
