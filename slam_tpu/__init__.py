"""slam_tpu — a landmark-SLAM engine in JAX for NVIDIA GPUs.

A ground-up JAX/XLA re-design of the capabilities of the reference
C++ landmark-SLAM simulator (matzipan/slam): a 2-D range-bearing observation
model and bicycle motion model driving three estimators — EKF-SLAM,
FastSLAM 1.0 and FastSLAM 2.0 — over waypoint-following simulated runs.

Everything is struct-of-arrays, fixed-capacity, mask-driven and jittable:

- ``slam_tpu.config``    — typed config, ``.ini`` loader, CLI overrides
  (reference: src/backend/core.cpp:971-1073, src/backend/utils.cpp).
- ``slam_tpu.maps``      — ``.mat`` text map reader + synthetic map generator
  (reference: src/backend/core.cpp:855-962).
- ``slam_tpu.geometry``  — angle wrapping, frame transforms, plot geometry
  (reference: src/backend/core.cpp:460-477, 827-852, 330-380).
- ``slam_tpu.sim``       — vehicle truth propagation, steering, sensors
  (reference: src/backend/core.cpp:24-78, 185-273, 438-449).
- ``slam_tpu.ops``       — estimation kernels: Jacobians, Kalman updates,
  resampling, Gaussian evaluation, in jnp
  (reference: src/backend/core.cpp:132-175, 275-317, 579-824).
- ``slam_tpu.models``    — the estimators (EKF-SLAM, FastSLAM 1/2)
  (reference: src/backend/algorithms/).
- ``slam_tpu.parallel``  — device-mesh sharding for particle/landmark axes,
  collective resampling (no reference counterpart; the reference is
  single-threaded).
- ``slam_tpu.runtime``   — stepping loop, metrics, ZMQ telemetry compatible
  with the stock slam-gui, checkpointing
  (reference: src/backend/wrappers/, src/backend/plotting/NetworkPlot.cpp).
"""

__version__ = "0.1.0"

from slam_tpu.config import SlamConfig
from slam_tpu.maps import SlamMap, read_map_file, synthetic_map

__all__ = [
    "SlamConfig",
    "SlamMap",
    "read_map_file",
    "synthetic_map",
    "__version__",
]
