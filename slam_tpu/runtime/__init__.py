"""Runtime: the simulation-driver loop, metrics, telemetry, checkpointing.

Replacement for the reference wrapper layer
(src/backend/wrappers/) and the GUI-side DataGatherer metrics sink
(src/gui/plotting/DataGatherer.cpp): the whole run is one compiled
``lax.scan`` program over observation supersteps, executed on-device; the
host only seeds it and reads back the pose traces.
"""

from slam_tpu.runtime.loop import Runner, RunResult
from slam_tpu.runtime.metrics import RunMetrics, compute_metrics, write_report
from slam_tpu.runtime.checkpoint import load_checkpoint, save_checkpoint

__all__ = [
    "Runner",
    "RunResult",
    "RunMetrics",
    "compute_metrics",
    "write_report",
    "save_checkpoint",
    "load_checkpoint",
]
