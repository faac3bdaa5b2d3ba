"""Run metrics: the DataGatherer subsystem, natively.

The reference gathers metrics in the GUI process
(src/gui/plotting/DataGatherer.cpp): per-turn Euclidean position error,
loop times, observed-landmark counts and mean observation range, written
as ``<simName>/{results,errors,times,positions,observedCounts,
averageLengthLandmark}.txt`` with mean/std/min/max summaries
(DataGatherer.cpp:22-90). Here the same files are produced directly from
the RunResult traces, plus ATE RMSE (the BASELINE.md acceptance metric,
computed from the positions trace the reference only dumps raw).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from slam_tpu.runtime.loop import RunResult


@dataclass(frozen=True)
class RunMetrics:
    ate_rmse: float
    error_mean: float
    error_std: float
    error_min: float
    error_max: float
    mean_loop_time_us: float     # per superstep (observe period)
    steps_per_second: float      # control ticks per second
    observed_mean: float
    mean_observation_range: float
    n_supersteps: int
    n_ticks: int

    def summary(self) -> str:
        return (
            f"ATE RMSE: {self.ate_rmse:.4f} m | "
            f"err mean/std/min/max: {self.error_mean:.4f}/"
            f"{self.error_std:.4f}/{self.error_min:.4f}/"
            f"{self.error_max:.4f} m | "
            f"{self.steps_per_second:,.0f} steps/s | "
            f"loop {self.mean_loop_time_us:.1f} us")


def position_errors(result: RunResult) -> np.ndarray:
    """Per-superstep Euclidean truth-vs-estimate position error over the
    active part of the run (DataGatherer::nextTurn,
    DataGatherer.cpp:104-110)."""
    act = result.active
    d = result.true_pose[act, :2] - result.est_pose[act, :2]
    return np.linalg.norm(d, axis=1)


def compute_metrics(result: RunResult) -> RunMetrics:
    err = position_errors(result)
    act = result.active
    n_supersteps = int(act.sum())
    counts = result.obs_count[act]
    ranges = result.obs_range_sum[act]
    total_count = max(int(counts.sum()), 1)
    period = result.n_ticks // max(len(result.active), 1)
    wall = max(result.wall_seconds, 1e-9)
    n_ticks_active = n_supersteps * period
    # Loop time normalized to the reference's "turn" (one control tick).
    return RunMetrics(
        ate_rmse=float(np.sqrt(np.mean(err ** 2))) if err.size else 0.0,
        error_mean=float(err.mean()) if err.size else 0.0,
        error_std=float(err.std()) if err.size else 0.0,
        error_min=float(err.min()) if err.size else 0.0,
        error_max=float(err.max()) if err.size else 0.0,
        mean_loop_time_us=1e6 * wall / max(len(result.active), 1),
        steps_per_second=result.n_ticks / wall,
        observed_mean=float(counts.mean()) if counts.size else 0.0,
        mean_observation_range=float(ranges.sum() / total_count),
        n_supersteps=n_supersteps,
        n_ticks=n_ticks_active,
    )


def _stats_block(label: str, v: np.ndarray) -> str:
    if v.size == 0:
        return f"{label}:\nMean: 0 Std: 0 Min: 0 Max: 0\n"
    mean = v.mean()
    std = np.sqrt(np.maximum((v * v).mean() - mean * mean, 0.0))
    return (f"{label}:\nMean: {mean:.10g} Std: {std:.10g} "
            f"Min: {v.min():.10g} Max: {v.max():.10g}\n")


def write_report(result: RunResult, name: str, out_dir: str = ".") -> str:
    """Write the DataGatherer file set (DataGatherer::saveData,
    DataGatherer.cpp:50-90) for a finished run. Returns the directory."""
    path = os.path.join(out_dir, name)
    os.makedirs(path, exist_ok=True)
    err = position_errors(result)
    act = result.active
    # The reference records one loopTime per turn; we have one compiled
    # program — report the per-superstep average as the time series.
    times_us = np.full(err.shape,
                       1e6 * result.wall_seconds /
                       max(len(result.active), 1))

    with open(os.path.join(path, "results.txt"), "w") as fh:
        fh.write(_stats_block("Errors", err))
        fh.write(_stats_block("Times", times_us))
        fh.write(f"ATE RMSE: {np.sqrt(np.mean(err**2)) if err.size else 0.0:.10g}\n")
        fh.write(f"Landmarks mapped: {int(result.final_state.n)}\n")

    np.savetxt(os.path.join(path, "errors.txt"), err, fmt="%.10g")
    np.savetxt(os.path.join(path, "times.txt"), times_us, fmt="%.10g")
    np.savetxt(os.path.join(path, "observedCounts.txt"),
               result.obs_count[act], fmt="%d")
    counts = np.maximum(result.obs_count[act], 1)
    np.savetxt(os.path.join(path, "averageLengthLandmark.txt"),
               result.obs_range_sum[act] / counts, fmt="%.6g")
    pos = np.column_stack([result.true_pose[act, 0],
                           result.true_pose[act, 1],
                           result.est_pose[act, 0],
                           result.est_pose[act, 1]])
    np.savetxt(os.path.join(path, "positions.txt"), pos,
               fmt="%.10g", delimiter=", ")
    return path
