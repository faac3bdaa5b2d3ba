"""Tracing / profiling utilities.

The reference offers gprof builds (CMake PROFILING, -pg;
src/backend/CMakeLists.txt:39-43) and per-iteration wall-clock telemetry
(updateMicrotimeMark, slamwrapper.cpp:240-254). Equivalents here:

- ``trace(dir)``: a jax.profiler device trace (XLA ops, HBM, fusion) —
  open with TensorBoard or xprof;
- ``time_phases``: per-phase (predict / update / resample) wall-time
  breakdown of one superstep, via repeated timed dispatch;
- the per-superstep ``loopTime`` telemetry and per-run steps/s numbers
  are produced by the run loop itself (slam_tpu.runtime.loop/metrics).
"""

from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a device profile for the enclosed block."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def _time_call(fn, *args, warmup: int = 1, iters: int = 10) -> float:
    """Median wall seconds of a jitted call."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def time_phases(runner, seed: int = 0, iters: int = 10) -> dict:
    """Per-phase timing of the estimator on ``runner``'s workload:
    predict tick, observe update, and the full superstep."""
    sim_state = runner.sim.init(seed=seed)
    est_state = runner.est.init(runner.n_particles)
    key = jax.random.PRNGKey(seed + 1)

    # Representative inputs: advance a few supersteps first.
    step = jax.jit(lambda c: runner._superstep(c, None))
    carry = (sim_state, est_state, key)
    for _ in range(3):
        carry, _ = step(carry)
    sim_state, est_state, key = carry

    sim_state, controls = runner.sim.control_step(sim_state)
    phi = sim_state.vehicle.pose[2]
    sim_state, obs = runner.sim.observe_step(sim_state)

    predict = lambda s: runner.est.predict(s, key, controls.v_noisy,
                                           controls.g_noisy, phi)
    update = lambda s: runner.est.update(s, key, obs.z, obs.ids,
                                         obs.mask)
    return {
        "predict_tick_s": _time_call(predict, est_state, iters=iters),
        "observe_update_s": _time_call(update, est_state, iters=iters),
        "superstep_s": _time_call(lambda c: step(c), carry,
                                  iters=iters),
        "steps_per_observe": runner.config.steps_per_observe,
    }
