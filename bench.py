"""Benchmark harness on one NVIDIA GPU, on the in-repo workloads.

Prints ONE JSON line first on stdout:
  {"metric": ..., "value": N, "unit": ..., "device": ..., "card": ...}

Primary metric: control ticks per second of FASTSLAM1 on webmap_like
(the webmap-shaped map in data/) at the reference default workload of
100 particles. Secondary lines go to stderr: the other estimators, the
2^17-2^20-particle runs, the 10k-landmark EKF and BA, and the composed
config #5 pipeline. Every line names the device and the card. The run
fails when JAX finds no GPU, and any failing line exits non-zero.

Times are host walls around compiled runs that end in
block_until_ready; compilation is reported separately as set-up.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import numpy as np


def _log(msg: str) -> None:
    print(f"{msg} | {DEVICE} | {CARD}", file=sys.stderr, flush=True)


DEVICE = CARD = ""


def bench_run(method: str, mapname: str, n_particles, n_ticks: int,
              seeds=(3, 4, 5), rng_impl=None):
    """One line: ticks/s as the median over ``seeds`` of the same compiled
    program, ATE as the RMS over the seeds."""
    from slam_tpu.maps import load_reference_like
    from slam_tpu.runtime import Runner, compute_metrics

    cfg, slam_map = load_reference_like(mapname)
    runner = Runner(cfg, slam_map, method, n_particles=n_particles,
                    rng_impl=rng_impl)
    rates, ates, compile_s = [], [], []
    for seed in seeds:
        result = runner.run(seed=seed, n_ticks=n_ticks)
        m = compute_metrics(result)
        assert np.isfinite(m.ate_rmse), f"{method} {mapname}: ATE not finite"
        rates.append(m.steps_per_second)
        ates.append(m.ate_rmse)
        compile_s.append(result.compile_seconds)
    rate = float(np.median(rates))
    ate = float(np.sqrt(np.mean(np.square(ates))))
    _log(f"{method} {mapname} p={n_particles or cfg.NPARTICLES} "
         f"ticks={result.n_ticks}: {rate:,.1f} ticks/s (median of "
         f"{len(seeds)}: {', '.join(f'{r:,.1f}' for r in rates)}), "
         f"ATE {ate:.4f} m, compile {compile_s[0]:.1f} s")
    return rate, ate


def bench_ekf_10k(n_landmarks=10_000, n_ticks=640):
    """Row-sharded EKF at 10k landmarks on a 1-device landmark mesh (its
    joint covariance at 2L = 20k is 1.6 GB and every observe touches
    all of it)."""
    import jax
    from jax.sharding import Mesh
    from slam_tpu.parallel.ekf import ShardedEkfSlam
    from slam_tpu.runtime import Runner, compute_metrics
    from slam_tpu.runtime.config5 import config5_setup

    cfg, slam_map = config5_setup(n_landmarks, capacity=n_landmarks,
                                  max_obs=96)
    mesh = Mesh(np.array(jax.devices()[:1]), ("lm",))
    est = ShardedEkfSlam(cfg, slam_map.n_landmarks, mesh)
    result = Runner(cfg, slam_map, "EKF1", estimator=est).run(
        seed=3, n_ticks=n_ticks)
    m = compute_metrics(result)
    assert np.isfinite(m.ate_rmse)
    _log(f"EKF sharded L={n_landmarks:,}: {m.steps_per_second:,.1f} "
         f"ticks/s, ATE {m.ate_rmse:.4f} m, "
         f"compile {result.compile_seconds:.1f} s")


def bench_ba_10k(n_keyframes=256, n_landmarks=10_000, iters=30):
    """Pose-graph BA over a 10k-landmark synthetic map: ms per LM trial
    (one Schur-eliminated linear solve), with two quality checks: the
    dead-reckoned drift shrinks by >5x, and the solve lands within 1.25x
    of the MAP floor (the error a solve started AT truth reaches)."""
    import jax
    import jax.numpy as jnp
    from slam_tpu.posegraph import solve_ba_device
    from slam_tpu.posegraph.problems import make_ba_problem

    prob, poses, poses0, lms = make_ba_problem(n_keyframes, n_landmarks)
    t0 = time.perf_counter()
    p1, _ = solve_ba_device(prob, iters=1, tol=0.0)
    jax.block_until_ready(p1)
    t_first = time.perf_counter() - t0
    ts = time.perf_counter()
    p, _, info = solve_ba_device(prob, iters=iters, return_info=True)
    jax.block_until_ready(p)
    dt = (time.perf_counter() - ts) / max(info["n_steps"], 1)
    init_err = float(np.linalg.norm(poses0[:, :2] - poses[:, :2],
                                    axis=1).mean())
    err = float(jnp.linalg.norm(p[:, :2] - poses[:, :2], axis=1).mean())
    prob_t = dataclasses.replace(prob, poses0=jnp.asarray(poses),
                                 landmarks0=jnp.asarray(lms))
    p_t, _ = solve_ba_device(prob_t, iters=iters)
    floor = float(jnp.linalg.norm(p_t[:, :2] - poses[:, :2],
                                  axis=1).mean())
    _log(f"BA {n_landmarks:,} landmarks x {n_keyframes} keyframes: "
         f"{dt * 1e3:.2f} ms/LM trial ({info['n_steps']} trials, "
         f"compile+first {t_first:.1f} s), mean pose err "
         f"{init_err:.3f} -> {err:.4f} m (MAP floor {floor:.4f} m)")
    assert err < 0.2 * init_err, (err, init_err)
    assert err < max(1.25 * floor, 0.05), (err, floor)


def bench_config5(n_particles=1 << 20, capacity=192, n_supersteps=32,
                  tag="config5 composed"):
    """BASELINE config #5 composed: landmark-sharded FastSLAM1 on a
    10k-landmark synthetic map -> problem_from_run -> distributed-BA
    refinement (slam_tpu.runtime.config5), on a (1, 1) mesh."""
    from slam_tpu.runtime.config5 import run_config5

    r = run_config5(n_particles=n_particles, mesh_shape=(1, 1),
                    capacity=capacity, n_supersteps=n_supersteps,
                    rng_impl="rbg")
    assert np.isfinite(r.ate_filter) and np.isfinite(r.ate_refined)
    _log(f"{tag} (FS1 p={n_particles:,} cap={capacity} on 10k-landmark "
         f"map -> BA): {r.steps_per_second:,.1f} ticks/s, ATE filter "
         f"{r.ate_filter:.4f} m -> refined {r.ate_refined:.4f} m, "
         f"{r.n_landmarks_observed} landmarks observed, BA "
         f"{r.ba_seconds:.1f} s / {r.ba_iters} iters")


def main():
    global DEVICE, CARD
    from slam_tpu.runtime.device import (
        card_description,
        enable_compile_cache,
        require_gpu,
    )

    t0 = time.time()
    devices = require_gpu()
    enable_compile_cache()
    DEVICE = (f"{devices[0].platform} {devices[0].device_kind} "
              f"x{len(devices)}")
    CARD = card_description()

    rate, _ = bench_run("FASTSLAM1", "webmap_like", 100, n_ticks=4000)
    print(json.dumps({
        "metric": "ticks_per_sec_webmap_like_fastslam1_100p",
        "value": round(rate, 1), "unit": "ticks/s",
        "device": DEVICE, "card": CARD}), flush=True)

    # 6 seeds for EKF1: its per-seed ATE spread is the widest.
    bench_run("EKF1", "webmap_like", None, n_ticks=2000,
              seeds=(3, 4, 5, 6, 7, 8))
    bench_run("FASTSLAM2", "webmap_like", 100, n_ticks=2000)
    bench_run("FASTSLAM2", "loop2_like", 1024, n_ticks=2000)
    bench_run("FASTSLAM1", "loop902_like", 1 << 17, n_ticks=800)
    bench_run("FASTSLAM2", "webmap_like", 1 << 17, n_ticks=800)
    bench_run("FASTSLAM1", "webmap_like", 1 << 20, n_ticks=128,
              seeds=(3, 4, 5), rng_impl="rbg")
    bench_run("FASTSLAM2", "webmap_like", 1 << 20, n_ticks=64,
              seeds=(3, 4, 5), rng_impl="rbg")
    bench_ekf_10k()
    bench_ba_10k()
    bench_config5()
    bench_config5(capacity=256, n_supersteps=16, tag="config5 cap256")
    # Full 10k per-particle capacity: 32,768 particles on one card
    # (6.6 GB of landmark planes per state buffer).
    bench_config5(n_particles=32_768, capacity=10_000, n_supersteps=16,
                  tag="config5 full-10k")
    _log(f"total bench time {time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
