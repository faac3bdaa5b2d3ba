#!/usr/bin/env python3
"""Smoke run of slam_tpu on NVIDIA GPUs, in one process.

Drives the main path through the entry points a user calls (the CLI,
Runner, the row-sharded EKF and the device-side bundle adjustment) at
the sizes its users run, and checks what comes out: finite results,
mapped landmarks, BA solution quality, and agreement with a reference
on a small input (the same program on the CPU backend, or the dense
estimator the sharded one decomposes). Every phase prints one line with
its wall and compile seconds, ATE where there is a trajectory,
``peak_bytes_in_use`` and the card; the last line is a JSON verdict.

    python chip_smoke.py               # one card: phases 1-6
    python chip_smoke.py --four-cards  # the multi-device paths, 4 cards vs 1

Any failure raises and exits non-zero; so does a machine where JAX finds
no GPU. Reports and the phase log go to smoke_out/ (gitignored).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from slam_tpu import cli  # noqa: E402
from slam_tpu.maps import DATA_DIR, load_reference_like  # noqa: E402
from slam_tpu.runtime import Runner, compute_metrics  # noqa: E402
from slam_tpu.runtime.device import (  # noqa: E402
    card_description,
    enable_compile_cache,
    require_gpu,
)

OUT_DIR = os.path.join(HERE, "smoke_out")
WEBMAP = os.path.join(DATA_DIR, "webmap_like.mat")

# Tracing, lowering and backend compilation, as JAX reports them.
_COMPILE_EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
                   "/jax/core/compile/jaxpr_to_mlir_module_duration",
                   "/jax/core/compile/backend_compile_duration")
_compile_seconds = [0.0]


def _on_duration(event: str, duration: float, **_) -> None:
    if event in _COMPILE_EVENTS:
        _compile_seconds[0] += duration


class Phase:
    """Times a phase and prints its line: wall and compile seconds, ATE,
    peak_bytes_in_use and the card."""

    card = "card not queried"

    def __init__(self, name: str):
        self.name = name
        self.ate = None
        self.extra = ""

    def __enter__(self):
        self.t0 = time.perf_counter()
        self.c0 = _compile_seconds[0]
        return self

    def __exit__(self, exc_type, *_):
        if exc_type is not None:
            return False
        wall = time.perf_counter() - self.t0
        comp = _compile_seconds[0] - self.c0
        ate = "n/a" if self.ate is None else f"{self.ate:.4f} m"
        stats = jax.devices()[0].memory_stats()   # None on the CPU
        peak = stats and stats.get("peak_bytes_in_use")
        line = (f"[{self.name}] wall {wall:.2f} s | compile {comp:.2f} s | "
                f"ATE {ate} | peak_bytes_in_use "
                f"{'n/a' if peak is None else peak} | {self.card}"
                + (f" | {self.extra}" if self.extra else ""))
        print(line, flush=True)
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "phases.log"), "a") as fh:
            fh.write(line + "\n")
        return False


def _check(ok, what) -> None:
    """Raise unless ``ok``: the smoke checks hold under ``python -O``."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def _ate(result) -> float:
    ate = compute_metrics(result).ate_rmse
    _check(np.isfinite(ate), "non-finite ATE")
    return ate


def _cpu():
    """The CPU backend, which JAX keeps beside the GPU one."""
    return jax.devices("cpu")[0]


# ---------------------------------------------------------------------------
# 1. Device
# ---------------------------------------------------------------------------

def phase_device(min_count: int = 1):
    """Refuse anything but a GPU (JAX falls back to the CPU with only a
    warning when its CUDA plugin does not load)."""
    with Phase("1 device") as ph:
        devices = require_gpu()
        if len(devices) < min_count:
            raise RuntimeError(f"need {min_count} GPUs, found {len(devices)}")
        Phase.card = card_description()
        ph.extra = f"{devices[0].device_kind} x{len(devices)}"
    return devices


# ---------------------------------------------------------------------------
# 2. CLI, reference default of 100 particles, full webmap run
# ---------------------------------------------------------------------------

def _read_report(path: str) -> tuple[float, int]:
    vals = {}
    with open(os.path.join(path, "results.txt")) as fh:
        for line in fh:
            key, _, val = line.partition(":")
            vals[key.strip()] = val.strip()
    return float(vals["ATE RMSE"]), int(vals["Landmarks mapped"])


def run_cli(method: str, particles: int, ticks: int | None,
            out_dir: str, seed: int = 3) -> tuple[float, int]:
    """One in-process CLI run; returns (ATE, landmarks mapped) from the
    written report."""
    name = f"cli_{method.lower()}_{particles}"
    argv = ["-m", WEBMAP, "-method", method, "-particles", str(particles),
            "-seed", str(seed), "-n", name, "-out", out_dir]
    if ticks:
        argv += ["-ticks", str(ticks)]
    _check(cli.main(argv) == 0, f"CLI {method} failed")
    ate, mapped = _read_report(os.path.join(out_dir, name))
    _check(np.isfinite(ate), f"CLI {method}: non-finite ATE")
    _check(mapped > 0, f"CLI {method}: no landmark mapped")
    return ate, mapped


def check_ekf_matches_cpu(n_ticks: int = 400, atol: float = 5e-3):
    """EKF1 on loop1_like, same seed, on the GPU and on the CPU backend:
    the trajectories agree within the sharded-vs-dense EKF tolerance of
    tests/test_parallel_ekf.py."""
    cfg, slam_map = load_reference_like("loop1_like")
    gpu = Runner(cfg, slam_map, "EKF1").run(seed=5, n_ticks=n_ticks)
    with jax.default_device(_cpu()):
        cpu = Runner(cfg, slam_map, "EKF1").run(seed=5, n_ticks=n_ticks)
    np.testing.assert_allclose(gpu.est_pose, cpu.est_pose, atol=atol)
    return float(np.abs(gpu.est_pose - cpu.est_pose).max())


def phase_cli(particles: int = 100, ticks: int | None = None,
              ref_ticks: int = 400):
    for method in ("EKF1", "FASTSLAM1", "FASTSLAM2"):
        with Phase(f"2 cli {method} p={particles}") as ph:
            ph.ate, mapped = run_cli(method, particles, ticks, OUT_DIR)
            ph.extra = f"{mapped} landmarks mapped"
    with Phase("2 EKF1 gpu-vs-cpu") as ph:
        ph.extra = (f"max |pose diff| "
                    f"{check_ekf_matches_cpu(ref_ticks):.2e}")


# ---------------------------------------------------------------------------
# 3. FastSLAM at scale
# ---------------------------------------------------------------------------

def check_updates_match_cpu(P: int = 1024, n_ticks: int = 40):
    """The estimator state after a short FS1/FS2 run, same seed, on the
    GPU and on the CPU backend: rtol 1e-4/atol 1e-5 on logw and lm and
    rtol 1e-3 on lm_P (the tolerances of a kernel-vs-plain check), but
    rtol 1e-3 on FS2's logw. FS2 weights include 3x3 Gaussian densities
    of the sampled pose whose inverse covariances amplify the last-bit
    differences between the two backends' sin/cos/log/erf_inv. Resampling
    is off: an ancestor pick is discontinuous in the weights, so one
    rounding difference would swap whole particles."""
    cfg, slam_map = load_reference_like("webmap_like")
    cfg = cfg.replace(SWITCH_RESAMPLE=0)
    diffs = {}
    for method in ("FASTSLAM1", "FASTSLAM2"):
        def final(device):
            with jax.default_device(device):
                runner = Runner(cfg, slam_map, method, n_particles=P)
                sim = runner.sim.init(seed=3)
                est = runner.est.init(P)
                key = runner.sim.make_key(4)
                step = jax.jit(lambda c: runner._superstep(c, None)[0])
                carry = (sim, est, key)
                for _ in range(n_ticks // cfg.steps_per_observe):
                    carry = step(carry)
                return jax.device_get(carry[1])
        gpu, cpu = final(jax.devices()[0]), final(_cpu())
        _check(int(gpu.n) == int(cpu.n) > 0, f"{method}: landmark counts")
        logw_rtol = 1e-3 if method == "FASTSLAM2" else 1e-4
        for f, rtol in (("logw", logw_rtol), ("lm", 1e-4), ("lm_P", 1e-3)):
            np.testing.assert_allclose(getattr(gpu, f), getattr(cpu, f),
                                       rtol=rtol, atol=1e-5,
                                       err_msg=f"{method} {f}")
        diffs[method] = float(np.abs(gpu.lm - cpu.lm).max())
    return diffs


def phase_fastslam(fs1_particles: int = 1 << 20, fs2_particles: int = 1 << 17,
                   ticks: int = 256, ref_particles: int = 1024):
    with Phase(f"3 cli FASTSLAM1 p={fs1_particles}") as ph:
        ph.ate, mapped = run_cli("FASTSLAM1", fs1_particles, ticks, OUT_DIR)
        ph.extra = f"{mapped} landmarks mapped, {ticks} ticks"
    with Phase(f"3 Runner FASTSLAM2 p={fs2_particles}") as ph:
        cfg, slam_map = load_reference_like("webmap_like")
        result = Runner(cfg, slam_map, "FASTSLAM2",
                        n_particles=fs2_particles).run(seed=3, n_ticks=ticks)
        ph.ate = _ate(result)
        n = int(result.final_state.n)
        _check(n > 0, "FASTSLAM2: no landmark mapped")
        ph.extra = (f"{n} landmarks mapped, {ticks} ticks, "
                    f"{result.n_ticks / result.wall_seconds:.1f} ticks/s")
    with Phase("3 FASTSLAM1/2 gpu-vs-cpu") as ph:
        d = check_updates_match_cpu(ref_particles)
        ph.extra = "max |lm diff| " + ", ".join(
            f"{k} {v:.2e}" for k, v in d.items())


# ---------------------------------------------------------------------------
# 4. EKF at 10k landmarks
# ---------------------------------------------------------------------------

def run_sharded_ekf(devices, n_landmarks: int, supersteps: int,
                    seed: int = 3):
    from slam_tpu.parallel.ekf import ShardedEkfSlam
    from slam_tpu.runtime.config5 import config5_setup

    cfg, slam_map = config5_setup(n_landmarks, capacity=n_landmarks,
                                  max_obs=96)
    est = ShardedEkfSlam(cfg, slam_map.n_landmarks,
                         Mesh(np.asarray(devices), ("lm",)))
    return Runner(cfg, slam_map, "EKF1", estimator=est).run(
        seed=seed, n_ticks=supersteps * cfg.steps_per_observe)


def check_sharded_ekf_matches_dense(n_ticks: int = 30 * 8):
    """The row-sharded EKF against the dense EkfSlam it decomposes, on
    the card, at tests/test_parallel_ekf.py's tolerance (atol 5e-3)."""
    from slam_tpu.config import SlamConfig
    from slam_tpu.maps import synthetic_map
    from slam_tpu.parallel.ekf import ShardedEkfSlam

    slam_map = synthetic_map(16, 12, radius=40.0, seed=7)
    cfg = SlamConfig(SWITCH_HEADING_KNOWN=1, max_landmarks=16)
    dense = Runner(cfg, slam_map, "EKF1").run(seed=5, n_ticks=n_ticks)
    est = ShardedEkfSlam(cfg, slam_map.n_landmarks,
                         Mesh(np.asarray(jax.devices()[:1]), ("lm",)))
    sharded = Runner(cfg, slam_map, "EKF1", estimator=est).run(
        seed=5, n_ticks=n_ticks)
    np.testing.assert_allclose(sharded.est_pose, dense.est_pose, atol=5e-3)
    _check(int(sharded.final_state.n) == int(dense.final_state.n),
           "sharded and dense EKF map the same landmarks")
    return float(np.abs(sharded.est_pose - dense.est_pose).max())


def phase_ekf(n_landmarks: int = 10_000, supersteps: int = 16):
    with Phase(f"4 ShardedEkfSlam L={n_landmarks}") as ph:
        result = run_sharded_ekf(jax.devices()[:1], n_landmarks, supersteps)
        ph.ate = _ate(result)
        st = result.final_state
        _check(int(st.n) > 0, "EKF: no landmark mapped")
        _check(bool(jnp.isfinite(st.Pmm).all()), "EKF: non-finite Pmm")
        ph.extra = (f"{int(st.n)} landmarks mapped, Pmm {st.Pmm.shape}, "
                    f"{result.n_ticks / result.wall_seconds:.1f} ticks/s")
    with Phase("4 sharded-vs-dense EKF") as ph:
        ph.extra = f"max |pose diff| {check_sharded_ekf_matches_dense():.2e}"


# ---------------------------------------------------------------------------
# 5. Bundle adjustment at 10k landmarks x 256 keyframes
# ---------------------------------------------------------------------------

def phase_ba(n_keyframes: int = 256, n_landmarks: int = 10_000,
             iters: int = 30):
    from slam_tpu.posegraph import solve_ba_device
    from slam_tpu.posegraph.problems import make_ba_problem

    with Phase(f"5 BA T={n_keyframes} L={n_landmarks}") as ph:
        prob, poses, poses0, lms = make_ba_problem(n_keyframes, n_landmarks)
        p, _, info = solve_ba_device(prob, iters=iters, return_info=True)
        init_err = float(np.linalg.norm(poses0[:, :2] - poses[:, :2],
                                        axis=1).mean())
        err = float(np.linalg.norm(np.asarray(p)[:, :2] - poses[:, :2],
                                   axis=1).mean())
        # MAP floor: the same measurements, solved from truth.
        prob_t = dataclasses.replace(prob, poses0=jnp.asarray(poses),
                                     landmarks0=jnp.asarray(lms))
        p_t, _ = solve_ba_device(prob_t, iters=iters)
        floor = float(np.linalg.norm(np.asarray(p_t)[:, :2] - poses[:, :2],
                                     axis=1).mean())
        _check(err < 0.2 * init_err, f"BA error {err} vs initial {init_err}")
        _check(err < max(1.25 * floor, 0.05),
               f"BA error {err} vs MAP floor {floor}")
        ph.extra = (f"mean pose err {init_err:.3f} -> {err:.4f} m "
                    f"(MAP floor {floor:.4f} m), {info['n_steps']} LM trials")


# ---------------------------------------------------------------------------
# 6. The fused observe-update kernel against the plain path
# ---------------------------------------------------------------------------

def filter_like_update(P: int, L: int, K: int, seed: int = 0):
    """Arguments of rbpf.observe_update for a filter-like state: particles
    ~0.1 m around the origin, landmark means ~0.05 m around their true
    positions, half the landmarks live; of K observations half are
    matched (taken from the origin with the sensor's noise), a quarter
    new, a quarter masked off."""
    from slam_tpu.models import rbpf
    from slam_tpu.models.particles import init_particles

    rng = np.random.default_rng(seed)
    k = jax.random.split(jax.random.PRNGKey(seed), 3)
    n_live = L // 2
    ang = rng.uniform(-1.5, 1.5, L).astype(np.float32)
    rad = rng.uniform(3.0, 30.0, L).astype(np.float32)
    lm = (jnp.stack([rad * np.cos(ang), rad * np.sin(ang)])[..., None]
          + jax.random.normal(k[0], (2, L, P)) * 0.05)
    d = 0.05 + jax.random.uniform(k[1], (L, P)) * 0.1
    table = np.full(2 * L, -1, np.int32)
    table[:n_live] = np.arange(n_live)
    state = init_particles(P, L, 2 * L)._replace(
        logw=jnp.asarray(rng.normal(size=P).astype(np.float32)),
        xv=jax.random.normal(k[2], (3, P)) * jnp.array([[0.1], [0.1],
                                                        [0.01]]),
        lm=lm, lm_P=jnp.stack([d, jnp.full_like(d, 0.01), d]),
        n=jnp.int32(n_live), da_table=jnp.asarray(table))
    ids = np.concatenate([rng.choice(n_live, K // 2, replace=False),
                          n_live + np.arange(K - K // 2)]).astype(np.int32)
    zmask = np.arange(K) < K // 2 + K // 4
    idm = np.minimum(ids, L - 1)
    z = jnp.asarray(np.stack([rad[idm] + rng.normal(0.0, 0.1, K),
                              ang[idm] + rng.normal(0.0, 0.017, K)],
                             1).astype(np.float32))
    assoc, is_new = rbpf.associate_known(state, jnp.asarray(ids),
                                         jnp.asarray(zmask))
    matched = assoc >= 0
    slot_new, ok = rbpf.new_feature_slots(state.n, is_new, L)
    R = jnp.diag(jnp.asarray([0.01, 0.0003], jnp.float32))
    return (state, z, jnp.where(matched, assoc, 0), matched, slot_new, ok,
            R)


def _median_seconds(f, args, reps: int = 20) -> float:
    jax.block_until_ready(f(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def check_fused_update(P: int, L: int, K: int, reps: int = 20):
    """The Triton kernel against the plain jnp path (HIGHEST precision)
    on the card: rtol 1e-4/atol 1e-5 on logw and lm, rtol 1e-3 on lm_P.
    Returns the median wall of one call of each."""
    from slam_tpu.models import rbpf

    args = filter_like_update(P, L, K)
    plain = jax.jit(rbpf._plain_observe_update)
    fused = jax.jit(rbpf._fused_observe_update)
    with jax.default_matmul_precision("highest"):
        want = plain(*args)
        t_plain = _median_seconds(plain, args, reps)
    got = fused(*args)
    for f, rtol in (("logw", 1e-4), ("lm", 1e-4), ("lm_P", 1e-3)):
        np.testing.assert_allclose(np.asarray(getattr(got, f)),
                                   np.asarray(getattr(want, f)),
                                   rtol=rtol, atol=1e-5, err_msg=f)
    return t_plain, _median_seconds(fused, args, reps)


def phase_kernel(sizes=((1 << 20, 40, None), (32_768, 10_000, 96))):
    for P, L, K in sizes:
        if K is None:   # K as the webmap config sizes it
            cfg, slam_map = load_reference_like("webmap_like")
            K = Runner(cfg, slam_map, "FASTSLAM1").sim.max_obs
        with Phase(f"6 fused update P={P} L={L} K={K}") as ph:
            t_plain, t_fused = check_fused_update(P, L, K)
            ph.extra = (f"plain {t_plain * 1e3:.3f} ms, kernel "
                        f"{t_fused * 1e3:.3f} ms per call (median)")


# ---------------------------------------------------------------------------
# Four cards: each multi-device path against the same run on one card
# ---------------------------------------------------------------------------

def four_config5(n_particles: int = 1 << 20, capacity: int = 192,
                 n_landmarks: int = 10_000, supersteps: int = 32):
    """run_config5 on a (2, 2) mesh and on (1, 1). The simulator is the
    same, so keyframes and observed landmarks are equal; the particle
    noise streams differ by mesh, so the filters are compared by the
    criteria of tests/test_config5.py."""
    from slam_tpu.runtime.config5 import run_config5

    devs = jax.devices()
    res = {}
    for mesh, d in (((2, 2), devs[:4]), ((1, 1), devs[:1])):
        with Phase(f"four config5 mesh={mesh} p={n_particles}") as ph:
            r = run_config5(n_particles=n_particles, mesh_shape=mesh,
                            n_landmarks=n_landmarks, capacity=capacity,
                            n_supersteps=supersteps, rng_impl="rbg",
                            devices=d)
            ph.ate = r.ate_filter
            ph.extra = (f"refined ATE {r.ate_refined:.4f} m, "
                        f"{r.n_landmarks_observed} landmarks observed, "
                        f"{r.steps_per_second:.1f} ticks/s")
            _check(np.isfinite(r.ate_filter) and np.isfinite(r.ate_refined),
                   "finite ATE")
            _check(r.ate_refined < max(2.0 * r.ate_filter, 0.15),
                   "BA keeps the filter's accuracy")
            res[mesh] = r
    a, b = res[(2, 2)], res[(1, 1)]
    _check(a.n_keyframes == b.n_keyframes == supersteps,
           "same keyframes on both meshes")
    _check(a.n_landmarks_observed == b.n_landmarks_observed > 0,
           "same landmarks observed on both meshes")
    return a, b


def four_ekf(n_landmarks: int = 10_000, supersteps: int = 16):
    """ShardedEkfSlam on 4 cards against 1, at tests/test_parallel_ekf.py's
    tolerances (trajectory and mean atol 5e-3, pose block atol 5e-4)."""
    devs = jax.devices()
    with Phase(f"four ShardedEkfSlam L={n_landmarks} cards=4") as ph:
        r4 = run_sharded_ekf(devs[:4], n_landmarks, supersteps)
        ph.ate = _ate(r4)
        ph.extra = f"{r4.n_ticks / r4.wall_seconds:.1f} ticks/s"
    with Phase(f"four ShardedEkfSlam L={n_landmarks} cards=1") as ph:
        r1 = run_sharded_ekf(devs[:1], n_landmarks, supersteps)
        ph.ate = _ate(r1)
        s4, s1 = r4.final_state, r1.final_state
        np.testing.assert_allclose(r4.est_pose, r1.est_pose, atol=5e-3)
        _check(int(s4.n) == int(s1.n) > 0, "same landmarks mapped")
        np.testing.assert_allclose(np.asarray(s4.x), np.asarray(s1.x),
                                   atol=5e-3)
        np.testing.assert_allclose(np.asarray(s4.P00), np.asarray(s1.P00),
                                   atol=5e-4)
        np.testing.assert_allclose(np.asarray(jnp.diagonal(s4.Pmm)),
                                   np.asarray(jnp.diagonal(s1.Pmm)),
                                   atol=5e-3)
        d = float(np.abs(r4.est_pose - r1.est_pose).max())
        ph.extra = (f"{r1.n_ticks / r1.wall_seconds:.1f} ticks/s, "
                    f"max |pose diff| 4 vs 1 card {d:.2e}")
    return d


def four_ba(n_keyframes: int = 256, n_landmarks: int = 10_000,
            iters: int = 12):
    """solve_ba_sharded on 4 cards against solve_ba_device on 1, at the
    10k-landmark tolerances of tests/test_config5.py (poses atol 5e-3,
    landmarks atol 5e-2)."""
    from slam_tpu.posegraph import solve_ba_device, solve_ba_sharded
    from slam_tpu.posegraph.problems import make_ba_problem

    prob, poses, _, _ = make_ba_problem(n_keyframes, n_landmarks)
    with Phase(f"four BA sharded cards=4 L={n_landmarks}") as ph:
        mesh = Mesh(np.asarray(jax.devices()[:4]), ("l",))
        p4, l4 = solve_ba_sharded(prob, mesh, iters=iters)
        jax.block_until_ready(p4)
    with Phase(f"four BA device cards=1 L={n_landmarks}") as ph:
        p1, l1 = solve_ba_device(prob, iters=iters)
        np.testing.assert_allclose(np.asarray(p4), np.asarray(p1),
                                   atol=5e-3)
        np.testing.assert_allclose(np.asarray(l4), np.asarray(l1),
                                   atol=5e-2)
        d = float(np.abs(np.asarray(p4) - np.asarray(p1)).max())
        ph.extra = f"max |pose diff| 4 vs 1 card {d:.2e}"
    return d


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="slam_tpu smoke run on GPUs")
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device paths, 4 cards vs 1")
    args = ap.parse_args(argv)

    jax.monitoring.register_event_duration_secs_listener(_on_duration)
    enable_compile_cache()
    os.makedirs(OUT_DIR, exist_ok=True)
    devices = phase_device(4 if args.four_cards else 1)
    if args.four_cards:
        four_config5()
        four_ekf()
        four_ba()
        count = 4
    else:
        phase_cli()
        phase_fastslam()
        phase_ekf()
        phase_ba()
        phase_kernel()
        count = len(devices)
    print(Phase.card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
