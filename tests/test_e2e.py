"""End-to-end seeded replays on the in-repo reference-shaped maps: every
method x map must stay within an absolute ATE bound. Statistical, not
trace-identical, per SURVEY.md §7 hard-part e.

The bounds are absolute because the reference's own C++ ATE anchors
(ref_baseline.json) describe its maps, which are not in this repository.
Each bound is at least 2x the seed-RMS ATE measured on the CPU (numbers
in the comment beside each row), so a failure signals a regression, not
noise. Rows with a large per-seed spread assert an RMS over three seeds.
"""

import numpy as np
import pytest

from slam_tpu.runtime import Runner, compute_metrics, write_report

# (method, map, n_particles, n_ticks, seeds, bound in m)
CASES = [
    # Measured seed-RMS ATE on the CPU in the trailing comment.
    ("EKF1", "loop1_like", None, 2400, (7,), 0.65),            # 0.317
    ("FASTSLAM1", "loop1_like", 60, 2400, (7,), 2.0),          # 0.978
    ("FASTSLAM2", "loop1_like", 60, 4800, (7, 11, 23), 0.35),  # 0.164
    ("EKF1", "webmap_like", None, 2400, (7,), 1.25),           # 0.622
    ("FASTSLAM1", "webmap_like", 60, 2400, (7, 11, 23), 3.2),  # 1.561
    ("FASTSLAM2", "webmap_like", 60, 2400, (7, 11, 23), 1.25),  # 0.620
    ("FASTSLAM2", "loop2_like", 60, 4800, (7, 11, 23), 0.45),  # 0.220
    ("EKF1", "loop2_like", None, 4800, (7, 11, 23), 0.9),      # 0.436
    ("FASTSLAM1", "loop902_like", 60, 2400, (7,), 1.6),        # 0.780
    ("EKF1", "loop902_like", None, 1600, (7,), 0.6),           # 0.288
]


@pytest.mark.parametrize(
    "method,mapname,n_particles,n_ticks,seeds,bound", CASES)
def test_ate_within_bound(workload, method, mapname, n_particles,
                          n_ticks, seeds, bound):
    cfg, slam_map = workload(mapname)
    ates = []
    for seed in seeds:
        runner = Runner(cfg, slam_map, method, n_particles=n_particles)
        result = runner.run(seed=seed, n_ticks=n_ticks)
        m = compute_metrics(result)
        assert np.isfinite(m.ate_rmse), \
            f"{method}/{mapname}/seed={seed}: non-finite ATE"
        ates.append(m.ate_rmse)
    ate = float(np.sqrt(np.mean(np.square(ates))))
    assert ate < bound, (
        f"{method}/{mapname}: ATE {ate:.3f} m (seeds {list(seeds)}: "
        f"{[round(a, 3) for a in ates]}) >= bound {bound} m")
    # The run must actually do SLAM: landmarks were mapped.
    assert int(result.final_state.n) > 0


def test_deterministic_replay(workload):
    """Same seed -> identical trajectory (SWITCH_SEED_RANDOM semantics,
    slamwrapper.cpp:48-52, with jax.random keys)."""
    cfg, slam_map = workload("loop1_like")
    r1 = Runner(cfg, slam_map, "FASTSLAM1", n_particles=30).run(
        seed=5, n_ticks=800)
    r2 = Runner(cfg, slam_map, "FASTSLAM1", n_particles=30).run(
        seed=5, n_ticks=800)
    np.testing.assert_array_equal(r1.est_pose, r2.est_pose)
    np.testing.assert_array_equal(r1.true_pose, r2.true_pose)


def test_write_report(tmp_path, workload):
    cfg, slam_map = workload("loop1_like")
    result = Runner(cfg, slam_map, "EKF1").run(seed=1, n_ticks=400)
    out = write_report(result, "sim_test", str(tmp_path))
    import os
    for f in ("results.txt", "errors.txt", "times.txt", "positions.txt",
              "observedCounts.txt", "averageLengthLandmark.txt"):
        assert os.path.exists(os.path.join(out, f)), f
    errors = np.loadtxt(os.path.join(out, "errors.txt"))
    pos = np.loadtxt(os.path.join(out, "positions.txt"), delimiter=",")
    assert errors.shape[0] == pos.shape[0]


def test_rbg_rng_impl_runs(workload):
    """The fast-RNG path (rng_impl='rbg') produces a sane run."""
    cfg, slam_map = workload("loop1_like")
    r = Runner(cfg, slam_map, "FASTSLAM1", n_particles=30,
               rng_impl="rbg").run(seed=5, n_ticks=800)
    m = compute_metrics(r)
    assert np.isfinite(m.ate_rmse) and m.ate_rmse < 3.0


def test_time_phases_smoke(workload):
    from slam_tpu.runtime.profiling import time_phases
    cfg, slam_map = workload("loop1_like")
    runner = Runner(cfg, slam_map, "FASTSLAM1", n_particles=16)
    t = time_phases(runner, iters=2)
    assert t["predict_tick_s"] > 0 and t["observe_update_s"] > 0
    assert t["steps_per_observe"] == cfg.steps_per_observe
