"""Quickstart: run each estimator on an in-repo map (default: the
webmap-shaped data/webmap_like.mat), refine with the pose-graph BA stage,
and write a DataGatherer-style report.

    python examples/quickstart.py [map.mat]
"""

import sys

import numpy as np

from slam_tpu.config import SlamConfig
from slam_tpu.maps import load_reference_like, read_map_file
from slam_tpu.posegraph import problem_from_run, solve_ba
from slam_tpu.runtime import Runner, compute_metrics, write_report


def main():
    if len(sys.argv) > 1:
        map_path = sys.argv[1]
        slam_map = read_map_file(map_path)
        cfg = SlamConfig.from_ini(map_path.rsplit(".", 1)[0] + ".ini")
    else:
        cfg, slam_map = load_reference_like("webmap_like")

    for method, n_particles in [("EKF1", None), ("FASTSLAM1", 100),
                                ("FASTSLAM2", 100)]:
        runner = Runner(cfg, slam_map, method, n_particles=n_particles)
        result = runner.run(seed=7)
        m = compute_metrics(result)
        print(f"{method:10s} {m.summary()}")
        write_report(result, f"quickstart_{method.lower()}")

    # Offline trajectory refinement over the FastSLAM1 run's keyframes.
    runner = Runner(cfg, slam_map, "FASTSLAM1", n_particles=100)
    result = runner.run(seed=7)
    prob = problem_from_run(result, cfg)
    poses, landmarks = solve_ba(prob, iters=8)
    act = result.active
    before = np.linalg.norm(result.est_pose[act, :2]
                            - result.true_pose[act, :2], axis=1)
    after = np.linalg.norm(np.asarray(poses)[:, :2]
                           - result.true_pose[act, :2], axis=1)
    print(f"BA refinement: RMSE {np.sqrt((before**2).mean()):.3f} m -> "
          f"{np.sqrt((after**2).mean()):.3f} m")


if __name__ == "__main__":
    main()
