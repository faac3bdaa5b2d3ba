#!/usr/bin/env python3
"""Multi-host worker: one jax.distributed process of an N-process CPU
"pod" (each process contributes --local-devices virtual CPU devices to
one global mesh). Runs the sharded FastSLAM1 filter end-to-end over the
global particle mesh — cross-process psum (weight normalization / Neff)
and ppermute ring resampling ride the distributed runtime exactly as
they would ride the network between real hosts. CPU only: it pins
JAX_PLATFORMS=cpu, so several workers never share one GPU.

Launched by tests/test_multihost.py (2 processes x 4 devices) and usable
standalone, e.g.:

    python tools/multihost_worker.py --coordinator localhost:9911 \
        --num-processes 2 --process-id 0 --out /tmp/mh0.npz &
    python tools/multihost_worker.py --coordinator localhost:9911 \
        --num-processes 2 --process-id 1 --out /tmp/mh1.npz
"""

from __future__ import annotations

import argparse
import os
import sys


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--local-devices", type=int, default=4)
    ap.add_argument("--particles", type=int, default=4096)
    ap.add_argument("--supersteps", type=int, default=6)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default=None,
                    help="process 0 writes est/true trajectories here")
    args = ap.parse_args()

    # Platform setup must precede the first jax import.
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={args.local_devices}")
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

    from slam_tpu.parallel.distributed import init_distributed
    init_distributed(args.coordinator, args.num_processes,
                     args.process_id)

    import jax
    import numpy as np
    from slam_tpu.maps import load_reference_like
    from slam_tpu.parallel import ShardedFastSlam1, make_mesh
    from slam_tpu.runtime import Runner, compute_metrics

    n_global = args.num_processes * args.local_devices
    assert jax.device_count() == n_global, (jax.device_count(), n_global)
    assert jax.local_device_count() == args.local_devices

    cfg, slam_map = load_reference_like("webmap_like")
    mesh = make_mesh()
    est = ShardedFastSlam1(cfg, slam_map.n_landmarks, mesh,
                           n_particles=args.particles)
    runner = Runner(cfg, slam_map, "FASTSLAM1", estimator=est)
    n_ticks = args.supersteps * cfg.steps_per_observe
    result = runner.run(seed=args.seed, n_ticks=n_ticks)
    m = compute_metrics(result)
    print(f"[proc {args.process_id}/{args.num_processes}] "
          f"{n_global}-device mesh, {args.particles} particles: "
          f"{m.steps_per_second:,.2f} steps/s  ATE {m.ate_rmse:.4f} m",
          file=sys.stderr, flush=True)
    if args.out and jax.process_index() == 0:
        np.savez(args.out, est_pose=result.est_pose,
                 true_pose=result.true_pose, ate=m.ate_rmse)
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
