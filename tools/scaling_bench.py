#!/usr/bin/env python3
"""Scaling benchmark: sharded FastSLAM steps/s vs mesh size.

Runs the sharded FastSLAM1 superstep on 1..N-device meshes with a fixed
PER-DEVICE particle count (weak scaling) and reports parallel efficiency.
On a multi-GPU host this measures real NVLink collectives; on a dev
machine, run with virtual devices to validate the sharding compiles and
scales structurally:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python tools/scaling_bench.py --platform cpu --particles 4096

Multi-host: launch one process per host with jax.distributed initialized
(slam_tpu.parallel.distributed.init_distributed) and pass --all-devices.
"""

from __future__ import annotations

import argparse
import json
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None)
    ap.add_argument("--particles", type=int, default=65536,
                    help="particles PER DEVICE (weak scaling)")
    ap.add_argument("--supersteps", type=int, default=20)
    ap.add_argument("--all-devices", action="store_true")
    args = ap.parse_args()

    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from slam_tpu.maps import load_reference_like
    from slam_tpu.parallel import ShardedFastSlam1, make_mesh
    from slam_tpu.runtime import Runner, compute_metrics

    cfg, slam_map = load_reference_like("webmap_like")

    n_dev = len(jax.devices())
    sizes = [n_dev] if args.all_devices else sorted(
        {1, 2, n_dev} & set(range(1, n_dev + 1)))
    results = []
    base = None
    for s in sizes:
        mesh = make_mesh(s)
        n_particles = args.particles * s
        est = ShardedFastSlam1(cfg, slam_map.n_landmarks, mesh,
                               n_particles)
        runner = Runner(cfg, slam_map, "FASTSLAM1", estimator=est)
        n_ticks = args.supersteps * cfg.steps_per_observe
        result = runner.run(seed=3, n_ticks=n_ticks)
        m = compute_metrics(result)
        pps = m.steps_per_second * n_particles
        if base is None:
            base = pps / s
        eff = pps / (s * base)
        results.append({"devices": s, "particles": n_particles,
                        "steps_per_sec": round(m.steps_per_second, 1),
                        "particle_steps_per_sec": round(pps, 1),
                        "weak_scaling_efficiency": round(eff, 3)})
        print(f"devices={s} particles={n_particles:,}: "
              f"{m.steps_per_second:,.0f} steps/s "
              f"({pps:,.3g} particle-steps/s, eff {eff:.2f})",
              file=sys.stderr)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
