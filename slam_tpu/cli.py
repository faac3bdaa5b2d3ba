"""Command-line shell: the slam-backend application.

Flag-compatible with the reference backend (SLAMBackendApplication.cpp:
44-57 printUsage): ``-m <map.mat>``, ``-n <name>``, ``-mode
waypoints|interactive``, ``-method EKF1|FASTSLAM1|FASTSLAM2``, plus ANY
config key as ``-KEY value`` (utils.cpp:1032-1046, e.g.
``-SWITCH_HEADING_KNOWN 0``). The matching ``<map>.ini`` is loaded
automatically like the reference (SLAMBackendApplication.cpp:78-81).

Extensions over the reference:
  -particles N   particle count override (reference: NPARTICLES key)
  -ticks N       cap the number of control ticks
  -plot          stream telemetry to a running slam-gui (tcp://:4242)
  -out DIR       write the DataGatherer-format report (default '.')
  -seed N        PRNG seed (reference: SWITCH_SEED_RANDOM key)
"""

from __future__ import annotations

import os
import sys

from slam_tpu.config import SlamConfig, apply_cli_overrides
from slam_tpu.maps import read_map_file


USAGE = """\
slam_tpu backend — landmark SLAM in JAX
Usage: python -m slam_tpu [options]
    -m <file>        map file (.mat text format)
    -n <name>        simulation name (report directory)
    -mode <mode>     waypoints (interactive not supported headless)
    -method <name>   EKF1 | FASTSLAM1 | FASTSLAM2
    -particles <N>   particle count (FastSLAM)
    -ticks <N>       max control ticks
    -seed <N>        PRNG seed
    -plot            stream ZMQ telemetry to a running slam-gui
    -profile <dir>   capture a jax device profile into <dir>
    -ckpt <path>     checkpoint path prefix (enables chunked run+resume)
    -out <dir>       report output directory (default .)
    -KEY <value>     override any config key (e.g. -SWITCH_HEADING_KNOWN 0)
    -h               this help
"""


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "-h" in argv or "--help" in argv:
        print(USAGE)
        return 0

    use_plot = "-plot" in argv
    # Value-less switches must not swallow the next token in the
    # reference-style "-KEY value" pairing.
    argv = [a for a in argv if a != "-plot"]
    flags = apply_cli_overrides(argv)

    map_path = flags.pop("m", None)
    if not map_path:
        print("error: no map file (-m)", file=sys.stderr)
        print(USAGE)
        return 2
    sim_name = flags.pop("n", "simulation")
    mode = flags.pop("mode", "waypoints")
    method = flags.pop("method", "EKF1")
    n_particles = flags.pop("particles", None)
    n_ticks = flags.pop("ticks", None)
    seed = int(flags.pop("seed", 0))
    out_dir = flags.pop("out", ".")
    profile_dir = flags.pop("profile", None)
    ckpt_path = flags.pop("ckpt", None)
    flags.pop("plot", None)

    if mode != "waypoints":
        print(f"warning: mode {mode!r} not supported; using waypoints",
              file=sys.stderr)

    ini = os.path.splitext(map_path)[0] + ".ini"
    if os.path.exists(ini):
        config = SlamConfig.from_ini(ini, overrides=flags)
    else:
        config = SlamConfig.from_mapping(flags)
    slam_map = read_map_file(map_path)

    from slam_tpu.runtime import Runner, compute_metrics, write_report
    from slam_tpu.runtime.device import enable_compile_cache
    enable_compile_cache()
    runner = Runner(config, slam_map, method,
                    n_particles=int(n_particles) if n_particles else None)

    print(f"slam_tpu {method} on {map_path} "
          f"({slam_map.n_landmarks} landmarks, "
          f"{slam_map.n_waypoints} waypoints)", file=sys.stderr)

    import contextlib

    profiler = contextlib.nullcontext()
    if profile_dir:
        from slam_tpu.runtime.profiling import trace
        profiler = trace(profile_dir)

    nt = int(n_ticks) if n_ticks else None
    with profiler:
        if use_plot:
            # Prefer the native C++ publisher; fall back to ctypes-Python.
            try:
                from slam_tpu.runtime.native import NativeNetworkPlot
                plot = NativeNetworkPlot()
            except OSError:
                from slam_tpu.runtime.telemetry import NetworkPlot
                plot = NetworkPlot()
            result = runner.run_streaming(seed=seed, plot=plot,
                                          sim_name=sim_name, n_ticks=nt)
            plot.close()
        elif ckpt_path:
            result = runner.run_checkpointed(seed=seed, n_ticks=nt,
                                             ckpt_path=ckpt_path,
                                             resume=True)
        else:
            result = runner.run(seed=seed, n_ticks=nt)

    metrics = compute_metrics(result)
    print(metrics.summary(), file=sys.stderr)
    path = write_report(result, sim_name, out_dir)
    print(f"report: {path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
