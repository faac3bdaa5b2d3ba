#!/usr/bin/env python3
"""Multi-host weak-scaling sweep (BASELINE.md "1 chip / 1 host / N>=2
hosts" row): launches 1, 2, and 4 real ``jax.distributed`` processes
(each contributing --local-devices virtual CPU devices to one global
mesh) running the sharded FastSLAM1 filter with a FIXED per-device
particle count, and reports parallel efficiency.

The "hosts" are processes on one box, each pinned to the CPU, so the
numbers measure the distributed runtime's cross-process collective path
(gRPC between processes — the same code path that rides the network
between real hosts) under shared-core contention; they validate the
scaling STRUCTURE, not interconnect bandwidth. It is a CPU-only
rehearsal: several JAX processes must not share one GPU.

    python tools/multihost_scaling.py --per-device 8192 --supersteps 12
"""

from __future__ import annotations

import argparse
import json
import os
import re
import socket
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def run_config(nproc: int, local_devices: int, per_device: int,
               supersteps: int, seed: int) -> dict:
    port = _free_port()
    n_global = nproc * local_devices
    particles = per_device * n_global
    procs = []
    # Same env surgery as tests/test_multihost.py: the worker sets the
    # platform and its device count itself before importing jax.
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS",
                        "JAX_NUM_THREADS")}
    env["PYTHONPATH"] = os.path.dirname(HERE)
    ncores = os.cpu_count() or 1
    for pid in range(nproc):
        # Pin each "host" to its own core: XLA-CPU's intra-op thread
        # pool otherwise lets a single process consume every core,
        # which makes the 1-process baseline an unfair (whole-machine)
        # denominator for the weak-scaling ratio.
        import shutil
        taskset = shutil.which("taskset")
        if taskset:
            pin = [taskset, "-c", str(pid % ncores)]
        else:
            pin = []
            print("WARNING: taskset not found — core pinning disabled;"
                  " the 1-process baseline gets the whole machine and"
                  " efficiency ratios will be skewed", file=sys.stderr)
        cmd = pin + [sys.executable, WORKER,
               "--coordinator", f"localhost:{port}",
               "--num-processes", str(nproc),
               "--process-id", str(pid),
               "--local-devices", str(local_devices),
               "--particles", str(particles),
               "--supersteps", str(supersteps),
               "--seed", str(seed)]
        procs.append(subprocess.Popen(cmd, env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE,
                                      text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=900)
            outs.append(err)
            if p.returncode != 0:
                raise RuntimeError(
                    f"worker rc={p.returncode}:\n{err[-2000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    m = re.search(r"([\d,]+(?:\.\d+)?) steps/s", outs[0])
    if m is None:
        raise RuntimeError("worker produced no 'steps/s' line; stderr:\n"
                           + outs[0][-2000:])
    steps_per_sec = float(m.group(1).replace(",", ""))
    return {"processes": nproc, "devices": n_global,
            "particles": particles,
            "steps_per_sec": steps_per_sec,
            "particle_steps_per_sec": steps_per_sec * particles}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--per-device", type=int, default=8192,
                    help="particles per device (weak scaling)")
    ap.add_argument("--local-devices", type=int, default=2)
    ap.add_argument("--supersteps", type=int, default=12)
    ap.add_argument("--procs", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()

    rows = []
    for nproc in args.procs:
        r = run_config(nproc, args.local_devices, args.per_device,
                       args.supersteps, args.seed)
        # Efficiency is anchored to the SINGLE-process row when one
        # was measured; otherwise the first row is the (labeled)
        # baseline — "--procs 2 4" would previously report the
        # 2-process row as efficiency 1.0 with no indication.
        if rows:
            anchor = next((x for x in rows if x["processes"] == 1),
                          rows[0])
            base = (anchor["particle_steps_per_sec"]
                    / anchor["devices"])
            r["weak_scaling_efficiency"] = round(
                r["particle_steps_per_sec"] / (r["devices"] * base), 3)
            r["efficiency_baseline_procs"] = anchor["processes"]
        else:
            r["weak_scaling_efficiency"] = 1.0
            r["efficiency_baseline_procs"] = nproc
            if nproc != 1:
                print(f"NOTE: no 1-process row; efficiency anchored to "
                      f"the {nproc}-process row", file=sys.stderr)
        rows.append(r)
        print(f"procs={r['processes']} devices={r['devices']} "
              f"particles={r['particles']:,}: "
              f"{r['steps_per_sec']:,.0f} steps/s "
              f"({r['particle_steps_per_sec']:,.3g} particle-steps/s, "
              f"eff {r['weak_scaling_efficiency']:.2f})",
              file=sys.stderr, flush=True)
    print(json.dumps(rows))


if __name__ == "__main__":
    main()
