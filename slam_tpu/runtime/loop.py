"""The run loop: one compiled scan over observation supersteps.

The reference's per-wrapper while-loops (ekfslamwrapper.cpp:47-108,
fastslam1wrapper.cpp:32-109, fastslam2wrapper.cpp:31-122) dispatch one
C++ iteration per control tick. Here a *superstep* = ``steps_per_observe``
control ticks + one observation/update, and the whole run is
``lax.scan(superstep, ...)`` — a single XLA program with no host round
trips, which is what makes steps/sec on the device meaningful.

Termination: the reference breaks its loop when waypoints are exhausted
(slamwrapper.cpp:177-190). A scan has a static trip count, so the runner
first measures the run length with a cheap sim-only rollout, then compiles
the full program for exactly that many supersteps; any tail ticks are
masked by the vehicle's ``done`` flag.
"""

from __future__ import annotations

import time
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from slam_tpu.config import SlamConfig
from slam_tpu.maps import SlamMap
from slam_tpu.models import make_estimator
from slam_tpu.sim.simulator import SimState, Simulator


class RunResult(NamedTuple):
    """Per-superstep traces (numpy, host-side) + final estimator state."""
    true_pose: np.ndarray      # [T, 3]
    est_pose: np.ndarray       # [T, 3]
    active: np.ndarray         # [T] bool — vehicle not yet done
    obs_count: np.ndarray      # [T] int32 visible landmarks
    obs_range_sum: np.ndarray  # [T] float32 sum of observed ranges
    obs_z: np.ndarray          # [T, max_obs, 2] noisy observations
    obs_mask: np.ndarray       # [T, max_obs] validity
    obs_ids: np.ndarray        # [T, max_obs] true landmark ids
    odom: np.ndarray           # [T, 3] dead-reckoned relative transform
                               # over each superstep (noisy controls)
    final_state: Any
    n_ticks: int
    wall_seconds: float        # full compiled-run wall time
    compile_seconds: float


def _freeze(done, new_tree, old_tree, touched: tuple | None = None):
    """where(done, old, new) per leaf. With ``touched`` (NamedTuple field
    names the transition may modify), untouched fields pass straight
    through — at 1M particles the landmark planes are ~700 MB and predict
    never writes them, so selecting on them per tick would dominate the
    superstep."""
    if touched is None:
        return jax.tree.map(
            lambda new, old: jnp.where(done, old, new),
            new_tree, old_tree)
    updates = {
        f: jax.tree.map(lambda new, old: jnp.where(done, old, new),
                        getattr(new_tree, f), getattr(old_tree, f))
        for f in touched if hasattr(new_tree, f)
    }
    return new_tree._replace(**updates)


class Runner:
    """Config + map + method bound run driver (the reference's
    SLAMBackendApplication + wrapper selection,
    SLAMBackendApplication.cpp:26-42)."""

    def __init__(self, config: SlamConfig, slam_map: SlamMap,
                 method: str = "EKF1", n_particles: int | None = None,
                 estimator=None, rng_impl: str | None = None):
        self.config = config
        self.map = slam_map
        self.method = method.upper()
        # rng_impl="rbg" switches every PRNG stream (sim noise, particle
        # sampling, resampling dither) to the hardware-fast generator.
        self.sim = Simulator(config, slam_map, rng_impl=rng_impl)
        # ``estimator``: prebuilt estimator override (e.g. a sharded
        # FastSlam from slam_tpu.parallel) sharing the same interface.
        self.est = estimator if estimator is not None else make_estimator(
            self.method, config, slam_map.n_landmarks)
        self.n_particles = n_particles
        self._compiled = None

    # ------------------------------------------------------------------
    def estimate_run_ticks(self, cap: int | None = None) -> int:
        """Sim-only rollout to find the tick at which the waypoint loops
        complete (the reference's control() == -1 condition)."""
        cfg = self.config
        if cap is None:
            wp = self.map.waypoints
            seg = np.linalg.norm(np.diff(np.vstack([wp, wp[:1]]), axis=0),
                                 axis=1).sum()
            cap = int(1.6 * cfg.NUMBER_LOOPS * seg / (cfg.V *
                                                      cfg.DT_CONTROLS)) + 64
        state = self.sim.init()
        _, _, dones = self.sim.rollout_controls(state, cap)
        dones = np.asarray(dones)
        idx = int(np.argmax(dones)) if dones.any() else cap
        period = cfg.steps_per_observe
        return max(period, ((idx + period - 1) // period) * period)

    # ------------------------------------------------------------------
    def _superstep(self, carry, _):
        sim_state, est_state, key = carry
        period = self.config.steps_per_observe
        ekf = getattr(self.est, "IS_EKF", False)

        def tick(c, _):
            sim_state, est_state, key, dr = c
            sim_state, controls = self.sim.control_step(sim_state)
            # Heading for the per-tick observe: EKF gets the noisy IMU
            # heading (ekfslamwrapper.cpp:81); FastSLAM gets truth
            # (fastslam1.cpp:63).
            if ekf:
                sim_state, phi = self.sim.heading_measurement(sim_state)
            else:
                phi = sim_state.vehicle.pose[2]
            key, sub = jax.random.split(key)
            est_state = self.est.predict(est_state, sub,
                                         controls.v_noisy,
                                         controls.g_noisy, phi)
            # Dead-reckoning odometry: integrate the NOISY controls from
            # the superstep origin — an independent relative-pose
            # measurement for the pose-graph refinement stage.
            from slam_tpu.sim.vehicle import predict_true_position
            dr = predict_true_position(dr, controls.v_noisy,
                                       controls.g_noisy,
                                       self.config.WHEELBASE,
                                       self.config.DT_CONTROLS)
            return (sim_state, est_state, key, dr), None

        dr0 = jnp.zeros(3, dtype=jnp.float32)
        (sim_state, est_state, key, dr), _ = jax.lax.scan(
            tick, (sim_state, est_state, key, dr0), None, length=period)

        sim_state, obs = self.sim.observe_step(sim_state)
        key, sub = jax.random.split(key)
        # No freeze-on-done: the estimator keeps stepping over the (at
        # most period-1) tail ticks past waypoint completion, and every
        # consumer masks by the recorded ``active`` flag instead. A
        # freeze (a lax.cond selecting old-vs-new state) would keep the
        # PRE-update state alive across the update and force XLA to copy
        # the full landmark planes each superstep, for a branch that only
        # ever fires on the final partial superstep.
        est_state = self.est.update(est_state, sub, obs.z, obs.ids,
                                    obs.mask)

        out = (sim_state.vehicle.pose,
               self.est.pose(est_state),
               ~sim_state.vehicle.done,
               obs.count,
               jnp.sum(jnp.where(obs.mask, obs.z[:, 0], 0.0)),
               obs.z,
               obs.mask,
               obs.ids,
               dr)
        return (sim_state, est_state, key), out

    def _build(self, n_supersteps: int):
        if getattr(self.est, "SCAN_PAIR", False) and n_supersteps >= 2:
            # TWO supersteps per scan body. An XLA while-loop pins each
            # carry buffer to one allocation; a body whose update writes
            # a FRESH buffer (e.g. the resample cond's gathered state)
            # forces a full copy back into the carry allocation every
            # iteration. With two supersteps per body the state flows
            # A -> B -> A: the second update's output lands back in the
            # carry allocation (A is dead once the first has read it)
            # and B is a body-local temp — no carry copies, and peak
            # memory stays at two state buffers.
            n_pairs, tail = divmod(n_supersteps, 2)

            def pair(carry, _):
                carry, o1 = self._superstep(carry, None)
                carry, o2 = self._superstep(carry, None)
                return carry, jax.tree.map(
                    lambda a, b: jnp.stack([a, b]), o1, o2)

            def program(sim_state: SimState, est_state, key):
                carry, outs = jax.lax.scan(
                    pair, (sim_state, est_state, key), None,
                    length=n_pairs)
                outs = jax.tree.map(
                    lambda x: x.reshape((-1,) + x.shape[2:]), outs)
                if tail:
                    carry, o = self._superstep(carry, None)
                    outs = jax.tree.map(
                        lambda x, t: jnp.concatenate([x, t[None]]),
                        outs, o)
                return carry, outs
            # Donated inputs: without donation the initial estimator
            # state is a third full state buffer the program must
            # preserve.
            return jax.jit(program, donate_argnums=(0, 1, 2))

        def program(sim_state: SimState, est_state, key):
            return jax.lax.scan(self._superstep,
                                (sim_state, est_state, key), None,
                                length=n_supersteps)
        return jax.jit(program, donate_argnums=(0, 1, 2))

    # ------------------------------------------------------------------
    def run(self, seed: int = 0, n_ticks: int | None = None) -> RunResult:
        cfg = self.config
        period = cfg.steps_per_observe
        if n_ticks is None:
            n_ticks = self.estimate_run_ticks()
        n_supersteps = n_ticks // period

        sim_state = self.sim.init(seed=seed or cfg.SWITCH_SEED_RANDOM)
        est_state = self.est.init(self.n_particles)
        key = self.sim.make_key(seed + 1)

        program = self._build(n_supersteps)
        t0 = time.perf_counter()
        lowered = program.lower(sim_state, est_state, key)
        compiled = lowered.compile()
        t1 = time.perf_counter()
        (_, final_est, _), outs = compiled(sim_state, est_state, key)
        jax.block_until_ready((final_est, outs))
        t2 = time.perf_counter()

        (true_pose, est_pose, active, obs_count, range_sum, z, zmask,
         ids, odom) = outs
        return RunResult(
            true_pose=np.asarray(true_pose),
            est_pose=np.asarray(est_pose),
            active=np.asarray(active),
            obs_count=np.asarray(obs_count),
            obs_range_sum=np.asarray(range_sum),
            obs_z=np.asarray(z),
            obs_mask=np.asarray(zmask),
            obs_ids=np.asarray(ids),
            odom=np.asarray(odom),
            final_state=final_est,
            n_ticks=n_supersteps * period,
            wall_seconds=t2 - t1,
            compile_seconds=t1 - t0,
        )

    # ------------------------------------------------------------------
    def run_checkpointed(self, seed: int = 0, n_ticks: int | None = None,
                         every: int = 50, ckpt_path: str = "ckpt/run",
                         resume: bool = False) -> RunResult:
        """Chunked run with periodic checkpoints: scans ``every``
        supersteps per compiled call, snapshotting the full run state
        between chunks (slam_tpu.runtime.checkpoint). With ``resume``,
        continues from the saved chunk — bit-exactly equal to the
        unbroken run (deterministic threefry streams)."""
        import os

        from slam_tpu.runtime.checkpoint import (
            load_checkpoint,
            save_checkpoint,
        )

        cfg = self.config
        period = cfg.steps_per_observe
        if n_ticks is None:
            n_ticks = self.estimate_run_ticks()
        n_supersteps = n_ticks // period

        sim_state = self.sim.init(seed=seed or cfg.SWITCH_SEED_RANDOM)
        est_state = self.est.init(self.n_particles)
        key = self.sim.make_key(seed + 1)
        start = 0
        if resume and os.path.exists(ckpt_path + ".json"):
            sim_state, est_state, key, start = load_checkpoint(
                ckpt_path, sim_state, est_state)

        def chunk_program(sim_state, est_state, key):
            return jax.lax.scan(self._superstep,
                                (sim_state, est_state, key), None,
                                length=every)

        chunk = jax.jit(chunk_program)
        all_outs = []
        t0 = time.perf_counter()
        done = start
        carry = (sim_state, est_state, key)
        while done < n_supersteps:
            carry, outs = chunk(*carry)
            jax.block_until_ready(outs)
            all_outs.append(jax.tree.map(np.asarray, outs))
            done += every
            save_checkpoint(ckpt_path, carry[0], carry[1], carry[2],
                            done, meta={"method": self.method,
                                        "seed": seed})
        wall = time.perf_counter() - t0

        cat = [np.concatenate([o[i] for o in all_outs])
               for i in range(9)]
        n_keep = n_supersteps - start
        cat = [c[:n_keep] for c in cat]
        return RunResult(
            true_pose=cat[0], est_pose=cat[1],
            active=cat[2].astype(bool), obs_count=cat[3],
            obs_range_sum=cat[4], obs_z=cat[5],
            obs_mask=cat[6].astype(bool), obs_ids=cat[7], odom=cat[8],
            final_state=carry[1], n_ticks=n_keep * period,
            wall_seconds=wall, compile_seconds=0.0)

    # ------------------------------------------------------------------
    def run_streaming(self, seed: int = 0, n_ticks: int | None = None,
                      plot=None, sim_name: str = "simulation"
                      ) -> RunResult:
        """Superstep-at-a-time host loop with live telemetry — the
        visualization path, protocol-compatible with the stock slam-gui
        (the reference wrappers' per-tick ZMQ emission,
        ekfslamwrapper.cpp:88-105). ``plot``: a
        slam_tpu.runtime.telemetry.NetworkPlot (or None for headless)."""
        from slam_tpu.runtime.stream import stream_run
        return stream_run(self, seed=seed, n_ticks=n_ticks, plot=plot,
                          sim_name=sim_name)
