"""The simulation driver: truth propagation + noisy controls + observations.

Functional core of the reference's SLAMWrapper main loops
(wrappers/slamwrapper.cpp:174-238 plus the per-wrapper run() loops):
each control tick produces (noisy V, noisy G); every
``steps_per_observe``-th tick additionally produces a noisy fixed-capacity
observation batch. All methods are jit-compatible; the time loop itself is
host-side or ``lax.scan`` (see slam_tpu.runtime.loop).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from slam_tpu.config import SlamConfig
from slam_tpu.maps import SlamMap
from slam_tpu.sim.sensors import Observation, observe
from slam_tpu.sim.vehicle import VehicleState, init_vehicle, steer_and_move


class SimState(NamedTuple):
    vehicle: VehicleState
    key: jnp.ndarray        # PRNG key threaded through noise draws
    tick: jnp.ndarray       # scalar int32 control tick counter


class Controls(NamedTuple):
    """Per-tick control outputs: truth values and the noisy copies fed to
    the estimator (slamwrapper.cpp:229-237)."""
    v_true: jnp.ndarray
    g_true: jnp.ndarray
    v_noisy: jnp.ndarray
    g_noisy: jnp.ndarray


class Simulator:
    """Static-shape simulation program for one (config, map) pair.

    The PRNG is jax.random threefry (keys split per tick), replacing the
    reference's global std::rand Box-Muller stream (core.cpp:383-431);
    SWITCH_SEED_RANDOM maps to the root key seed.
    """

    def __init__(self, config: SlamConfig, slam_map: SlamMap,
                 rng_impl: str | None = None):
        self.config = config
        self.landmarks = jnp.asarray(slam_map.landmarks, dtype=jnp.float32)
        self.waypoints = jnp.asarray(slam_map.waypoints, dtype=jnp.float32)
        self.max_obs = config.max_observations or _default_max_obs(
            slam_map, config.MAX_RANGE)
        # RNG implementation: None = jax default (threefry; fully
        # reproducible across versions). "rbg" uses XLA's own bit
        # generator, which draws fewer operations per random word.
        self.rng_impl = rng_impl

    def make_key(self, seed: int):
        if self.rng_impl:
            return jax.random.key(seed, impl=self.rng_impl)
        return jax.random.PRNGKey(seed)

    # -- state ---------------------------------------------------------
    def init(self, seed: int | None = None) -> SimState:
        seed = self.config.SWITCH_SEED_RANDOM if seed is None else seed
        return SimState(
            vehicle=init_vehicle(self.config.NUMBER_LOOPS),
            key=self.make_key(seed),
            tick=jnp.int32(0),
        )

    # -- per-tick transitions -------------------------------------------
    def control_step(self, state: SimState) -> tuple[SimState, Controls]:
        """Advance truth one control tick and draw noisy controls."""
        cfg = self.config
        vehicle = steer_and_move(
            state.vehicle, self.waypoints,
            V=cfg.V, wheelbase=cfg.WHEELBASE, dt=cfg.DT_CONTROLS,
            at_waypoint=cfg.AT_WAYPOINT, rateg=cfg.RATEG, maxg=cfg.MAXG)

        key, sub = jax.random.split(state.key)
        if cfg.SWITCH_CONTROL_NOISE:
            # addControlNoise = chol(Q) @ randn + (V, G) with diagonal Q
            # (core.cpp:24-32, 452-458).
            sigmas = jnp.sqrt(jnp.asarray(cfg.Q, dtype=jnp.float32))
            noise = jax.random.normal(sub, (2,), dtype=jnp.float32) * sigmas
        else:
            noise = jnp.zeros(2, dtype=jnp.float32)

        controls = Controls(
            v_true=jnp.float32(cfg.V),
            g_true=vehicle.steer,
            v_noisy=cfg.V + noise[0],
            g_noisy=vehicle.steer + noise[1],
        )
        return SimState(vehicle=vehicle, key=key,
                        tick=state.tick + 1), controls

    def observe_step(self, state: SimState) -> tuple[SimState, Observation]:
        """Draw a (noisy) fixed-capacity observation batch at the current
        truth pose (ekfslamwrapper.cpp:64-78)."""
        cfg = self.config
        key, sub = jax.random.split(state.key)
        obs = observe(
            self.landmarks, state.vehicle.pose, cfg.MAX_RANGE,
            self.max_obs,
            key=sub if cfg.SWITCH_SENSOR_NOISE else None,
            sigma_r=float(np.sqrt(cfg.R[0])),
            sigma_b=float(np.sqrt(cfg.R[1])))
        return SimState(vehicle=state.vehicle, key=key,
                        tick=state.tick), obs

    def heading_measurement(self, state: SimState) -> tuple[SimState, jnp.ndarray]:
        """Noisy IMU heading fed to observeHeading paths. The reference
        uses xTrue(2) + sigmaT * unifRand() (ekfslamwrapper.cpp:81) — a
        uniform [0,1) draw scaled by sigmaT; we keep that distribution."""
        key, sub = jax.random.split(state.key)
        phi = state.vehicle.pose[2] + self.config.sigmaT * jax.random.uniform(
            sub, dtype=jnp.float32)
        return SimState(vehicle=state.vehicle, key=key,
                        tick=state.tick), phi


    # -- rollout helper ---------------------------------------------------
    def rollout_controls(self, state: SimState, n_steps: int):
        """Scan ``n_steps`` control ticks, returning (final_state, poses
        [n_steps, 3], dones [n_steps]). Compiles once; used by tests and
        ground-truth trace generation."""
        def body(s, _):
            s, _controls = self.control_step(s)
            return s, (s.vehicle.pose, s.vehicle.done)

        final, (poses, dones) = jax.lax.scan(body, state, None,
                                             length=n_steps)
        return final, poses, dones


def _default_max_obs(slam_map: SlamMap, max_range: float) -> int:
    """Capacity heuristic: upper-bound visible landmarks by a scan over
    the map at every waypoint plus densest disk, rounded up for safety.
    Cheap, host-side, deterministic."""
    lm = slam_map.landmarks
    best = 0
    for wp in slam_map.waypoints:
        d = lm - wp[None, :]
        inside = int(np.sum(np.sum(d * d, axis=-1) < max_range * max_range))
        best = max(best, inside)
    # visibility is a half-disk, but poses move between waypoints: keep
    # the full-disk bound and add headroom.
    return min(lm.shape[0], max(8, int(best * 1.25) + 2))
