import jax
import jax.numpy as jnp
import numpy as np

from slam_tpu.config import SlamConfig
from slam_tpu.sim import Simulator, observe
from slam_tpu.sim.sensors import range_bearing, visible_mask
from slam_tpu.sim.vehicle import init_vehicle, predict_true_position, steer_and_move


def test_predict_true_position_straight():
    pose = jnp.zeros(3)
    out = np.asarray(predict_true_position(pose, 2.0, 0.0, 4.0, 0.5))
    np.testing.assert_allclose(out, [1.0, 0.0, 0.0], atol=1e-6)


def test_predict_true_position_turn():
    # One step with steering: heading rate = V sin(G) / wheelbase
    pose = jnp.zeros(3)
    out = np.asarray(predict_true_position(pose, 1.0, np.pi / 6, 1.0, 0.1))
    np.testing.assert_allclose(out[2], 0.1 * np.sin(np.pi / 6), atol=1e-6)


def test_visibility_semicircle():
    pose = jnp.array([0.0, 0.0, 0.0])  # facing +x
    lms = jnp.array([
        [5.0, 0.0],    # ahead, visible
        [-5.0, 0.0],   # behind, not visible
        [0.0, 5.0],    # exactly sideways, dot == 0 -> not visible
        [50.0, 0.0],   # ahead but out of range
        [3.0, 3.0],    # ahead-diagonal, visible
    ])
    mask = np.asarray(visible_mask(lms, pose, 10.0))
    np.testing.assert_array_equal(mask, [True, False, False, False, True])


def test_range_bearing_values():
    pose = jnp.array([1.0, 1.0, np.pi / 2])
    z = np.asarray(range_bearing(jnp.array([[1.0, 5.0]]), pose))
    np.testing.assert_allclose(z[0, 0], 4.0, atol=1e-6)
    np.testing.assert_allclose(z[0, 1], 0.0, atol=1e-6)


def test_observe_compaction_order():
    pose = jnp.array([0.0, 0.0, 0.0])
    lms = jnp.array([[5.0, 0.0], [-5.0, 0.0], [6.0, 1.0], [7.0, -1.0]])
    obs = observe(lms, pose, 10.0, max_obs=4)
    ids = np.asarray(obs.ids)
    mask = np.asarray(obs.mask)
    # visible landmarks 0, 2, 3 compacted in index order
    assert list(ids[mask]) == [0, 2, 3]
    assert int(obs.count) == 3


def test_observe_noise_statistics():
    pose = jnp.array([0.0, 0.0, 0.0])
    lms = jnp.array([[10.0, 0.0]])
    keys = jax.random.split(jax.random.PRNGKey(7), 300)
    obs = jax.vmap(lambda k: observe(lms, pose, 30.0, max_obs=1, key=k,
                                     sigma_r=0.1, sigma_b=0.02))(keys)
    zs = np.asarray(obs.z[:, 0])
    assert abs(zs[:, 0].mean() - 10.0) < 0.03
    assert abs(zs[:, 0].std() - 0.1) < 0.03
    assert abs(zs[:, 1].std() - 0.02) < 0.006


def test_simulator_full_run_loop1(loop1_config, loop1_map):
    """Waypoint following completes the course: the truth trajectory visits
    every waypoint within AT_WAYPOINT over NUMBER_LOOPS loops."""
    cfg = loop1_config.replace(SWITCH_CONTROL_NOISE=0, SWITCH_SENSOR_NOISE=0)
    sim = Simulator(cfg, loop1_map)
    state = sim.init(seed=1)

    state, poses, dones = jax.jit(
        sim.rollout_controls, static_argnums=1)(state, 40000)
    dones = np.asarray(dones)
    assert dones[-1], "run did not terminate"
    poses = np.asarray(poses)[~dones, :2]

    wps = loop1_map.waypoints
    d = np.linalg.norm(poses[:, None, :] - wps[None, :, :], axis=-1)
    # every waypoint approached within 2x AT_WAYPOINT at some tick
    assert float(d.min(axis=0).max()) < 2.0 * cfg.AT_WAYPOINT


def test_simulator_done_is_absorbing(loop1_config, loop1_map):
    cfg = loop1_config.replace(SWITCH_CONTROL_NOISE=0, NUMBER_LOOPS=1)
    sim = Simulator(cfg, loop1_map)
    state = sim.init(seed=1)
    state, _, dones = jax.jit(
        sim.rollout_controls, static_argnums=1)(state, 40000)
    assert bool(np.asarray(dones)[-1])
    pose = np.asarray(state.vehicle.pose)
    state2, _ = jax.jit(sim.control_step)(state)
    np.testing.assert_array_equal(np.asarray(state2.vehicle.pose), pose)


def test_run_length_matches_reference(workload):
    """Tick-count oracle: on each reference-shaped map the waypoint-loop
    run length (control() returning -1, slamwrapper.cpp:174-238) lands
    within 5% of NUMBER_LOOPS laps of the waypoint polygon at speed V.
    The maps' loop lengths come from the reference backend's own run
    lengths on its maps (ref_baseline.json ``*_run_ticks``), so this also
    keeps the workloads at the reference's size. Catches steering,
    termination, and dt drift cheaply."""
    from slam_tpu.runtime import Runner

    for mapname in ("loop1_like", "loop2_like", "loop902_like",
                    "webmap_like"):
        cfg, m = workload(mapname)
        wp = np.vstack([m.waypoints, m.waypoints[:1]])
        lap = np.linalg.norm(np.diff(wp, axis=0), axis=1).sum()
        want = cfg.NUMBER_LOOPS * lap / (cfg.V * cfg.DT_CONTROLS)
        got = Runner(cfg, m, "EKF1").estimate_run_ticks()
        assert abs(got - want) <= 0.05 * want, (mapname, got, want)
