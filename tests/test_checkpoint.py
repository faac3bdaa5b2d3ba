"""Checkpoint/resume: bit-exact continuation of a deterministic run."""

import numpy as np

from slam_tpu.runtime import Runner
from slam_tpu.runtime.checkpoint import load_checkpoint, save_checkpoint


def test_save_load_roundtrip(tmp_path, workload):
    cfg, slam_map = workload("loop1_like")
    runner = Runner(cfg, slam_map, "FASTSLAM1", n_particles=16)
    sim = runner.sim.init(seed=5)
    est = runner.est.init(16)
    import jax
    key = jax.random.PRNGKey(9)

    p = str(tmp_path / "ck")
    save_checkpoint(p, sim, est, key, superstep=7, meta={"x": 1})
    sim2, est2, key2, step = load_checkpoint(p, sim, est)
    assert step == 7
    for a, b in zip(jax.tree_util.tree_leaves(est),
                    jax.tree_util.tree_leaves(est2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(key), np.asarray(key2))


def test_resume_bit_exact(tmp_path, workload):
    """Interrupt after the first chunk, resume, and match the unbroken
    run's tail exactly."""
    cfg, slam_map = workload("loop1_like")

    def make():
        return Runner(cfg, slam_map, "FASTSLAM1", n_particles=16)

    period = cfg.steps_per_observe
    n_ticks = 40 * period
    ck_a = str(tmp_path / "a")
    full = make().run_checkpointed(seed=4, n_ticks=n_ticks, every=10,
                                   ckpt_path=ck_a)

    # "Interrupted" run: only the first 20 supersteps.
    ck_b = str(tmp_path / "b")
    make().run_checkpointed(seed=4, n_ticks=20 * period, every=10,
                            ckpt_path=ck_b)
    resumed = make().run_checkpointed(seed=4, n_ticks=n_ticks, every=10,
                                      ckpt_path=ck_b, resume=True)

    np.testing.assert_array_equal(full.est_pose[20:], resumed.est_pose)
    np.testing.assert_array_equal(full.true_pose[20:],
                                  resumed.true_pose)
