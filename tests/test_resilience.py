"""Failure recovery: a crash mid-run resumes from checkpoint and ends
bit-exactly where the uninterrupted run would."""

import numpy as np

from slam_tpu.runtime import Runner
from slam_tpu.runtime.resilience import run_resilient


class FlakyRunner(Runner):
    """Crashes on the first run_checkpointed call after the first chunk
    is saved."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.crashes_left = 1

    def run_checkpointed(self, **kw):
        if self.crashes_left and not kw.get("resume"):
            # Save one chunk, then die.
            self.crashes_left -= 1
            try:
                super().run_checkpointed(**{**kw, "n_ticks":
                                            10 * self.config.steps_per_observe})
            finally:
                raise RuntimeError("injected failure")
        return super().run_checkpointed(**kw)


def test_run_resilient_recovers(tmp_path, workload):
    cfg, slam_map = workload("loop1_like")
    period = cfg.steps_per_observe
    n_ticks = 30 * period

    clean = Runner(cfg, slam_map, "FASTSLAM1", n_particles=16)
    ref = clean.run_checkpointed(seed=4, n_ticks=n_ticks, every=10,
                                 ckpt_path=str(tmp_path / "clean"))

    flaky = FlakyRunner(cfg, slam_map, "FASTSLAM1", n_particles=16)
    got = run_resilient(flaky, seed=4, n_ticks=n_ticks, every=10,
                        ckpt_path=str(tmp_path / "flaky"),
                        backoff_s=0.0)
    # The resumed run covers supersteps 10..30; its final poses match
    # the clean run's tail exactly.
    np.testing.assert_array_equal(ref.est_pose[-len(got.est_pose):],
                                  got.est_pose)
