"""Estimators: EKF-SLAM, FastSLAM 1.0, FastSLAM 2.0.

Re-designs of the reference algorithms (src/backend/algorithms/):
struct-of-arrays fixed-capacity state, mask-driven landmark growth, vmapped
particle axes, jittable step functions.
"""

from slam_tpu.models.ekf import (
    EkfSlam,
    EKFState,
    ekf_augment,
    ekf_batch_update,
    ekf_data_associate,
    ekf_data_associate_known,
    ekf_init,
    ekf_observe_heading,
    ekf_predict,
    ekf_step,
)
from slam_tpu.models.fastslam1 import FastSlam1
from slam_tpu.models.fastslam2 import FastSlam2
from slam_tpu.models.particles import (
    ParticleState,
    estimate_position,
    gather_particles,
    init_particles,
)

ESTIMATORS = {
    "EKF1": EkfSlam,
    "EKF": EkfSlam,
    "FASTSLAM1": FastSlam1,
    "FASTSLAM2": FastSlam2,
}


def make_estimator(method: str, config, n_map_landmarks: int):
    """Method-string dispatch, mirroring SLAMBackendApplication's
    ``-method`` selection (SLAMBackendApplication.cpp:26-29: FASTSLAM1 /
    FASTSLAM2 / anything else -> EKF)."""
    cls = ESTIMATORS.get(method.upper(), EkfSlam)
    return cls(config, n_map_landmarks)


__all__ = [
    "EkfSlam",
    "EKFState",
    "ekf_init",
    "ekf_predict",
    "ekf_observe_heading",
    "ekf_data_associate",
    "ekf_data_associate_known",
    "ekf_batch_update",
    "ekf_augment",
    "ekf_step",
    "ParticleState",
    "init_particles",
    "estimate_position",
    "gather_particles",
    "FastSlam1",
    "FastSlam2",
    "ESTIMATORS",
    "make_estimator",
]
