"""Unit tests for the estimator building blocks (EKF pieces, RBPF
pieces) against small closed-form scenarios."""

import jax.numpy as jnp
import numpy as np

from slam_tpu.models import (
    EKFState,
    ekf_augment,
    ekf_batch_update,
    ekf_data_associate,
    ekf_data_associate_known,
    ekf_init,
    ekf_observe_heading,
    ekf_predict,
    init_particles,
)
from slam_tpu.models import rbpf
from slam_tpu.models.particles import estimate_position, gather_particles

R = np.diag([0.01, 0.0003]).astype(np.float32)


def _state_with_landmarks(lms, P_diag=0.05, n_map=10):
    """EKF state with given landmark means and diagonal covariance."""
    lms = np.asarray(lms, np.float32)
    state = ekf_init(capacity=5, n_map_landmarks=n_map)
    x = np.array(state.x)
    P = np.array(state.P)
    for i, lm in enumerate(lms):
        x[3 + 2 * i:5 + 2 * i] = lm
        P[3 + 2 * i, 3 + 2 * i] = P_diag
        P[4 + 2 * i, 4 + 2 * i] = P_diag
    table = np.asarray(state.da_table).copy()
    table[:len(lms)] = np.arange(len(lms))
    return state._replace(x=jnp.asarray(x), P=jnp.asarray(P),
                          n=jnp.int32(len(lms)),
                          da_table=jnp.asarray(table))


# --- EKF predict ---------------------------------------------------------

def test_ekf_predict_moves_pose_and_grows_covariance():
    state = ekf_init(4, 8)
    Q = np.diag([0.09, 0.003]).astype(np.float32)
    s1 = ekf_predict(state, 1.0, 0.0, Q, wheelbase=1.0, dt=0.025)
    np.testing.assert_allclose(np.asarray(s1.x[:3]), [0.025, 0.0, 0.0],
                               atol=1e-6)
    # Covariance gained process noise.
    assert float(s1.P[0, 0]) > 0
    # Symmetric.
    np.testing.assert_allclose(np.asarray(s1.P), np.asarray(s1.P).T,
                               atol=1e-7)


def test_ekf_predict_cross_covariance_rows():
    """Cross rows get premultiplied by Gv, other landmark blocks remain
    (ekfslam.cpp:65-71)."""
    state = _state_with_landmarks([[5.0, 1.0]])
    P = np.asarray(state.P).copy()
    P[0, 3] = P[3, 0] = 0.01  # nonzero cross-covariance
    state = state._replace(P=jnp.asarray(P))
    Q = np.diag([0.09, 0.003]).astype(np.float32)
    s1 = ekf_predict(state, 1.0, 0.1, Q, wheelbase=1.0, dt=0.025)
    P1 = np.asarray(s1.P)
    # Landmark own-block untouched by predict.
    np.testing.assert_allclose(P1[3:5, 3:5], P[3:5, 3:5], atol=1e-7)
    np.testing.assert_allclose(P1, P1.T, atol=1e-7)


def test_ekf_observe_heading_pulls_theta():
    state = ekf_init(2, 4)
    P = np.zeros((7, 7), np.float32)
    P[2, 2] = 0.25
    state = state._replace(P=jnp.asarray(P))
    s1 = ekf_observe_heading(state, jnp.float32(0.5), 0.01)
    # Strong pull: P_theta >> sigma^2.
    assert abs(float(s1.x[2]) - 0.5) < 0.01
    assert float(s1.P[2, 2]) < 0.25


# --- association ---------------------------------------------------------

def test_ekf_associate_matches_nearby_and_creates_far():
    state = _state_with_landmarks([[5.0, 0.0], [0.0, 5.0]])
    # Observation of landmark 0 (range 5, bearing 0) and a far new one.
    z = jnp.asarray(np.array([[5.0, 0.0], [8.0, 2.0]], np.float32))
    zmask = jnp.array([True, True])
    assoc, is_new = ekf_data_associate(state, z, zmask, R,
                                       gate_reject=4.0, gate_augment=25.0)
    assert int(assoc[0]) == 0
    assert not bool(is_new[0])
    assert int(assoc[1]) == -1
    assert bool(is_new[1])


def test_ekf_associate_respects_mask():
    state = _state_with_landmarks([[5.0, 0.0]])
    z = jnp.asarray(np.array([[5.0, 0.0]], np.float32))
    assoc, is_new = ekf_data_associate(state, z, jnp.array([False]), R,
                                       4.0, 25.0)
    assert int(assoc[0]) == -1 and not bool(is_new[0])


def test_ekf_associate_known_table():
    state = _state_with_landmarks([[5.0, 0.0], [0.0, 5.0]])
    ids = jnp.array([1, 7], dtype=jnp.int32)   # id 7 unseen
    zmask = jnp.array([True, True])
    assoc, is_new = ekf_data_associate_known(state, ids, zmask)
    assert int(assoc[0]) == 1 and not bool(is_new[0])
    assert int(assoc[1]) == -1 and bool(is_new[1])


# --- batch update --------------------------------------------------------

def test_ekf_batch_update_reduces_uncertainty_and_error():
    state = _state_with_landmarks([[5.0, 0.0]], P_diag=0.5)
    P = np.asarray(state.P).copy()
    P[:3, :3] = np.diag([0.4, 0.4, 0.05])
    state = state._replace(P=jnp.asarray(P))
    # Perfect observation of the true landmark position from the origin.
    z = jnp.asarray(np.array([[5.0, 0.0]], np.float32))
    assoc = jnp.array([0], dtype=jnp.int32)
    s1 = ekf_batch_update(state, z, assoc, R)
    P1 = np.asarray(s1.P)
    assert np.trace(P1[:3, :3]) < np.trace(P[:3, :3])
    np.testing.assert_allclose(P1, P1.T, atol=1e-5)


def test_ekf_batch_update_unmatched_is_noop():
    state = _state_with_landmarks([[5.0, 0.0]])
    z = jnp.asarray(np.array([[5.0, 0.0]], np.float32))
    assoc = jnp.array([-1], dtype=jnp.int32)
    s1 = ekf_batch_update(state, z, assoc, R)
    np.testing.assert_allclose(np.asarray(s1.x), np.asarray(state.x),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(s1.P), np.asarray(state.P),
                               atol=1e-5)


# --- augment -------------------------------------------------------------

def test_ekf_augment_adds_features_with_correct_means():
    state = ekf_init(4, 8)
    P = np.zeros((11, 11), np.float32)
    P[:3, :3] = np.diag([0.1, 0.1, 0.01])
    state = state._replace(P=jnp.asarray(P))
    z = jnp.asarray(np.array([[2.0, 0.0], [3.0, np.pi / 2]], np.float32))
    ids = jnp.array([4, 6], dtype=jnp.int32)
    is_new = jnp.array([True, True])
    s1 = ekf_augment(state, z, ids, is_new, R)
    assert int(s1.n) == 2
    np.testing.assert_allclose(np.asarray(s1.x[3:5]), [2.0, 0.0],
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(s1.x[5:7]), [0.0, 3.0],
                               atol=1e-5)
    # da_table updated
    assert int(s1.da_table[4]) == 0 and int(s1.da_table[6]) == 1
    P1 = np.asarray(s1.P)
    np.testing.assert_allclose(P1, P1.T, atol=1e-6)
    # New feature variance >= pose variance (inherits pose uncertainty
    # plus observation noise).
    assert P1[3, 3] >= 0.1 - 1e-5


def test_ekf_augment_capacity_overflow_drops():
    state = _state_with_landmarks([[1, 1], [2, 2], [3, 3], [4, 4],
                                   [5, 5]])  # capacity 5 full
    z = jnp.asarray(np.array([[2.0, 0.0]], np.float32))
    s1 = ekf_augment(state, z, jnp.array([9], dtype=jnp.int32),
                     jnp.array([True]), R)
    assert int(s1.n) == 5  # unchanged
    assert int(s1.da_table[9]) == -1


def test_ekf_augment_sequential_equivalence():
    """Batch augment of two features == two single augments
    (closed-form vs the reference's sequential ekfAddOneZ)."""
    state = ekf_init(4, 8)
    P = np.zeros((11, 11), np.float32)
    P[:3, :3] = np.asarray([[0.2, 0.05, 0.01],
                            [0.05, 0.3, 0.02],
                            [0.01, 0.02, 0.04]], np.float32)
    state = state._replace(P=jnp.asarray(P),
                           x=state.x.at[:3].set(
                               jnp.array([1.0, -2.0, 0.3])))
    z = jnp.asarray(np.array([[2.0, 0.1], [4.0, -0.7]], np.float32))
    ids = jnp.array([0, 1], dtype=jnp.int32)

    both = ekf_augment(state, z, ids, jnp.array([True, True]), R)
    one = ekf_augment(state, z[:1], ids[:1], jnp.array([True]), R)
    two = ekf_augment(one, z[1:], ids[1:], jnp.array([True]), R)
    np.testing.assert_allclose(np.asarray(both.x), np.asarray(two.x),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(both.P), np.asarray(two.P),
                               atol=1e-4)


# --- RBPF pieces ---------------------------------------------------------

def test_propagate_poses_matches_truth_model():
    from slam_tpu.sim.vehicle import predict_true_position
    xv = jnp.asarray(np.random.default_rng(0).normal(size=(3, 7))
                     .astype(np.float32))
    V = jnp.full((7,), 3.0)
    G = jnp.full((7,), 0.2)
    out = rbpf.propagate_poses(xv, V, G, 4.0, 0.025)
    for i in range(7):
        ref = predict_true_position(xv[:, i], 3.0, 0.2, 4.0, 0.025)
        np.testing.assert_allclose(np.asarray(out[:, i]),
                                   np.asarray(ref), atol=1e-6)


def test_add_new_features_shared_slots():
    state = init_particles(3, capacity=4, n_map_landmarks=6)
    # Put particles at different poses: features land at the same slot
    # but different positions.
    xv = jnp.asarray(np.array([[0, 1, 0], [0, 0, 1], [0, 0, 0]],
                              np.float32))  # [3, P] planes
    state = state._replace(xv=xv)
    z = jnp.asarray(np.array([[2.0, 0.0]], np.float32))
    s1 = rbpf.add_new_features(state, z, jnp.array([3], dtype=jnp.int32),
                               jnp.array([True]), R)
    assert int(s1.n) == 1
    assert int(s1.da_table[3]) == 0
    # Particle 0 at origin -> landmark (2, 0); particle 1 at (1, 0) ->
    # landmark (3, 0).
    np.testing.assert_allclose(np.asarray(s1.lm[:, 0, 0]), [2.0, 0.0],
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(s1.lm[:, 0, 1]), [3.0, 0.0],
                               atol=1e-5)


def test_update_matched_features_only_touches_matched():
    state = init_particles(2, capacity=3, n_map_landmarks=4)
    lm = np.zeros((2, 3, 2), np.float32)       # [2, L, P]
    lm[0, 0, :] = 5.0                          # landmark 0 at (5, 0)
    lm[1, 1, :] = 5.0                          # landmark 1 at (0, 5)
    lm_P = np.zeros((3, 3, 2), np.float32)     # packed (00, 01, 11)
    lm_P[0] = 0.1
    lm_P[2] = 0.1
    state = state._replace(lm=jnp.asarray(lm), lm_P=jnp.asarray(lm_P),
                           n=jnp.int32(2))
    z = jnp.asarray(np.array([[5.0, 0.0]], np.float32))
    slot = jnp.array([0], dtype=jnp.int32)
    matched = jnp.array([True])
    J, v0, v1 = rbpf.observe_planes(state, z, slot, jnp.asarray(R))
    s1 = rbpf.update_matched_features(state, slot, matched, v0, v1, J)
    # Slot 1 untouched.
    np.testing.assert_allclose(np.asarray(s1.lm[:, 1]), lm[:, 1])
    np.testing.assert_allclose(np.asarray(s1.lm_P[:, 1]), lm_P[:, 1])
    # Slot 0 variance reduced.
    assert float(s1.lm_P[0, 0, 0]) < 0.1


def test_update_matched_features_matches_dense_2x2():
    """Plane-form feature update == the dense stacked-matrix update
    (feature_update_2x2), cross-checking the scalar expansion."""
    from slam_tpu.ops.kalman import feature_update_2x2
    rng = np.random.default_rng(5)
    P = 6
    state = init_particles(P, capacity=2, n_map_landmarks=2)
    lmx = rng.normal(size=P).astype(np.float32) + 5
    lmy = rng.normal(size=P).astype(np.float32) + 2
    A = rng.normal(size=(P, 2, 2)).astype(np.float32) * 0.3
    Pf = A @ np.swapaxes(A, -1, -2) + 0.05 * np.eye(2, dtype=np.float32)
    lm = np.zeros((2, 2, P), np.float32)
    lm[0, 0], lm[1, 0] = lmx, lmy
    lm_P = np.zeros((3, 2, P), np.float32)
    lm_P[0, 0] = Pf[:, 0, 0]
    lm_P[1, 0] = Pf[:, 0, 1]
    lm_P[2, 0] = Pf[:, 1, 1]
    state = state._replace(lm=jnp.asarray(lm), lm_P=jnp.asarray(lm_P),
                           n=jnp.int32(1))
    z = jnp.asarray(np.array([[5.2, 0.1]], np.float32))
    slot = jnp.array([0], dtype=jnp.int32)
    J, v0, v1 = rbpf.observe_planes(state, z, slot, jnp.asarray(R))
    s1 = rbpf.update_matched_features(state, slot, jnp.array([True]),
                                      v0, v1, J)

    # Dense reference per particle.
    from slam_tpu.ops.jacobians import compute_jacobians
    for i in range(P):
        xv_i = np.zeros(3, np.float32)
        xf = np.array([lmx[i], lmy[i]], np.float32)
        zp, _, Hf, _ = compute_jacobians(jnp.asarray(xv_i),
                                         jnp.asarray(xf),
                                         jnp.asarray(Pf[i]),
                                         jnp.asarray(R))
        v = np.asarray(z[0]) - np.asarray(zp)
        xf2, Pf2 = feature_update_2x2(jnp.asarray(xf), jnp.asarray(Pf[i]),
                                      jnp.asarray(v), jnp.asarray(R), Hf)
        np.testing.assert_allclose(np.asarray(s1.lm[:, 0, i]),
                                   np.asarray(xf2), rtol=1e-4, atol=1e-5)
        got_P = np.array([[s1.lm_P[0, 0, i], s1.lm_P[1, 0, i]],
                          [s1.lm_P[1, 0, i], s1.lm_P[2, 0, i]]])
        np.testing.assert_allclose(got_P, np.asarray(Pf2), rtol=1e-3,
                                   atol=1e-5)


def test_estimate_position_weighted_mean():
    state = init_particles(2, 2, 2)
    xv = np.array([[0.0, 2.0], [0.0, 4.0], [0.1, 0.7]], np.float32)
    logw = np.log(np.array([0.25, 0.75], np.float32))
    state = state._replace(xv=jnp.asarray(xv), logw=jnp.asarray(logw))
    est = np.asarray(estimate_position(state))
    np.testing.assert_allclose(est[:2], [1.5, 3.0], atol=1e-5)
    np.testing.assert_allclose(est[2], 0.7, atol=1e-6)  # max-weight theta


def test_gather_particles_keeps_shared_fields():
    state = init_particles(4, 2, 2)
    state = state._replace(xv=jnp.arange(12, dtype=jnp.float32)
                           .reshape(3, 4))
    idx = jnp.array([3, 3, 0, 1], dtype=jnp.int32)
    s1 = gather_particles(state, idx)
    np.testing.assert_allclose(np.asarray(s1.xv[:, 0]),
                               np.asarray(state.xv[:, 3]))
    assert s1.n is state.n and s1.da_table is state.da_table


def test_estimate_position_variants():
    """The three reference pose-estimate variants
    (ParticleSLAMWrapper.cpp:56-119) behind the POSE_ESTIMATE switch;
    heading is the max-weight particle's in every mode."""
    rng = np.random.default_rng(4)
    P = 101
    state = init_particles(P, capacity=2, n_map_landmarks=2)
    xv = rng.normal(size=(3, P)).astype(np.float32)
    logw = rng.normal(size=P).astype(np.float32)
    state = state._replace(xv=jnp.asarray(xv), logw=jnp.asarray(logw))

    mean = np.asarray(estimate_position(state, "mean"))
    med = np.asarray(estimate_position(state, "median"))
    wgt = np.asarray(estimate_position(state, "weighted"))

    np.testing.assert_allclose(mean[:2], xv[:2].mean(axis=1), rtol=1e-5)
    np.testing.assert_allclose(med[:2], np.median(xv[:2], axis=1),
                               rtol=1e-5)
    w = np.exp(logw - logw.max())
    w /= w.sum()
    np.testing.assert_allclose(wgt[:2], (xv[:2] * w).sum(axis=1),
                               rtol=1e-4)
    th = xv[2, np.argmax(logw)]
    for est in (mean, med, wgt):
        np.testing.assert_allclose(est[2], th, rtol=1e-6)

    # The switch reaches the estimator through the config.
    from slam_tpu.config import SlamConfig
    from slam_tpu.models import FastSlam1
    fs = FastSlam1(SlamConfig(POSE_ESTIMATE="median"), 2)
    np.testing.assert_allclose(np.asarray(fs.pose(state)), med,
                               rtol=1e-6)
