"""Unit tests for the packed-symmetric plane algebra (ops/planes.py)
against dense numpy oracles."""

import numpy as np
import jax.numpy as jnp

from slam_tpu.ops import planes as pk

R = np.diag([0.01, 0.0003]).astype(np.float32)


def _rand_spd3(rng, n):
    A = rng.normal(size=(n, 3, 3)).astype(np.float32)
    return A @ np.swapaxes(A, -1, -2) + 0.2 * np.eye(3, dtype=np.float32)


def _pack(P):
    return (P[:, 0, 0], P[:, 0, 1], P[:, 0, 2],
            P[:, 1, 1], P[:, 1, 2], P[:, 2, 2])


def test_sym3_inv_matches_numpy():
    rng = np.random.default_rng(0)
    P = _rand_spd3(rng, 50)
    inv6 = pk.sym3_inv(tuple(map(jnp.asarray, _pack(P))), jitter=0.0)
    a, b, c, d, e, f = map(np.asarray, inv6)
    got = np.stack([np.stack([a, b, c], -1), np.stack([b, d, e], -1),
                    np.stack([c, e, f], -1)], -2)
    want = np.linalg.inv(P)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_sym3_chol_matches_numpy():
    rng = np.random.default_rng(1)
    P = _rand_spd3(rng, 30)
    L6 = pk.sym3_chol(tuple(map(jnp.asarray, _pack(P))), jitter=0.0)
    l00, l10, l11, l20, l21, l22 = map(np.asarray, L6)
    zeros = np.zeros_like(l00)
    got = np.stack([np.stack([l00, zeros, zeros], -1),
                    np.stack([l10, l11, zeros], -1),
                    np.stack([l20, l21, l22], -1)], -2)
    want = np.linalg.cholesky(P)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_log_gauss3_matches_numpy():
    rng = np.random.default_rng(2)
    P = _rand_spd3(rng, 20)
    v = rng.normal(size=(20, 3)).astype(np.float32)
    got = np.asarray(pk.log_gauss3_planes(
        tuple(map(jnp.asarray, _pack(P))),
        jnp.asarray(v[:, 0]), jnp.asarray(v[:, 1]), jnp.asarray(v[:, 2]),
        jitter=0.0))
    for i in range(20):
        want = (-0.5 * v[i] @ np.linalg.solve(P[i], v[i])
                - 1.5 * np.log(2 * np.pi)
                - 0.5 * np.log(np.linalg.det(P[i])))
        np.testing.assert_allclose(got[i], want, rtol=1e-3, atol=1e-3)


def test_refine_pose_matches_dense_information_form():
    """The covariance-form refinement (Woodbury) against the reference's
    information form Pv<-(Hv'S^-1 Hv+Pv^-1)^-1, dx=Pv_new Hv'S^-1 v
    (fastslam2.cpp:335-345) evaluated densely in f64 numpy."""
    rng = np.random.default_rng(3)
    n = 25
    xv = rng.normal(size=(3, n)).astype(np.float32)
    lmx = (xv[0] + rng.normal(size=n) * 4 + 2).astype(np.float32)
    lmy = (xv[1] + rng.normal(size=n) * 4 + 1).astype(np.float32)
    p00 = np.abs(rng.normal(size=n)).astype(np.float32) * 0.1 + 0.05
    p11 = np.abs(rng.normal(size=n)).astype(np.float32) * 0.1 + 0.05
    p01 = np.zeros(n, np.float32)
    R = np.diag([0.01, 0.0003]).astype(np.float32)
    J = pk.jacobians_planes(*map(jnp.asarray,
                                 (xv[0], xv[1], xv[2], lmx, lmy,
                                  p00, p01, p11)),
                            R[0, 0], R[0, 1], R[1, 1])
    v0 = rng.normal(size=n).astype(np.float32) * 0.1
    v1 = rng.normal(size=n).astype(np.float32) * 0.05
    # A well-conditioned pose covariance (the fragile near-singular case
    # is exactly what the covariance form exists to avoid; equivalence is
    # checked where the f64 information form is itself trustworthy).
    Pv = _pack(_rand_spd3(rng, n) * 0.05)
    dx, Pv_new = pk.refine_pose_planes(J, tuple(map(jnp.asarray, Pv)),
                                       jnp.asarray(v0), jnp.asarray(v1))

    for i in range(n):
        Hv = np.array([[float(J.hv00[i]), float(J.hv01[i]), 0.0],
                       [float(J.hv10[i]), float(J.hv11[i]), -1.0]],
                      dtype=np.float64)
        S = np.array([[float(J.s00[i]), float(J.s01[i])],
                      [float(J.s01[i]), float(J.s11[i])]],
                     dtype=np.float64)
        a, b, c, d, e, f = [float(p[i]) for p in Pv]
        P = np.array([[a, b, c], [b, d, e], [c, e, f]])
        info = Hv.T @ np.linalg.inv(S) @ Hv
        want_P = np.linalg.inv(info + np.linalg.inv(P))
        want_dx = want_P @ Hv.T @ np.linalg.inv(S) @ np.array(
            [v0[i], v1[i]], dtype=np.float64)
        a, b, c, d, e, f = [float(p[i]) for p in Pv_new]
        got_P = np.array([[a, b, c], [b, d, e], [c, e, f]])
        np.testing.assert_allclose(got_P, want_P, rtol=2e-3, atol=2e-4)
        got_dx = np.array([float(x[i]) for x in dx])
        np.testing.assert_allclose(got_dx, want_dx, rtol=2e-3, atol=2e-4)


def test_feature_init_matches_dense():
    from slam_tpu.ops.kalman import add_feature_init
    rng = np.random.default_rng(4)
    n = 10
    xv = rng.normal(size=(3, n)).astype(np.float32)
    zr = np.abs(rng.normal(size=n)).astype(np.float32) * 5 + 1
    zb = rng.normal(size=n).astype(np.float32)
    R = np.diag([0.01, 0.0003]).astype(np.float32)
    nx, ny, p00, p01, p11 = pk.feature_init_planes(
        *map(jnp.asarray, (xv[0], xv[1], xv[2], zr, zb)),
        R[0, 0], R[0, 1], R[1, 1])
    for i in range(n):
        xf, Gz = add_feature_init(jnp.asarray(xv[:, i]),
                                  jnp.asarray([zr[i], zb[i]]))
        Pf = np.asarray(Gz) @ R @ np.asarray(Gz).T
        np.testing.assert_allclose([float(nx[i]), float(ny[i])],
                                   np.asarray(xf), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(
            [[float(p00[i]), float(p01[i])],
             [float(p01[i]), float(p11[i])]], Pf, rtol=1e-3, atol=1e-6)


def _planes_inputs(P=300, K=5, seed=0):
    rng = np.random.default_rng(seed)
    xv = rng.normal(size=(3, P)).astype(np.float32)
    lmx = (xv[0] + rng.normal(size=(K, P)) * 5 + 2).astype(np.float32)
    lmy = (xv[1] + rng.normal(size=(K, P)) * 5 + 1).astype(np.float32)
    A = rng.normal(size=(K, P)).astype(np.float32) * 0.3
    B = rng.normal(size=(K, P)).astype(np.float32) * 0.3
    p00 = A * A + 0.05
    p11 = B * B + 0.05
    p01 = 0.3 * A * B
    return xv, lmx, lmy, p00, p01, p11


def test_plane_jacobians_match_stacked():
    """Plane-form jacobians == the stacked-matrix compute_jacobians used
    by the EKF path."""
    from slam_tpu.ops.jacobians import compute_jacobians
    xv, lmx, lmy, p00, p01, p11 = _planes_inputs(P=40, K=3, seed=9)
    J = pk.jacobians_planes(xv[0][None], xv[1][None], xv[2][None],
                            lmx, lmy, p00, p01, p11,
                            R[0, 0], R[0, 1], R[1, 1])
    for k in range(3):
        for i in range(40):
            Pf = np.array([[p00[k, i], p01[k, i]],
                           [p01[k, i], p11[k, i]]], np.float32)
            zp, Hv, Hf, Sf = compute_jacobians(
                jnp.asarray(xv[:, i]),
                jnp.asarray(np.array([lmx[k, i], lmy[k, i]], np.float32)),
                jnp.asarray(Pf), jnp.asarray(R))
            np.testing.assert_allclose(float(J.zr[k, i]), float(zp[0]),
                                       rtol=1e-5)
            np.testing.assert_allclose(float(J.a[k, i]), float(Hf[0, 0]),
                                       rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose(float(J.hv10[k, i]),
                                       float(Hv[1, 0]), rtol=1e-4,
                                       atol=1e-6)
            np.testing.assert_allclose(float(J.s00[k, i]),
                                       float(Sf[0, 0]), rtol=1e-3,
                                       atol=1e-6)
            np.testing.assert_allclose(float(J.s01[k, i]),
                                       float(Sf[0, 1]), rtol=1e-3,
                                       atol=1e-6)
