"""Kalman update primitives.

jnp reference implementations of:
- ``joseph_update``     <- josephUpdate (core.cpp:294-317): scalar-observation
  Joseph-form covariance update with the reference's eps jitter.
- ``cholesky_update``   <- choleskyUpdate (core.cpp:275-291): dense Kalman
  update via Cholesky of the innovation covariance.
- ``feature_update_2x2``<- featureUpdate (core.cpp:132-175): per-landmark
  2x2 EKF update, closed-form (no factorization needed at 2x2).
- ``add_feature_init``  <- addFeature (core.cpp:479-509) / ekfAddOneZ
  initialization Jacobian Gz and Pf = Gz R Gz^T.

All functions are batch-friendly; the EKF path uses them at full joint
state width, the FastSLAM paths vmap them over particles x landmarks.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl

from slam_tpu.geometry import wrap_angle

_JOSEPH_EPS = 2.2204e-16


def joseph_update(x, P, v, r, H):
    """Scalar-observation Joseph-form update (core.cpp:294-317).

    Args:
      x: [N] state. P: [N, N] covariance. v: scalar innovation.
      r: scalar observation variance. H: [N] observation row.
    Returns updated (x, P). P gets the reference's +eps*I jitter.
    """
    # f32 (HIGHEST) matmul precision throughout: covariance updates
    # collapse to NaN under reduced-precision (bf16 or TF32) products.
    mm = lambda a, b: jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)
    PHt = mm(P, H)                   # [N]
    s = mm(H, PHt) + r               # scalar
    W = PHt / s                      # [N]
    x_new = x + W * v
    n = x.shape[-1]
    C = jnp.eye(n, dtype=P.dtype) - jnp.outer(W, H)
    P_new = mm(mm(C, P), C.T) + r * jnp.outer(W, W)
    P_new = P_new + _JOSEPH_EPS * jnp.eye(n, dtype=P.dtype)
    return x_new, P_new


def cholesky_update(x, P, v, R, H):
    """Dense Kalman update via Cholesky (core.cpp:275-291).

    Args:
      x: [N]. P: [N, N]. v: [M] innovation. R: [M, M]. H: [M, N].
    Returns updated (x, P). Symmetrizes S before factorization like the
    reference; P update uses the W1 W1^T form for symmetry.
    """
    mm = lambda a, b: jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)
    PHt = mm(P, H.T)                 # [N, M]
    S = mm(H, PHt) + R
    S = 0.5 * (S + S.T)
    # Small diagonal jitter keeps the factorization alive when f32
    # accumulation error nudges S off PSD late in long runs (the
    # reference adds the same style of epsilon in josephUpdate,
    # core.cpp:315-316).
    m = S.shape[-1]
    S = S + 1e-6 * jnp.trace(S) / m * jnp.eye(m, dtype=S.dtype)
    L = jsl.cholesky(S, lower=True)  # [M, M]
    # W1 = PHt L^-T ; P -= W1 W1^T ; x += PHt S^-1 v
    W1 = jsl.solve_triangular(L, PHt.T, lower=True).T   # [N, M]
    Wv = mm(W1, jsl.solve_triangular(L, v, lower=True))
    x_new = x + Wv
    P_new = P - mm(W1, W1.T)
    return x_new, P_new


def feature_update_2x2(xf, Pf, v, R, Hf):
    """Per-landmark 2x2 EKF update, closed form. Batch over leading axes.

    Equivalent to featureUpdate -> choleskyUpdate at 2x2
    (core.cpp:132-175, 275-291): W = Pf Hf^T S^-1 with S = Hf Pf Hf^T + R;
    xf += W v; Pf -= W S W^T. Inputs: xf [..., 2], Pf [..., 2, 2],
    v [..., 2], R [2, 2], Hf [..., 2, 2]. Returns (xf', Pf').
    """
    mm = lambda a, b: jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)
    PHt = mm(Pf, jnp.swapaxes(Hf, -1, -2))        # [..., 2, 2]
    S = mm(Hf, PHt) + R
    S = 0.5 * (S + jnp.swapaxes(S, -1, -2))
    Si = inv_2x2(S)
    W = mm(PHt, Si)
    xf_new = xf + mm(W, v[..., None])[..., 0]
    # P' = P - W S W^T == P - W (PHt)^T, numerically the W1 W1^T form:
    Pf_new = Pf - mm(W, jnp.swapaxes(PHt, -1, -2))
    Pf_new = 0.5 * (Pf_new + jnp.swapaxes(Pf_new, -1, -2))
    return xf_new, Pf_new


def inv_2x2(S):
    """Closed-form 2x2 inverse (replaces Eigen .inverse() at 2x2)."""
    a, b = S[..., 0, 0], S[..., 0, 1]
    c, d = S[..., 1, 0], S[..., 1, 1]
    det = a * d - b * c
    det = jnp.where(jnp.abs(det) < 1e-30, 1e-30, det)
    inv = jnp.stack([
        jnp.stack([d, -b], axis=-1),
        jnp.stack([-c, a], axis=-1),
    ], axis=-2)
    return inv / det[..., None, None]


def solve_3x3_psd(A, B):
    """Solve A X = B for symmetric PD 3x3 A (batched). Used by the
    FastSLAM2 proposal refinement (fastslam2.cpp:335-341) instead of the
    reference's Eigen LLT solves."""
    return jnp.linalg.solve(A, B)


def inv_3x3_psd(A):
    eye = jnp.broadcast_to(jnp.eye(3, dtype=A.dtype), A.shape)
    return jnp.linalg.solve(A, eye)


def add_feature_init(xv, z):
    """Initialize a landmark from pose + (range, bearing):
    mean and the Gz Jacobian (core.cpp:479-509 / ekfslam.cpp:269-316).

    Args: xv [..., 3], z [..., 2]. Returns (xf [..., 2], Gz [..., 2, 2]).
    Landmark covariance is Gz R Gz^T (compose at call site, where R may be
    Re).
    """
    r, b = z[..., 0], z[..., 1]
    s = jnp.sin(xv[..., 2] + b)
    c = jnp.cos(xv[..., 2] + b)
    xf = jnp.stack([xv[..., 0] + r * c, xv[..., 1] + r * s], axis=-1)
    Gz = jnp.stack([
        jnp.stack([c, -r * s], axis=-1),
        jnp.stack([s, r * c], axis=-1),
    ], axis=-2)
    return xf, Gz


def innovation(z, zp):
    """Measurement innovation with wrapped bearing (used everywhere:
    e.g. fastslam1.cpp:102-105, ekfslam.cpp:142-143)."""
    v = z - zp
    return jnp.stack([v[..., 0], wrap_angle(v[..., 1])], axis=-1)
