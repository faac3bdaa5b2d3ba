"""Plane-form estimation math: scalar-expanded 2x2/3x3 linear algebra on
component planes.

These functions express the hot per-(particle x landmark) math —
``computeJacobians`` (core.cpp:666-713), ``featureUpdate``/2x2 Kalman
(core.cpp:132-175, 275-291), Gaussian likelihood (fastslam1.cpp:91-118,
fastslam2.cpp:127-163) — as elementwise arithmetic over broadcastable
arrays ("planes", typically shaped [K, P] with the particle axis last).
The estimators (slam_tpu.models.fastslam{1,2}) call them on whole planes,
and XLA fuses each chain into a handful of elementwise loops.

Everything is branch-free; degenerate inputs (padded landmarks at
distance 0, singular S) are guarded with epsilons and masked by callers.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax.numpy as jnp

from slam_tpu.geometry import wrap_angle

# Plain-math constants: a jnp call here would initialize the XLA
# backend at import time, breaking jax.distributed.initialize() in
# multi-process runs (it must run before any backend touch).
_LOG_2PI = math.log(2.0 * math.pi)


class JacobianPlanes(NamedTuple):
    """Outputs of the range-bearing observation model at (pose, landmark):
    predicted observation, pose/feature Jacobians, innovation covariance
    (packed symmetric). Mirrors the FPGA accelerator's output contract
    (zp, Hf, Hv, Sf per landmark — core.cpp:624-664)."""
    zr: jnp.ndarray    # predicted range
    zb: jnp.ndarray    # predicted bearing
    hv00: jnp.ndarray  # dzr/dx   = -dx/d
    hv01: jnp.ndarray  # dzr/dy   = -dy/d
    hv10: jnp.ndarray  # dzb/dx   =  dy/d2
    hv11: jnp.ndarray  # dzb/dy   = -dx/d2
    # dzr/dtheta = 0, dzb/dtheta = -1 (constants, omitted)
    a: jnp.ndarray     # Hf[0,0] =  dx/d
    b: jnp.ndarray     # Hf[0,1] =  dy/d
    c: jnp.ndarray     # Hf[1,0] = -dy/d2
    e: jnp.ndarray     # Hf[1,1] =  dx/d2
    s00: jnp.ndarray   # Sf packed symmetric
    s01: jnp.ndarray
    s11: jnp.ndarray


def jacobians_planes(xvx, xvy, xvt, lmx, lmy, p00, p01, p11,
                     r00, r01, r11) -> JacobianPlanes:
    """computeJacobians in plane form (core.cpp:666-713): ~30 flops per
    element, all elementwise."""
    dx = lmx - xvx
    dy = lmy - xvy
    d2 = jnp.maximum(dx * dx + dy * dy, 1e-12)
    d = jnp.sqrt(d2)
    inv_d = 1.0 / d
    inv_d2 = 1.0 / d2

    zr = d
    zb = wrap_angle(jnp.arctan2(dy, dx) - xvt)

    a = dx * inv_d
    b = dy * inv_d
    c = -dy * inv_d2
    e = dx * inv_d2

    # Sf = Hf Pf Hf^T + R, expanded on the packed symmetric Pf.
    t0 = p00 * a + p01 * b
    t1 = p01 * a + p11 * b
    t2 = p00 * c + p01 * e
    t3 = p01 * c + p11 * e
    s00 = a * t0 + b * t1 + r00
    s01 = c * t0 + e * t1 + r01
    s11 = c * t2 + e * t3 + r11

    return JacobianPlanes(zr=zr, zb=zb,
                          hv00=-a, hv01=-b, hv10=-c, hv11=-e,
                          a=a, b=b, c=c, e=e,
                          s00=s00, s01=s01, s11=s11)


def log_gauss2_planes(v0, v1, s00, s01, s11):
    """log N(v; 0, S) with packed symmetric 2x2 S (replaces gaussEvaluate,
    fastslam2.cpp:127-163, and the linear-space products of
    fastslam1.cpp:108-117)."""
    det = jnp.maximum(s00 * s11 - s01 * s01, 1e-30)
    quad = (s11 * v0 * v0 - 2.0 * s01 * v0 * v1 + s00 * v1 * v1) / det
    return -0.5 * quad - _LOG_2PI - 0.5 * jnp.log(det)


class FeatureUpdatePlanes(NamedTuple):
    nx: jnp.ndarray
    ny: jnp.ndarray
    np00: jnp.ndarray
    np01: jnp.ndarray
    np11: jnp.ndarray


def feature_update_planes(lmx, lmy, p00, p01, p11, v0, v1,
                          J: JacobianPlanes) -> FeatureUpdatePlanes:
    """Per-landmark 2x2 EKF update in plane form (featureUpdate ->
    choleskyUpdate at 2x2, core.cpp:132-175, 275-291):
    W = Pf Hf' S^-1; xf += W v; Pf -= W (Pf Hf')'."""
    det = jnp.maximum(J.s00 * J.s11 - J.s01 * J.s01, 1e-30)
    i00 = J.s11 / det
    i01 = -J.s01 / det
    i11 = J.s00 / det

    # PHt = Pf Hf^T  (2x2).
    pht00 = p00 * J.a + p01 * J.b
    pht01 = p00 * J.c + p01 * J.e
    pht10 = p01 * J.a + p11 * J.b
    pht11 = p01 * J.c + p11 * J.e

    # W = PHt S^-1.
    w00 = pht00 * i00 + pht01 * i01
    w01 = pht00 * i01 + pht01 * i11
    w10 = pht10 * i00 + pht11 * i01
    w11 = pht10 * i01 + pht11 * i11

    nx = lmx + w00 * v0 + w01 * v1
    ny = lmy + w10 * v0 + w11 * v1
    np00 = p00 - (w00 * pht00 + w01 * pht01)
    np01 = p01 - 0.5 * ((w00 * pht10 + w01 * pht11)
                        + (w10 * pht00 + w11 * pht01))
    np11 = p11 - (w10 * pht10 + w11 * pht11)
    return FeatureUpdatePlanes(nx=nx, ny=ny, np00=np00, np01=np01,
                               np11=np11)


def feature_init_planes(xvx, xvy, xvt, zr, zb, r00, r01, r11):
    """New-landmark initialization in plane form (addFeature,
    core.cpp:479-509): mean from pose + (r, b); Pf = Gz R Gz'."""
    s = jnp.sin(xvt + zb)
    c = jnp.cos(xvt + zb)
    nx = xvx + zr * c
    ny = xvy + zr * s
    # Gz = [[c, -r s], [s, r c]]; Pf = Gz R Gz^T.
    g00, g01 = c, -zr * s
    g10, g11 = s, zr * c
    t0 = g00 * r00 + g01 * r01
    t1 = g00 * r01 + g01 * r11
    t2 = g10 * r00 + g11 * r01
    t3 = g10 * r01 + g11 * r11
    p00 = t0 * g00 + t1 * g01
    p01 = t0 * g10 + t1 * g11
    p11 = t2 * g10 + t3 * g11
    return nx, ny, p00, p01, p11


def sym3_mul_vec(P6, v0, v1, v2):
    """Packed symmetric 3x3 (6 planes, order 00,01,02,11,12,22) times a
    3-vector of planes."""
    a, b, c, d, e, f = P6
    return (a * v0 + b * v1 + c * v2,
            b * v0 + d * v1 + e * v2,
            c * v0 + e * v1 + f * v2)


def sym3_quadform_inv(P6, v0, v1, v2, jitter=1e-9):
    """v^T P^-1 v and log|P| for packed symmetric 3x3 planes, via the
    explicit adjugate (replaces Eigen LLT/SVD solves,
    fastslam2.cpp:127-163)."""
    a, b, c, d, e, f = P6
    a = a + jitter
    d = d + jitter
    f = f + jitter
    A = d * f - e * e
    B = c * e - b * f
    C = b * e - c * d
    det = a * A + b * B + c * C
    det = jnp.maximum(det, 1e-30)
    D = a * f - c * c
    E = b * c - a * e
    F = a * d - b * b
    quad = (v0 * (A * v0 + B * v1 + C * v2)
            + v1 * (B * v0 + D * v1 + E * v2)
            + v2 * (C * v0 + E * v1 + F * v2)) / det
    return quad, jnp.log(det)


def log_gauss3_planes(P6, v0, v1, v2, jitter=1e-9):
    quad, logdet = sym3_quadform_inv(P6, v0, v1, v2, jitter)
    return -0.5 * quad - 1.5 * _LOG_2PI - 0.5 * logdet


def sym3_inv(P6, jitter=1e-9):
    """Inverse of packed symmetric 3x3 planes via the adjugate."""
    a, b, c, d, e, f = P6
    a = a + jitter
    d = d + jitter
    f = f + jitter
    A = d * f - e * e
    B = c * e - b * f
    C = b * e - c * d
    det = a * A + b * B + c * C
    det = jnp.where(jnp.abs(det) < 1e-30, 1e-30, det)
    D = a * f - c * c
    E = b * c - a * e
    F = a * d - b * b
    inv = 1.0 / det
    return (A * inv, B * inv, C * inv, D * inv, E * inv, F * inv)


def sym3_add(P6, Q6):
    return tuple(p + q for p, q in zip(P6, Q6))


def sym3_chol(P6, jitter=1e-9):
    """Lower Cholesky of packed symmetric 3x3 planes:
    returns (l00, l10, l11, l20, l21, l22)."""
    a, b, c, d, e, f = P6
    l00 = jnp.sqrt(jnp.maximum(a + jitter, 1e-30))
    l10 = b / l00
    l20 = c / l00
    l11 = jnp.sqrt(jnp.maximum(d + jitter - l10 * l10, 1e-30))
    l21 = (e - l20 * l10) / l11
    l22 = jnp.sqrt(jnp.maximum(f + jitter - l20 * l20 - l21 * l21,
                               1e-30))
    return l00, l10, l11, l20, l21, l22


def chol3_mul_vec(L, e0, e1, e2):
    """L @ eps for the packed lower Cholesky factor of sym3_chol."""
    l00, l10, l11, l20, l21, l22 = L
    return (l00 * e0,
            l10 * e0 + l11 * e1,
            l20 * e0 + l21 * e1 + l22 * e2)


def refine_pose_planes(J: JacobianPlanes, Pv6, v0, v1):
    """One FastSLAM2 proposal-refinement step in covariance form.

    The reference refines in information form (sampleProposal,
    fastslam2.cpp:335-345):
        Pv <- (Hv' Sf^-1 Hv + Pv^-1)^-1,   xv <- xv + Pv Hv' Sf^-1 v
    which inverts Pv — numerically fragile in f32 because Pv is zeroed
    after every observe tick (fastslam2.cpp:353-357) and re-accumulates
    to ~Q*dt scale, so Pv^-1 reaches 1e5+ and the outer inverse runs on
    catastrophically cancelled sums. By the Woodbury identity the exact
    same update is
        K  = Pv Hv' (Sf + Hv Pv Hv')^-1
        xv <- xv + K v,   Pv <- Pv - K (Hv Pv)'
    which only inverts the 2x2 (Sf + Hv Pv Hv') >= R > 0.

    Hv = [[hv00, hv01, 0], [hv10, hv11, -1]]. Returns
    ((dx0, dx1, dx2), Pv_new 6-tuple), all planes.
    """
    # U = Pv Hv'  (columns ua = Pv r0', ub = Pv r1')
    ua0, ua1, ua2 = sym3_mul_vec(Pv6, J.hv00, J.hv01,
                                 jnp.zeros_like(J.hv00))
    ub0, ub1, ub2 = sym3_mul_vec(Pv6, J.hv10, J.hv11,
                                 -jnp.ones_like(J.hv00))
    # Hv Pv Hv' (2x2 symmetric) = Hv U
    t00 = J.hv00 * ua0 + J.hv01 * ua1
    t01 = J.hv00 * ub0 + J.hv01 * ub1
    t11 = J.hv10 * ub0 + J.hv11 * ub1 - ub2
    s00 = J.s00 + t00
    s01 = J.s01 + t01
    s11 = J.s11 + t11
    det = jnp.maximum(s00 * s11 - s01 * s01, 1e-30)
    i00, i01, i11 = s11 / det, -s01 / det, s00 / det
    # K = U S^-1, rows k_i = (ua_i, ub_i) @ S^-1
    k00 = ua0 * i00 + ub0 * i01
    k01 = ua0 * i01 + ub0 * i11
    k10 = ua1 * i00 + ub1 * i01
    k11 = ua1 * i01 + ub1 * i11
    k20 = ua2 * i00 + ub2 * i01
    k21 = ua2 * i01 + ub2 * i11
    dx = (k00 * v0 + k01 * v1,
          k10 * v0 + k11 * v1,
          k20 * v0 + k21 * v1)
    a, b, c, d, e, f = Pv6
    Pv_new = (a - (k00 * ua0 + k01 * ub0),
              b - (k00 * ua1 + k01 * ub1),
              c - (k00 * ua2 + k01 * ub2),
              d - (k10 * ua1 + k11 * ub1),
              e - (k10 * ua2 + k11 * ub2),
              f - (k20 * ua2 + k21 * ub2))
    return dx, Pv_new
