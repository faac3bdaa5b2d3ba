"""EKF-SLAM: joint-state extended Kalman filter over pose + landmarks.

Re-design of the reference EKF (src/backend/algorithms/ekfslam.cpp):
the reference grows a dense Eigen state/covariance 2 rows at a time
(ekfslam.cpp:284-316) and data-associates with an O(obs x features) scalar
scan (ekfslam.cpp:151-189). Here the state has *fixed capacity* — landmark
growth is a masked scatter, association is one batched [max_obs, L] gated
nearest-neighbor computation, and the batch update is a single dense
[2K, N] x [N, N] Kalman step that XLA hands to the matrix units.

State layout (SURVEY.md §7): x = [x, y, theta, lm0x, lm0y, lm1x, ...] with
capacity ``L`` landmarks; ``n`` is the live landmark count; slots >= n are
zero and masked out of every computation.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from slam_tpu.geometry import wrap_angle
from slam_tpu.ops.jacobians import compute_jacobians
from slam_tpu.ops.kalman import (
    add_feature_init,
    cholesky_update,
    inv_2x2,
    joseph_update,
)

_HIGHEST = jax.lax.Precision.HIGHEST


def _diag_blocks_2x2(Pm, L: int):
    """[L, 2, 2] per-landmark diagonal blocks of the [2L, 2L] map
    covariance, read as three strided diagonals — O(L) memory traffic.
    (The obvious ``Pm.reshape(L, 2, L, 2)[arange, :, arange, :]`` gather
    can materialize O(L^2) intermediates — a hard wall at 10k
    landmarks; the reference has the same scaling pain in its dense
    per-pair association scan, ekfslam.cpp:65-77, 151-189.)"""
    d0 = jnp.diagonal(Pm)                     # [2L]
    d1 = jnp.diagonal(Pm, offset=1)           # [2L - 1]
    p00 = d0[0::2]
    p11 = d0[1::2]
    p01 = d1[0::2]
    return jnp.stack([jnp.stack([p00, p01], -1),
                      jnp.stack([p01, p11], -1)], -2)


class EKFState(NamedTuple):
    """Fixed-capacity joint EKF state.

    ``x``: [3 + 2L] joint mean. ``P``: [3+2L, 3+2L] joint covariance.
    ``n``: scalar int32 live landmark count. ``da_table``: [n_map] int32
    true-landmark-id -> state slot (-1 unseen; reference
    ekfslamwrapper.cpp:111-115 / core.cpp:91-120).
    """
    x: jnp.ndarray
    P: jnp.ndarray
    n: jnp.ndarray
    da_table: jnp.ndarray

    @property
    def capacity(self) -> int:
        return (self.x.shape[-1] - 3) // 2

    @property
    def pose(self) -> jnp.ndarray:
        return self.x[:3]

    def landmarks(self) -> tuple[jnp.ndarray, jnp.ndarray]:
        """([L, 2] means, [L] validity mask)."""
        L = self.capacity
        lm = self.x[3:].reshape(L, 2)
        return lm, jnp.arange(L) < self.n


def ekf_init(capacity: int, n_map_landmarks: int,
             dtype=jnp.float32) -> EKFState:
    """Zero pose, zero 3x3 covariance (ekfslamwrapper.cpp:40-41), empty
    map."""
    N = 3 + 2 * capacity
    return EKFState(
        x=jnp.zeros(N, dtype=dtype),
        P=jnp.zeros((N, N), dtype=dtype),
        n=jnp.int32(0),
        da_table=jnp.full((n_map_landmarks,), -1, dtype=jnp.int32),
    )


# ---------------------------------------------------------------------------
# Predict
# ---------------------------------------------------------------------------

def ekf_predict(state: EKFState, v, g, Q, wheelbase: float, dt: float
                ) -> EKFState:
    """Bicycle-model predict with exact sparse covariance propagation
    (ekfslam.cpp:46-77): only the pose block and pose-landmark cross rows
    change — O(N) work, not O(N^2).

    ``Q``: [2, 2] control noise covariance (v, g).
    """
    x, P = state.x, state.P
    theta = x[2]
    s, c = jnp.sin(g + theta), jnp.cos(g + theta)
    vts, vtc = v * dt * s, v * dt * c

    # Pose Jacobians (ekfslam.cpp:52-63).
    Gv = jnp.array([[1.0, 0.0, 0.0],
                    [0.0, 1.0, 0.0],
                    [0.0, 0.0, 1.0]], dtype=P.dtype)
    Gv = Gv.at[0, 2].set(-vts).at[1, 2].set(vtc)
    sg, cg = jnp.sin(g), jnp.cos(g)
    Gu = jnp.stack([
        jnp.stack([dt * c, -vts]),
        jnp.stack([dt * s, vtc]),
        jnp.stack([dt * sg / wheelbase, v * dt * cg / wheelbase]),
    ]).astype(P.dtype)

    # All covariance products at full f32 (HIGHEST): a reduced-precision
    # product (bf16, or TF32 on a GPU) injects relative error per tick
    # that random-walks P indefinite, then NaN at the next Cholesky.
    mm = lambda a, b: jnp.matmul(a, b, precision=_HIGHEST)
    P00 = mm(mm(Gv, P[:3, :3]), Gv.T) \
        + mm(mm(Gu, jnp.asarray(Q, P.dtype)), Gu.T)
    P0m = mm(Gv, P[:3, 3:])
    P = P.at[:3, :3].set(P00)
    P = P.at[:3, 3:].set(P0m)
    P = P.at[3:, :3].set(P0m.T)

    x = x.at[0].add(vtc)
    x = x.at[1].add(vts)
    x = x.at[2].set(wrap_angle(theta + v * dt * sg / wheelbase))
    return state._replace(x=x, P=P)


def ekf_observe_heading(state: EKFState, phi, sigma_phi) -> EKFState:
    """Scalar heading observation, Joseph form on the full joint state
    (ekfslam.cpp:86-95 -> core.cpp:294-317)."""
    H = jnp.zeros_like(state.x).at[2].set(1.0)
    v = wrap_angle(phi - state.x[2])
    x, P = joseph_update(state.x, state.P, v, sigma_phi * sigma_phi, H)
    x = x.at[2].set(wrap_angle(x[2]))
    return state._replace(x=x, P=P)


# ---------------------------------------------------------------------------
# Data association
# ---------------------------------------------------------------------------

def _innovation_stats(state: EKFState, z, zmask, R):
    """Per (observation, feature-slot) innovation statistics against the
    FULL joint covariance, batched.

    For feature j the observation Jacobian is H = [Hv | 0 .. Hf_j .. 0], so
        S_ij = Hv P00 Hv' + Hv P0j Hf' + Hf Pj0 Hv' + Hf Pjj Hf' + R
    (reference: ekfObserveModel + ekfComputeAssociation,
    ekfslam.cpp:97-149, evaluated there one pair at a time).

    Returns (nis [K, L], nd [K, L]) with invalid slots at +inf.
    """
    K = z.shape[0]
    L = state.capacity
    x, P = state.x, state.P
    lm = x[3:].reshape(L, 2)
    valid = jnp.arange(L) < state.n

    # Per-feature joint-covariance blocks.
    P00 = P[:3, :3]                                   # [3, 3]
    Pjj = _diag_blocks_2x2(P[3:, 3:], L)              # [L, 2, 2]
    P0j = P[:3, 3:].T.reshape(L, 2, 3)                # [L, 2, 3] = (Pj0)

    zp, Hv, Hf, _ = compute_jacobians(
        state.pose, lm, Pjj, jnp.asarray(R, P.dtype))  # [L, ...]

    # S_j = Hv P00 Hv' + Hv (P0j' Hf') + (Hf P0j) Hv' + Hf Pjj Hf' + R
    HvP00 = jnp.einsum("lab,bc->lac", Hv, P00, precision=_HIGHEST)
    t1 = jnp.einsum("lab,lcb->lac", HvP00, Hv, precision=_HIGHEST)
    HfPj0 = jnp.einsum("lab,lbc->lac", Hf, P0j, precision=_HIGHEST)
    t2 = jnp.einsum("lab,lcb->lac", HfPj0, Hv, precision=_HIGHEST)
    t3 = jnp.einsum("lab,lbc,ldc->lad", Hf, Pjj, Hf, precision=_HIGHEST)
    S = t1 + t2 + jnp.swapaxes(t2, -1, -2) + t3 + jnp.asarray(R, P.dtype)
    S = 0.5 * (S + jnp.swapaxes(S, -1, -2))           # [L, 2, 2]

    # Innovations for every (obs, feature) pair.
    vfull = z[:, None, :] - zp[None, :, :]            # [K, L, 2]
    vfull = vfull.at[..., 1].set(wrap_angle(vfull[..., 1]))

    Si = inv_2x2(S)                                   # [L, 2, 2]
    # HIGHEST: a TF32 product can flip gated associations.
    nis = jnp.einsum("kla,lab,klb->kl", vfull, Si, vfull,
                     precision=_HIGHEST)
    det = S[:, 0, 0] * S[:, 1, 1] - S[:, 0, 1] * S[:, 1, 0]
    nd = nis + jnp.log(jnp.maximum(det, 1e-30))[None, :]

    bad = ~(valid[None, :] & zmask[:, None])
    inf = jnp.asarray(jnp.inf, nis.dtype)
    return jnp.where(bad, inf, nis), jnp.where(bad, inf, nd)


def ekf_data_associate(state: EKFState, z, zmask, R,
                       gate_reject: float, gate_augment: float):
    """Gated nearest-neighbor association (dataAssociate,
    ekfslam.cpp:151-189), one batched computation instead of the
    reference's per-pair linear scan (its own TODO at ekfslam.cpp:162-163).

    Returns (assoc [K] int32 slot or -1, is_new [K] bool).
    """
    nis, nd = _innovation_stats(state, z, zmask, R)
    gated_nd = jnp.where(nis < gate_reject, nd, jnp.inf)
    best = jnp.argmin(gated_nd, axis=1).astype(jnp.int32)
    matched = jnp.isfinite(jnp.min(gated_nd, axis=1))
    assoc = jnp.where(matched & zmask, best, -1)
    # New feature iff every existing feature is outside the augment gate
    # (min over empty set = +inf => first observations create features).
    is_new = (jnp.min(nis, axis=1) > gate_augment) & zmask
    return assoc, is_new


def ekf_data_associate_known(state: EKFState, ids, zmask):
    """Table-based known association (dataAssociateKnown,
    ekfslam.cpp:201-236 / core.cpp:91-120): observed true id -> stored
    slot; unseen ids become new features."""
    slot = state.da_table[jnp.clip(ids, 0, state.da_table.shape[0] - 1)]
    assoc = jnp.where(zmask & (slot >= 0), slot, -1)
    is_new = zmask & (slot < 0)
    return assoc, is_new


# ---------------------------------------------------------------------------
# Batch update
# ---------------------------------------------------------------------------

def ekf_batch_update(state: EKFState, z, assoc, R) -> EKFState:
    """Single dense Kalman step over all matched observations
    (batchUpdate, ekfslam.cpp:238-267). Unmatched slots contribute zero
    rows of H and zero innovation — exactly no update — so the whole thing
    is one fixed-shape [2K, N] solve."""
    K = z.shape[0]
    L = state.capacity
    N = 3 + 2 * L
    x, P = state.x, state.P
    matched = assoc >= 0
    slot = jnp.where(matched, assoc, 0)

    lm = x[3:].reshape(L, 2)
    Pjj = _diag_blocks_2x2(P[3:, 3:], L)
    zp, Hv, Hf, _ = compute_jacobians(
        state.pose, lm[slot], Pjj[slot], jnp.asarray(R, P.dtype))  # [K,...]

    # Assemble sparse H rows: pose block + scattered feature block.
    H = jnp.zeros((K, 2, N), dtype=P.dtype)
    H = H.at[:, :, :3].set(Hv)
    col = 3 + 2 * slot                                 # [K]
    karr = jnp.arange(K)
    for a in range(2):
        for b in range(2):
            H = H.at[karr, a, col + b].set(Hf[:, a, b])
    H = jnp.where(matched[:, None, None], H, 0.0)

    v = z - zp
    v = v.at[:, 1].set(wrap_angle(v[:, 1]))
    v = jnp.where(matched[:, None], v, 0.0)

    RR = jnp.kron(jnp.eye(K, dtype=P.dtype), jnp.asarray(R, P.dtype))

    x_new, P_new = cholesky_update(x, P, v.reshape(2 * K),
                                   RR, H.reshape(2 * K, N))
    x_new = x_new.at[2].set(wrap_angle(x_new[2]))
    # Symmetrize: the subtractive P - W1 W1' form drifts off-symmetric
    # in f32 over thousands of steps, eventually breaking the next
    # Cholesky (how soon depends on the device's summation order).
    P_new = 0.5 * (P_new + P_new.T)
    return state._replace(x=x_new, P=P_new)


# ---------------------------------------------------------------------------
# Augment
# ---------------------------------------------------------------------------

def ekf_augment(state: EKFState, z, ids, is_new, R) -> EKFState:
    """Add all new features in one masked scatter (augment/ekfAddOneZ,
    ekfslam.cpp:269-323, which loops one observation at a time).

    Sequential-equivalence: adding feature i sets its cross-covariance
    rows to Gv_i P[0:3, :]; a feature j added later then gets
    P[j, i] = Gv_j P00 Gv_i' — reproduced here in closed form for the
    whole batch. Writes for masked/overflowing slots land out of bounds
    and are dropped.
    """
    K = z.shape[0]
    L = state.capacity
    N = 3 + 2 * L
    x, P = state.x, state.P
    Rm = jnp.asarray(R, P.dtype)

    new = is_new
    # Slot for each new obs: n + (#new before it).
    offset = jnp.cumsum(new.astype(jnp.int32)) - new.astype(jnp.int32)
    slot = state.n + offset                              # [K]
    ok = new & (slot < L)
    # Row index of each new feature's first state entry; OOB when masked.
    p = jnp.where(ok, 3 + 2 * slot, N)                   # [K]
    rows = p[:, None] + jnp.arange(2)[None, :]           # [K, 2]
    flat_rows = rows.reshape(-1)                         # [2K]

    xf, Gz = add_feature_init(state.pose, z)             # [K,2], [K,2,2]
    r, b = z[..., 0], z[..., 1]
    sg = jnp.sin(state.x[2] + b)
    cg = jnp.cos(state.x[2] + b)
    # d(feature)/d(pose) (ekfslam.cpp:290-296).
    Gv = jnp.stack([
        jnp.stack([jnp.ones_like(r), jnp.zeros_like(r), -r * sg], -1),
        jnp.stack([jnp.zeros_like(r), jnp.ones_like(r), r * cg], -1),
    ], -2)                                               # [K, 2, 3]

    # State mean scatter.
    x = x.at[flat_rows].set(xf.reshape(-1), mode="drop")

    # Cross rows against the existing state: B_i = Gv_i P[0:3, :].
    B = jnp.einsum("kab,bn->kan", Gv, P[:3, :], precision=_HIGHEST)
    P = P.at[flat_rows, :].set(B.reshape(2 * K, N), mode="drop")
    P = P.at[:, flat_rows].set(B.reshape(2 * K, N).T, mode="drop")

    # New-new blocks: Gv_i P00 Gv_j' (+ Gz_i R Gz_i' on the diagonal).
    P00 = P[:3, :3]
    NN = jnp.einsum("kab,bc,ldc->kald", Gv, P00, Gv,
                    precision=_HIGHEST)                  # [K,2,K,2]
    diag = jnp.einsum("kab,bc,kdc->kad", Gz, Rm, Gz,
                      precision=_HIGHEST)                # [K,2,2]
    NN = NN.at[jnp.arange(K), :, jnp.arange(K), :].add(diag)
    P = P.at[flat_rows[:, None], flat_rows[None, :]].set(
        NN.reshape(2 * K, 2 * K), mode="drop")

    n = state.n + jnp.sum(ok, dtype=jnp.int32)
    table = state.da_table.at[jnp.where(ok, ids, state.da_table.shape[0])
                              ].set(slot, mode="drop")
    return state._replace(x=x, P=P, n=n, da_table=table)


# ---------------------------------------------------------------------------
# Full steps and config-bound wrapper
# ---------------------------------------------------------------------------

def ekf_step(state: EKFState, z, ids, zmask, R, Re,
             *, association_known: bool, gate_reject: float,
             gate_augment: float, batch_update: bool = True) -> EKFState:
    """Observe-tick EKF step: associate (with Re) -> batch update (with
    the true sensor R, as the reference does: ekfslam.cpp:39) -> augment
    (with Re) (EKFSLAM::sim, ekfslam.cpp:30-42). Predict + heading observe
    run every control tick separately."""
    if association_known:
        assoc, is_new = ekf_data_associate_known(state, ids, zmask)
    else:
        assoc, is_new = ekf_data_associate(
            state, z, zmask, Re, gate_reject, gate_augment)
    if batch_update:
        state = ekf_batch_update(state, z, assoc, R)
    state = ekf_augment(state, z, ids, is_new, Re)
    return state


class EkfSlam:
    """Config-bound EKF-SLAM with jitted per-tick and per-observe steps,
    sharing the estimator interface of FastSlam1/FastSlam2."""

    # Fields the per-tick predict may modify (run-loop freeze hint).
    PREDICT_TOUCHED = ("x", "P")
    # Runner hint: EKF estimators observe the noisy IMU heading each tick
    # (ekfslamwrapper.cpp:81); particle filters get the true heading.
    IS_EKF = True

    def __init__(self, config, n_map_landmarks: int):
        self.config = config
        self.n_map = n_map_landmarks
        self.capacity = config.max_landmarks or n_map_landmarks
        cfg = config

        def _predict_tick(state, vn, gn, phi):
            state = ekf_predict(state, vn, gn,
                                jnp.diag(jnp.asarray(cfg.Qe, jnp.float32)),
                                cfg.WHEELBASE, cfg.DT_CONTROLS)
            if cfg.SWITCH_HEADING_KNOWN:
                state = ekf_observe_heading(state, phi, cfg.sigmaT)
            return state

        self._predict = jax.jit(_predict_tick)
        self._update = jax.jit(partial(
            ekf_step,
            association_known=bool(cfg.SWITCH_ASSOCIATION_KNOWN),
            gate_reject=cfg.GATE_REJECT,
            gate_augment=cfg.GATE_AUGMENT,
            batch_update=bool(cfg.SWITCH_BATCH_UPDATE)))

    def init(self, n_particles=None) -> EKFState:
        return ekf_init(self.capacity, self.n_map)

    def predict(self, state, key, vn, gn, phi) -> EKFState:
        """Per control tick (EKFSLAM::sim head, ekfslam.cpp:22-28). The
        EKF is deterministic — ``key`` is part of the shared estimator
        interface and unused; ``phi`` is the noisy IMU heading
        (ekfslamwrapper.cpp:81)."""
        del key
        return self._predict(state, vn, gn, phi)

    def update(self, state, key, z, ids, zmask, phi=None) -> EKFState:
        del key, phi
        cfg = self.config
        return self._update(state, z, ids, zmask,
                            jnp.diag(jnp.asarray(cfg.R, jnp.float32)),
                            jnp.diag(jnp.asarray(cfg.Re, jnp.float32)))

    def pose(self, state) -> jnp.ndarray:
        """Estimated pose = joint-state head (xEstimated[:3])."""
        return state.x[:3]
