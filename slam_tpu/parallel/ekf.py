"""Landmark-axis (TP-analog) sharded EKF-SLAM.

The reference's scaling wall is the dense joint covariance: every observe
does O(N^2) work on one core and the matrix is O(L^2) in landmarks
(ekfslam.cpp:65-77, batchUpdate ekfslam.cpp:238-267). At the 10k-landmark
BASELINE config the joint covariance is [20003, 20003] f32 = 1.6 GB —
too big to replicate per device and far too big to update densely.

Decomposition (SURVEY.md §2.9 "block-sharded covariance"):

    P = [ P00  P0m ]     P00 [3, 3]     replicated   (pose block)
        [ P0m' Pmm ]     P0m [3, 2L]    replicated   (pose-landmark)
                         Pmm [2L, 2L]   ROW-SHARDED  (landmark-landmark)

Pmm's rows shard over a 1-D `l` mesh axis: each device owns a contiguous
[2L/S, 2L] slab. Per-observe communication is tiny and fixed-size:

  - innovation covariance  S = H P H' + R: the landmark-block partial
    contractions psum over `l` ([2K, 2K]);
  - the Kalman gain's landmark rows all_gather once per update
    ([2L, 2K] — a few MB at L=10k, K<=32, vs moving any O(L^2) slab);
  - association statistics need only diag 2x2 blocks of Pmm:
    each shard extracts its own diagonal (slam_tpu.models.ekf's strided
    O(L) trick) and all_gathers [L, 2, 2].

Everything else (predict, heading observe, augment) touches only pose
rows / rank-1 terms and runs shard-local on the owned slab. Work and
memory per device are O(L^2 / S).

Equality-tested against the dense single-device EKF at small L on the
virtual CPU mesh (tests/test_parallel_ekf.py).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from slam_tpu.geometry import wrap_angle
from slam_tpu.ops.jacobians import compute_jacobians
from slam_tpu.ops.kalman import add_feature_init, inv_2x2

_HIGHEST = jax.lax.Precision.HIGHEST
LM_AXIS = "l"


class ShardedEKFState(NamedTuple):
    """Joint EKF state with the landmark-landmark covariance row-sharded.

    ``x``: [3 + 2L] joint mean (replicated). ``P00``: [3, 3]. ``P0m``:
    [3, 2L]. ``Pmm``: [2L, 2L], rows sharded over the `l` mesh axis.
    ``n``: live landmark count. ``da_table``: [n_map] id -> slot.

    ``hk`` [2L, D] / ``hk_n``: DEFERRED heading rank-1 terms. The
    per-tick scalar heading observe (ekfslam.cpp:86-95) subtracts
    (1/s) c c' from the full joint covariance; its Pmm block only
    feeds the NEXT observe (predict reads P00/P0m alone), so the
    scaled columns u_t = c_m / sqrt(s_t) accumulate here and fold into
    Pmm once per observe: true Pmm = stored Pmm - hk hk'. Exact
    algebra; it converts 8 O(L^2) full-covariance passes per superstep
    into 8 O(L) cross-row updates + ONE fold.
    """
    x: jnp.ndarray
    P00: jnp.ndarray
    P0m: jnp.ndarray
    Pmm: jnp.ndarray
    n: jnp.ndarray
    da_table: jnp.ndarray
    hk: jnp.ndarray
    hk_n: jnp.ndarray

    @property
    def capacity(self) -> int:
        return (self.x.shape[-1] - 3) // 2

    @property
    def pose(self) -> jnp.ndarray:
        return self.x[:3]


def sharded_ekf_init(capacity: int, n_map_landmarks: int,
                     dtype=jnp.float32,
                     n_defer: int = 16) -> ShardedEKFState:
    L2 = 2 * capacity
    return ShardedEKFState(
        x=jnp.zeros(3 + L2, dtype=dtype),
        P00=jnp.zeros((3, 3), dtype=dtype),
        P0m=jnp.zeros((3, L2), dtype=dtype),
        Pmm=jnp.zeros((L2, L2), dtype=dtype),
        n=jnp.int32(0),
        da_table=jnp.full((n_map_landmarks,), -1, dtype=jnp.int32),
        hk=jnp.zeros((L2, n_defer), dtype=dtype),
        hk_n=jnp.int32(0),
    )


def state_specs(axis: str = LM_AXIS) -> ShardedEKFState:
    return ShardedEKFState(
        x=P(), P00=P(), P0m=P(), Pmm=P(axis, None), n=P(), da_table=P(),
        hk=P(), hk_n=P())


# ---------------------------------------------------------------------------
# Shard-local step bodies (run inside shard_map)
# ---------------------------------------------------------------------------

def _predict_local(state: ShardedEKFState, v, g, Q, wheelbase, dt,
                   phi, sigma_phi, heading_known: bool, axis: str):
    """Bicycle predict (pose block + cross rows only — Pmm untouched;
    the reference's O(N) sparse predict, ekfslam.cpp:46-77) followed by
    the optional scalar heading Joseph update (ekfslam.cpp:86-95), whose
    Pmm term is an outer-product rank-1 update on the local slab."""
    x = state.x
    theta = x[2]
    s, c = jnp.sin(g + theta), jnp.cos(g + theta)
    vts, vtc = v * dt * s, v * dt * c
    dtype = x.dtype

    Gv = jnp.eye(3, dtype=dtype).at[0, 2].set(-vts).at[1, 2].set(vtc)
    sg, cg = jnp.sin(g), jnp.cos(g)
    Gu = jnp.stack([
        jnp.stack([dt * c, -vts]),
        jnp.stack([dt * s, vtc]),
        jnp.stack([dt * sg / wheelbase, v * dt * cg / wheelbase]),
    ]).astype(dtype)

    mm = lambda a, b: jnp.matmul(a, b, precision=_HIGHEST)
    P00 = mm(mm(Gv, state.P00), Gv.T) + mm(mm(Gu, Q), Gu.T)
    P0m = mm(Gv, state.P0m)

    x = x.at[0].add(vtc)
    x = x.at[1].add(vts)
    x = x.at[2].set(wrap_angle(theta + v * dt * sg / wheelbase))
    state = state._replace(x=x, P00=P00, P0m=P0m)

    if not heading_known:
        return state

    # Scalar heading observe, Joseph form on the decomposed covariance.
    r = sigma_phi * sigma_phi
    s_inn = state.P00[2, 2] + r
    # W = P[:, 2] / s: pose part [3], landmark part [2L] (replicated).
    Wp = state.P00[:, 2] / s_inn
    Wm = state.P0m[2, :] / s_inn
    vh = wrap_angle(phi - state.x[2])

    x = state.x.at[:3].add(Wp * vh)
    x = x.at[3:].add(Wm * vh)
    x = x.at[2].set(wrap_angle(x[2]))

    # P' = P - W c' - c W' + (s) W W', with c = P[:, 2] (Joseph form
    # collapsed; exact for scalar observations). The Pmm block term
    # collapses to -(1/s) c_m c_m' and is DEFERRED (see
    # ShardedEKFState.hk); nothing before the next observe reads Pmm.
    cp = state.P00[:, 2]
    cm = state.P0m[2, :]
    P00 = state.P00 - jnp.outer(Wp, cp) - jnp.outer(cp, Wp) \
        + s_inn * jnp.outer(Wp, Wp)
    P0m = state.P0m - jnp.outer(Wp, cm) - jnp.outer(cp, Wm) \
        + s_inn * jnp.outer(Wp, Wm)
    u = cm / jnp.sqrt(s_inn)
    D = state.hk.shape[1]

    def defer(st):
        return st._replace(
            hk=lax.dynamic_update_slice(st.hk, u[:, None],
                                        (0, st.hk_n)),
            hk_n=st.hk_n + 1)

    def fold_now(st):
        # Accumulator full (an estimator driven with more predicts
        # per observe than n_defer): apply this tick's term eagerly.
        rows = st.Pmm.shape[0]
        row_lo = lax.axis_index(axis) * rows
        u_loc = lax.dynamic_slice(u, (row_lo,), (rows,))
        return st._replace(Pmm=st.Pmm - jnp.outer(u_loc, u))

    state = state._replace(x=x, P00=P00, P0m=P0m)
    return lax.cond(state.hk_n < D, defer, fold_now, state)


def _diag_blocks_local(Pmm_local, row_lo):
    """[Ll, 2, 2] diagonal blocks owned by this shard: local row r of the
    slab corresponds to global column row_lo + r."""
    rows = Pmm_local.shape[0]
    Ll = rows // 2
    cols = row_lo + jnp.arange(rows)
    d = Pmm_local[jnp.arange(rows), cols]                  # P[i, i]
    d1 = Pmm_local[jnp.arange(rows - 1), cols[:-1] + 1]    # P[i, i+1]
    p00 = d[0::2]
    p11 = d[1::2]
    p01 = d1[0::2]
    return jnp.stack([jnp.stack([p00, p01], -1),
                      jnp.stack([p01, p11], -1)], -2)


def _gather_diag_blocks(state: ShardedEKFState, axis: str):
    """All-gathered [L, 2, 2] diagonal blocks of Pmm (tiny)."""
    rows = state.Pmm.shape[0]
    row_lo = lax.axis_index(axis) * rows
    local = _diag_blocks_local(state.Pmm, row_lo)          # [Ll, 2, 2]
    return lax.all_gather(local, axis).reshape(-1, 2, 2)   # [L, 2, 2]


def _update_local(state: ShardedEKFState, z, ids, zmask, R, Re,
                  gate_reject, gate_augment, association_known: bool,
                  axis: str):
    """Observe-tick step: associate -> batch update -> augment
    (EKFSLAM::sim, ekfslam.cpp:30-42) on the decomposed covariance."""
    K = z.shape[0]
    L = state.capacity
    N2 = 2 * L
    dtype = state.x.dtype
    Rm = jnp.asarray(R, dtype)
    Rem = jnp.asarray(Re, dtype)
    rows = state.Pmm.shape[0]
    row_lo = lax.axis_index(axis) * rows

    # Deferred heading terms: true Pmm = stored Pmm - hk hk'. Rather
    # than materializing the fold (a full [2L, 2L] pass), every cheap
    # read below gets the low-rank correction and the subtraction
    # rides the batch update's single full-covariance pass.
    hk = state.hk
    hk_loc = lax.dynamic_slice(hk, (row_lo, 0), (rows, hk.shape[1]))

    lm = state.x[3:].reshape(L, 2)
    valid = jnp.arange(L) < state.n
    Pjj = _gather_diag_blocks(state, axis)                 # [L, 2, 2]
    # Correct the 2x2 diagonal blocks: block l rows are hk[2l : 2l+2].
    hk_blk = hk.reshape(L, 2, hk.shape[1])
    Pjj = Pjj - jnp.einsum("lad,lbd->lab", hk_blk, hk_blk,
                           precision=_HIGHEST)

    # ---- association ---------------------------------------------------
    if association_known:
        slot_tab = state.da_table[
            jnp.clip(ids, 0, state.da_table.shape[0] - 1)]
        assoc = jnp.where(zmask & (slot_tab >= 0), slot_tab, -1)
        is_new = zmask & (slot_tab < 0)
    else:
        zp_a, Hv_a, Hf_a, _ = compute_jacobians(state.pose, lm, Pjj, Rem)
        P0j = state.P0m.T.reshape(L, 2, 3)
        HvP00 = jnp.einsum("lab,bc->lac", Hv_a, state.P00,
                           precision=_HIGHEST)
        t1 = jnp.einsum("lab,lcb->lac", HvP00, Hv_a, precision=_HIGHEST)
        HfPj0 = jnp.einsum("lab,lbc->lac", Hf_a, P0j, precision=_HIGHEST)
        t2 = jnp.einsum("lab,lcb->lac", HfPj0, Hv_a, precision=_HIGHEST)
        t3 = jnp.einsum("lab,lbc,ldc->lad", Hf_a, Pjj, Hf_a,
                        precision=_HIGHEST)
        S = t1 + t2 + jnp.swapaxes(t2, -1, -2) + t3 + Rem
        S = 0.5 * (S + jnp.swapaxes(S, -1, -2))
        vfull = z[:, None, :] - zp_a[None, :, :]
        vfull = vfull.at[..., 1].set(wrap_angle(vfull[..., 1]))
        Si = inv_2x2(S)
        # HIGHEST: a TF32 product can flip gated associations.
        nis = jnp.einsum("kla,lab,klb->kl", vfull, Si, vfull,
                         precision=_HIGHEST)
        det = S[:, 0, 0] * S[:, 1, 1] - S[:, 0, 1] * S[:, 1, 0]
        nd = nis + jnp.log(jnp.maximum(det, 1e-30))[None, :]
        bad = ~(valid[None, :] & zmask[:, None])
        inf = jnp.asarray(jnp.inf, nis.dtype)
        nis = jnp.where(bad, inf, nis)
        nd = jnp.where(bad, inf, nd)
        gated_nd = jnp.where(nis < gate_reject, nd, jnp.inf)
        best = jnp.argmin(gated_nd, axis=1).astype(jnp.int32)
        matched_a = jnp.isfinite(jnp.min(gated_nd, axis=1))
        assoc = jnp.where(matched_a & zmask, best, -1)
        is_new = (jnp.min(nis, axis=1) > gate_augment) & zmask

    matched = assoc >= 0
    slot = jnp.where(matched, assoc, 0)

    # ---- batch update --------------------------------------------------
    zp, Hv, Hf, _ = compute_jacobians(state.pose, lm[slot], Pjj[slot],
                                      Rm)                  # [K, ...]
    Hv = jnp.where(matched[:, None, None], Hv, 0.0)
    Hf = jnp.where(matched[:, None, None], Hf, 0.0)

    # Sparse H = [Hp | Hm] with Hm having one 2x2 block per row pair.
    Hp = Hv.reshape(2 * K, 3)                              # [2K, 3]
    col = 2 * slot
    karr = jnp.arange(K)
    Hm = jnp.zeros((K, 2, N2), dtype)
    for a in range(2):
        for b in range(2):
            Hm = Hm.at[karr, a, col + b].set(Hf[:, a, b])
    Hm = Hm.reshape(2 * K, N2)                             # [2K, 2L]

    v = z - zp
    v = v.at[:, 1].set(wrap_angle(v[:, 1]))
    v = jnp.where(matched[:, None], v, 0.0).reshape(2 * K)

    mm = lambda a, b: jnp.matmul(a, b, precision=_HIGHEST)
    # PHt pose rows [3, 2K] (replicated) and landmark rows:
    #   PHt_m = Pm0 Hp' + Pmm Hm'  — local slab rows.
    # Pmm Hm' only touches the 2K observed block-columns, but a dense
    # [2L, 2L] x [2L, 2K] matmul at HIGHEST reads all of Pmm.
    # By symmetry the needed columns are the observed ROWS (contiguous
    # gather); each shard contributes its owned subset and a psum
    # assembles the [2K, 2L] row block.
    PHt_p = mm(state.P00, Hp.T) + mm(state.P0m, Hm.T)      # [3, 2K]
    P0m_loc = lax.dynamic_slice(state.P0m, (0, row_lo), (3, rows))
    gcol = (2 * slot[:, None] + jnp.arange(2)[None, :]).reshape(-1)
    lrow = gcol - row_lo
    own_r = (lrow >= 0) & (lrow < rows)
    obs_rows = state.Pmm[jnp.where(own_r, lrow, 0), :] \
        * own_r[:, None].astype(dtype)                     # [2K, 2L]
    obs_rows = lax.psum(obs_rows, axis)
    obs_rows = obs_rows - jnp.matmul(hk[gcol, :], hk.T,
                                     precision=_HIGHEST)
    HmP = jnp.einsum("kab,kbn->kan", Hf,
                     obs_rows.reshape(K, 2, N2),
                     precision=_HIGHEST).reshape(2 * K, N2)
    PHt_m_loc = mm(P0m_loc.T, Hp.T) + lax.dynamic_slice(
        HmP, (0, row_lo), (2 * K, rows)).T                 # [rows, 2K]

    # S = H P H' + R (psum the sharded landmark contraction).
    Hm_loc = lax.dynamic_slice(Hm, (0, row_lo), (2 * K, rows))
    S = mm(Hp, PHt_p) + lax.psum(mm(Hm_loc, PHt_m_loc), axis)
    RR = jnp.kron(jnp.eye(K, dtype=dtype), Rm)
    S = 0.5 * (S + S.T) + RR
    S = S + 1e-6 * jnp.trace(S) / (2 * K) * jnp.eye(2 * K, dtype=dtype)

    Lc = jax.scipy.linalg.cholesky(S, lower=True)
    # W1 = PHt L^-T ; P -= W1 W1' ; x += PHt S^-1 v.
    sol = lambda b: jax.scipy.linalg.solve_triangular(Lc, b, lower=True)
    W1_p = sol(PHt_p.T).T                                  # [3, 2K]
    W1_m_loc = sol(PHt_m_loc.T).T                          # [rows, 2K]
    W1_m = lax.all_gather(W1_m_loc, axis).reshape(N2, 2 * K)

    sv = sol(v)                                            # [2K]
    dx_p = mm(W1_p, sv)
    dx_m = mm(W1_m, sv)
    x = state.x.at[:3].add(dx_p)
    x = x.at[3:].add(dx_m)
    x = x.at[2].set(wrap_angle(x[2]))

    P00 = state.P00 - mm(W1_p, W1_p.T)
    P0m = state.P0m - mm(W1_p, W1_m.T)
    # ONE full-covariance pass: batch update + the deferred heading
    # fold fused (XLA emits a single subtract fusion over Pmm).
    Pmm = state.Pmm - mm(W1_m_loc, W1_m.T) \
        - jnp.matmul(hk_loc, hk.T, precision=_HIGHEST)
    P00 = 0.5 * (P00 + P00.T)
    state = state._replace(x=x, P00=P00, P0m=P0m, Pmm=Pmm,
                           hk=jnp.zeros_like(hk), hk_n=jnp.int32(0))

    # ---- augment -------------------------------------------------------
    state = _augment_local(state, z, ids, is_new, Rem, row_lo, rows)
    return state


def _augment_local(state: ShardedEKFState, z, ids, is_new, Re,
                   row_lo, rows):
    """Masked batch augment (ekfslam.cpp:269-323) on the decomposed
    covariance. New feature i at slot s_i:
        x[3+2s : 3+2s+2]    = xf_i
        P0m[:, 2s : 2s+2]   = P[0:3, :3] Gv_i'                (replicated)
        Pmm[2s rows, :]     = Gv_i [P0m ; ...]  cross terms   (sharded)
    Sequential-equivalence closed form as in models.ekf.ekf_augment."""
    K = z.shape[0]
    L = state.capacity
    N2 = 2 * L
    dtype = state.x.dtype

    new = is_new
    offset = jnp.cumsum(new.astype(jnp.int32)) - new.astype(jnp.int32)
    slot = state.n + offset
    ok = new & (slot < L)
    p = jnp.where(ok, 2 * slot, N2)                        # col index; OOB drop
    cols = p[:, None] + jnp.arange(2)[None, :]
    flat_cols = cols.reshape(-1)                           # [2K]

    xf, Gz = add_feature_init(state.pose, z)
    r, b = z[..., 0], z[..., 1]
    sg = jnp.sin(state.x[2] + b)
    cg = jnp.cos(state.x[2] + b)
    Gv = jnp.stack([
        jnp.stack([jnp.ones_like(r), jnp.zeros_like(r), -r * sg], -1),
        jnp.stack([jnp.zeros_like(r), jnp.ones_like(r), r * cg], -1),
    ], -2)                                                 # [K, 2, 3]

    def augment(state):
        x = state.x.at[3 + flat_cols].set(xf.reshape(-1), mode="drop")

        # Cross rows vs existing state: B_i = Gv_i [P00 | P0m].
        Bp = jnp.einsum("kab,bc->kac", Gv, state.P00,
                        precision=_HIGHEST)
        Bm = jnp.einsum("kab,bn->kan", Gv, state.P0m,
                        precision=_HIGHEST)

        # P0m gets the new columns: P0m[:, 2s_i + b] = (Gv_i P00)[b].
        P0m = state.P0m.at[:, flat_cols].set(Bp.reshape(2 * K, 3).T,
                                             mode="drop")

        # Pmm cross rows and columns. Rows: slots owned by this shard.
        local_r = flat_cols - row_lo                       # [2K]
        ok_row = (local_r >= 0) & (local_r < rows)
        row_idx = jnp.where(ok_row, local_r, rows)         # OOB drop
        # Columns on every shard's slab: the transpose of Bm
        # restricted to local rows.
        Bm_locT = Bm.reshape(2 * K, N2).T                  # [2L, 2K]
        Bm_loc = lax.dynamic_slice(Bm_locT, (row_lo, 0),
                                   (rows, 2 * K))

        # New-new blocks: Gv_i P00 Gv_j' + diag(Gz R Gz').
        NN = jnp.einsum("kab,bc,ldc->kald", Gv, state.P00, Gv,
                        precision=_HIGHEST)
        diag = jnp.einsum("kab,bc,kdc->kad", Gz,
                          jnp.asarray(Re, dtype), Gz,
                          precision=_HIGHEST)
        NN = NN.at[jnp.arange(K), :, jnp.arange(K), :].add(diag)

        # One-hot placement instead of row/column scatters: expressed
        # as matmuls against one-hot selectors the whole augment is one
        # fused elementwise pass over Pmm plus two [rows, 2K] x [2K, 2L]
        # contractions. HIGHEST precision with an exactly-representable
        # 0/1 operand places the values bit-exactly.
        E = (row_idx[:, None] == jnp.arange(rows)[None, :]
             ).astype(dtype)                               # [2K, rows]
        F = (flat_cols[:, None] == jnp.arange(N2)[None, :]
             ).astype(dtype)                               # [2K, 2L]
        keep_r = 1.0 - jnp.sum(E, axis=0)                  # [rows]
        keep_c = 1.0 - jnp.sum(F, axis=0)                  # [2L]
        Bfull = Bm.reshape(2 * K, N2)
        NNF = jnp.matmul(NN.reshape(2 * K, 2 * K), F,
                         precision=_HIGHEST)               # [2K, 2L]
        Pmm = (state.Pmm * (keep_r[:, None] * keep_c[None, :])
               + jnp.matmul(E.T, Bfull * keep_c[None, :] + NNF,
                            precision=_HIGHEST)
               + jnp.matmul(Bm_loc * keep_r[:, None], F,
                            precision=_HIGHEST))
        return state._replace(x=x, P0m=P0m, Pmm=Pmm)

    # Cond-gated: the two one-hot placement contractions are ~76 GMAC
    # each at HIGHEST precision (computed at K = 96, L = 10k), so they
    # run only when a landmark is added.
    state = jax.lax.cond(jnp.any(ok), augment, lambda s: s, state)
    n = state.n + jnp.sum(ok, dtype=jnp.int32)
    table = state.da_table.at[
        jnp.where(ok, ids, state.da_table.shape[0])].set(slot,
                                                         mode="drop")
    return state._replace(n=n, da_table=table)


# ---------------------------------------------------------------------------
# Estimator wrapper (Runner-compatible)
# ---------------------------------------------------------------------------

class ShardedEkfSlam:
    """Landmark-sharded EKF-SLAM sharing the estimator interface of
    EkfSlam (slam_tpu.models.ekf). ``mesh``: 1-D mesh over the landmark
    axis. Capacity is padded so 2L divides over the mesh."""

    PREDICT_TOUCHED = ("x", "P00", "P0m", "Pmm")
    IS_EKF = True
    # Two supersteps per scan body: the batch update writes Pmm into a
    # fresh buffer, so a 1-superstep body can pay a full-covariance
    # carry copy every iteration; with A -> B -> A the second update's
    # output lands back in the carry allocation.
    SCAN_PAIR = True

    def __init__(self, config, n_map_landmarks: int, mesh: Mesh):
        self.config = config
        self.n_map = n_map_landmarks
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        S = mesh.devices.size
        cap = config.max_landmarks or n_map_landmarks
        # Pad so every shard owns whole landmarks: 2L % (2S) == 0.
        self.capacity = -(-cap // S) * S
        cfg = config
        specs = state_specs(self.axis)

        Q = jnp.diag(jnp.asarray(cfg.Qe, jnp.float32))

        def predict_local(state, vn, gn, phi):
            return _predict_local(
                state, vn, gn, Q, cfg.WHEELBASE, cfg.DT_CONTROLS,
                phi, cfg.sigmaT, bool(cfg.SWITCH_HEADING_KNOWN),
                self.axis)

        def update_local(state, z, ids, zmask, R, Re):
            return _update_local(
                state, z, ids, zmask, R, Re,
                cfg.GATE_REJECT, cfg.GATE_AUGMENT,
                bool(cfg.SWITCH_ASSOCIATION_KNOWN), self.axis)

        scalar = P()
        self._predict = jax.jit(shard_map(
            predict_local, mesh=mesh,
            in_specs=(specs, scalar, scalar, scalar),
            out_specs=specs, check_vma=False))
        self._update = jax.jit(shard_map(
            update_local, mesh=mesh,
            in_specs=(specs, scalar, scalar, scalar, scalar, scalar),
            out_specs=specs, check_vma=False))

    def init(self, n_particles=None) -> ShardedEKFState:
        state = sharded_ekf_init(self.capacity, self.n_map)
        shardings = jax.tree.map(
            lambda s: NamedSharding(self.mesh, s), state_specs(self.axis),
            is_leaf=lambda x: isinstance(x, P))
        return jax.device_put(state, shardings)

    def predict(self, state, key, vn, gn, phi):
        del key
        return self._predict(state, vn, gn, phi)

    def update(self, state, key, z, ids, zmask, phi=None):
        del key, phi
        cfg = self.config
        return self._update(state, z, ids, zmask,
                            jnp.diag(jnp.asarray(cfg.R, jnp.float32)),
                            jnp.diag(jnp.asarray(cfg.Re, jnp.float32)))

    def pose(self, state):
        return state.x[:3]


def dense_covariance(state: ShardedEKFState) -> jnp.ndarray:
    """Reassemble the dense [3+2L, 3+2L] joint covariance (tests only),
    folding any deferred heading terms."""
    Pmm = state.Pmm - jnp.matmul(state.hk, state.hk.T, precision=_HIGHEST)
    top = jnp.concatenate([state.P00, state.P0m], axis=1)
    bot = jnp.concatenate([state.P0m.T, Pmm], axis=1)
    return jnp.concatenate([top, bot], axis=0)
