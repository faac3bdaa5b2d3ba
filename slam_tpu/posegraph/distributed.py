"""Distributed Schur-complement bundle adjustment.

The landmark axis shards over a 1-D device mesh: each shard assembles the
normal-equation pieces for ITS landmark block (every observation belongs
to exactly one landmark, hence to exactly one shard) and contributes its
slice of the Schur contraction

    S_obs = sum_shards [ App_obs_local - W_local All_local^-1 W_local' ]

via one psum of a [3T, 3T] partial — the pose system is tiny relative to
the landmark system, which is the point of the Schur trick. The reduced
pose solve is replicated; the landmark back-substitution
dl = All^-1 (bl - W' dp) is local to each shard. Odometry factors and the
gauge prior are landmark-free and assembled outside the shard_map.

Exact: matches the single-device solver up to f32 reduction order
— tested against solve_ba on the virtual CPU mesh.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax, shard_map
from jax.sharding import Mesh, PartitionSpec as P

from slam_tpu.geometry import wrap_angle
from slam_tpu.posegraph.ba import (
    PRIOR_INFO,
    BAProblem,
    _ba_cost,
    _obs_terms,
    _odom_residual_jacobians,
    _prior_residual,
)

_HIGHEST = jax.lax.Precision.HIGHEST
LM_AXIS = "l"


def _assemble_local(poses, lm_local, z, lm_idx, mask, Rinv, lam,
                    L_local: int, axis: str):
    """Per-shard observation-side assembly + Schur partials."""
    T = poses.shape[0]
    dtype = poses.dtype
    lo = lax.axis_index(axis) * L_local
    own = mask & (lm_idx >= lo) & (lm_idx < lo + L_local)
    local_idx = jnp.clip(lm_idx - lo, 0, L_local - 1)

    Hv, Hf, r = _obs_terms(poses, lm_local, z, local_idx, own)
    HvR = jnp.einsum("tkab,ac->tkbc", Hv, Rinv, precision=_HIGHEST)
    App_diag = lax.psum(
        jnp.einsum("tkab,tkbc->tac", HvR, Hv, precision=_HIGHEST), axis)
    bp_obs = lax.psum(
        jnp.einsum("tkab,tkb->ta", HvR, r, precision=_HIGHEST), axis)

    HfR = jnp.einsum("tkab,ac->tkbc", Hf, Rinv, precision=_HIGHEST)
    All_terms = jnp.einsum("tkab,tkbc->tkac", HfR, Hf,
                           precision=_HIGHEST)
    bl_terms = jnp.einsum("tkab,tkb->tka", HfR, r, precision=_HIGHEST)
    flat_idx = local_idx.reshape(-1)
    ok = own.reshape(-1)
    drop_idx = jnp.where(ok, flat_idx, L_local)
    All = jnp.zeros((L_local, 2, 2), dtype).at[drop_idx].add(
        All_terms.reshape(-1, 2, 2), mode="drop")
    bl = jnp.zeros((L_local, 2), dtype).at[drop_idx].add(
        bl_terms.reshape(-1, 2), mode="drop")

    Wt = jnp.einsum("tkab,tkbc->tkac", HvR, Hf, precision=_HIGHEST)
    W = jnp.zeros((T, 3, L_local, 2), dtype)
    t_idx = jnp.broadcast_to(jnp.arange(T)[:, None],
                             lm_idx.shape).reshape(-1)
    W = W.at[t_idx, :, drop_idx, :].add(Wt.reshape(-1, 3, 2),
                                        mode="drop")
    W = W.reshape(T * 3, L_local * 2)

    All = All + lam * jnp.eye(2, dtype=dtype)
    det = jnp.maximum(All[:, 0, 0] * All[:, 1, 1]
                      - All[:, 0, 1] * All[:, 1, 0], 1e-20)
    Allinv = jnp.stack([
        jnp.stack([All[:, 1, 1], -All[:, 0, 1]], -1),
        jnp.stack([-All[:, 1, 0], All[:, 0, 0]], -1)], -2) \
        / det[:, None, None]

    WA = jnp.einsum("plc,lcd->pld", W.reshape(3 * T, L_local, 2),
                    Allinv,
                    precision=_HIGHEST).reshape(3 * T, 2 * L_local)
    SW = lax.psum(jnp.matmul(WA, W.T, precision=_HIGHEST), axis)
    rhs_lm = lax.psum(
        jnp.matmul(WA, bl.reshape(-1), precision=_HIGHEST), axis)
    return App_diag, bp_obs, SW, rhs_lm, W, Allinv, bl


def _sharded_cost(mesh: Mesh, poses, landmarks, odom, odom_info, z,
                  lm_idx, mask, R, anchor, L_local: int):
    """Total weighted cost with the observation term computed per
    landmark shard (each shard scores the observations of ITS landmarks,
    psum over the mesh) — no full-landmark re-gather. Odometry + gauge
    terms are landmark-free and evaluated once, replicated."""
    axis = mesh.axis_names[0]
    dtype = poses.dtype
    Rinv = jnp.linalg.inv(jnp.asarray(R, dtype))

    @partial(shard_map, mesh=mesh,
             in_specs=(P(), P(axis, None), P(), P(), P()),
             out_specs=P(), check_vma=False)
    def obs_cost(poses, lm_local, z_, idx_, mask_):
        lo = lax.axis_index(axis) * L_local
        own = mask_ & (idx_ >= lo) & (idx_ < lo + L_local)
        local_idx = jnp.clip(idx_ - lo, 0, L_local - 1)
        lm = lm_local[local_idx]
        dx = lm[..., 0] - poses[:, None, 0]
        dy = lm[..., 1] - poses[:, None, 1]
        rng = jnp.sqrt(jnp.maximum(dx * dx + dy * dy, 1e-24))
        brg = jnp.arctan2(dy, dx) - poses[:, None, 2]
        r0 = z_[..., 0] - rng
        r1 = wrap_angle(z_[..., 1] - brg)
        r = jnp.stack([r0, r1], -1) * own.astype(dtype)[..., None]
        return lax.psum(
            jnp.einsum("tka,ab,tkb->", r, Rinv, r, precision=_HIGHEST),
            axis)

    c_obs = obs_cost(poses, landmarks, z, lm_idx, mask)
    from slam_tpu.posegraph.ba import PRIOR_INFO as _PI
    r_od, _, _ = _odom_residual_jacobians(poses, odom)
    c_od = jnp.einsum("ta,ab,tb->", r_od,
                      jnp.asarray(odom_info, dtype), r_od,
                      precision=_HIGHEST)
    rp = _prior_residual(poses, anchor)
    return c_obs + c_od + _PI * jnp.dot(rp, rp, precision=_HIGHEST)


def make_sharded_gn_step(mesh: Mesh, T: int, L: int):
    """Builds one jitted sharded Gauss-Newton step for fixed shapes."""
    step = _make_trial_fn(mesh, T, L)
    return jax.jit(step)


def _make_trial_fn(mesh: Mesh, T: int, L: int):
    """The sharded GN trial step as a plain traceable function (jitted
    by make_sharded_gn_step; embedded in the LM while_loop by
    make_lm_iteration)."""
    axis = mesh.axis_names[0]
    S_dev = mesh.devices.size
    if L % S_dev:
        raise ValueError(f"L={L} must divide over {S_dev} devices")
    L_local = L // S_dev
    rep = P()

    def step(poses, landmarks, odom, odom_info, z, lm_idx, mask, R,
             anchor, damping):
        dtype = poses.dtype
        Rinv = jnp.linalg.inv(jnp.asarray(R, dtype))
        lam = jnp.asarray(damping, dtype)

        @partial(shard_map, mesh=mesh,
                 in_specs=(rep, P(axis, None), rep, rep, rep),
                 out_specs=(rep, rep, rep, rep, P(None, axis),
                            P(axis, None, None), P(axis, None)),
                 check_vma=False)
        def assemble(poses, lm_local, z_, idx_, mask_):
            return _assemble_local(poses, lm_local, z_, idx_, mask_,
                                   Rinv, lam, L_local, axis)

        App_diag, bp_obs, SW, rhs_lm, W_sh, Allinv_sh, bl_sh = assemble(
            poses, landmarks, z, lm_idx, mask)

        # Pose-side (landmark-free) terms: odometry chain + gauge.
        r_od, Ja, Jb = _odom_residual_jacobians(poses, odom)
        Info = jnp.asarray(odom_info, dtype)
        JaI = jnp.einsum("tab,bc->tac", jnp.swapaxes(Ja, -1, -2), Info,
                         precision=_HIGHEST)
        JbI = jnp.einsum("tab,bc->tac", jnp.swapaxes(Jb, -1, -2), Info,
                         precision=_HIGHEST)
        App = jnp.zeros((T, 3, T, 3), dtype)
        tt = jnp.arange(T)
        App = App.at[tt, :, tt, :].add(App_diag)
        t1 = jnp.arange(T - 1)
        App = App.at[t1, :, t1, :].add(
            jnp.einsum("tab,tbc->tac", JaI, Ja, precision=_HIGHEST))
        Aab = jnp.einsum("tab,tbc->tac", JaI, Jb, precision=_HIGHEST)
        App = App.at[t1, :, t1 + 1, :].add(Aab)
        App = App.at[t1 + 1, :, t1, :].add(jnp.swapaxes(Aab, -1, -2))
        App = App.at[t1 + 1, :, t1 + 1, :].add(
            jnp.einsum("tab,tbc->tac", JbI, Jb, precision=_HIGHEST))
        App = App.at[0, :, 0, :].add(
            PRIOR_INFO * jnp.eye(3, dtype=dtype))
        App = App.reshape(T * 3, T * 3)

        bp = jnp.zeros((T, 3), dtype)
        bp = bp + bp_obs
        bp = bp.at[:-1].add(-jnp.einsum("tab,tb->ta", JaI, r_od,
                                        precision=_HIGHEST))
        bp = bp.at[1:].add(-jnp.einsum("tab,tb->ta", JbI, r_od,
                                       precision=_HIGHEST))
        bp = bp.at[0].add(-PRIOR_INFO * _prior_residual(poses, anchor))

        S = App + lam * jnp.eye(3 * T, dtype=dtype) - SW
        rhs = bp.reshape(-1) - rhs_lm
        dp = jax.scipy.linalg.solve(S, rhs, assume_a="pos")

        # Landmark back-substitution, local per shard.
        @partial(shard_map, mesh=mesh,
                 in_specs=(P(None, axis), P(axis, None, None),
                           P(axis, None), rep),
                 out_specs=P(axis, None), check_vma=False)
        def backsub(W_local, Allinv_local, bl_local, dp_):
            Ll = Allinv_local.shape[0]
            dl_rhs = bl_local.reshape(-1) - jnp.matmul(
                W_local.T, dp_, precision=_HIGHEST)
            return jnp.einsum("lcd,ld->lc", Allinv_local,
                              dl_rhs.reshape(Ll, 2),
                              precision=_HIGHEST)

        dl = backsub(W_sh, Allinv_sh, bl_sh, dp)

        new_poses = poses + dp.reshape(T, 3)
        new_poses = new_poses.at[:, 2].set(wrap_angle(new_poses[:, 2]))
        return new_poses, landmarks + dl

    return step


def make_lm_iteration(mesh: Mesh, T: int, L: int, max_retries: int = 6):
    """One jitted Levenberg-Marquardt iteration, acceptance ON DEVICE:
    the damping-retry loop is a lax.while_loop whose body runs the
    sharded trial step and the sharded psum'd cost — landmarks never
    leave their shard and no host sync happens per trial. The host syncs
    exactly once per ACCEPTED step (to read cost/convergence).

    Returns jit(fn)(poses, landmarks, cost, lam, *static) ->
    (poses', landmarks', cost', lam', accepted)."""
    trial = _make_trial_fn(mesh, T, L)
    L_local = L // mesh.devices.size

    def lm_iter(poses, landmarks, cost, lam, odom, odom_info, z,
                lm_idx, mask, R, anchor):
        static = (odom, odom_info, z, lm_idx, mask, R, anchor)

        def cond(c):
            lam_c, _, _, _, tries, acc = c
            return (~acc) & (tries <= max_retries)

        def body(c):
            lam_c, _, _, _, tries, _ = c
            tp, tl = trial(poses, landmarks, *static, lam_c)
            tc = _sharded_cost(mesh, tp, tl, *static, L_local)
            acc = jnp.isfinite(tc) & (tc <= cost)
            lam_n = jnp.where(acc, lam_c,
                              jnp.minimum(lam_c * 10.0, 1e8))
            return (lam_n, tp, tl, tc, tries + 1, acc)

        init = (lam, poses, landmarks, jnp.float32(jnp.inf),
                jnp.int32(0), jnp.bool_(False))
        lam_f, tp, tl, tc, _tries, acc = jax.lax.while_loop(cond, body,
                                                            init)
        new_p = jnp.where(acc, tp, poses)
        new_l = jnp.where(acc, tl, landmarks)
        new_cost = jnp.where(acc, tc, cost)
        new_lam = jnp.where(acc, jnp.maximum(lam_f / 3.0, 1e-9), lam_f)
        return new_p, new_l, new_cost, new_lam, acc

    return jax.jit(lm_iter)


def solve_ba_sharded(prob: BAProblem, mesh: Mesh, iters: int = 10,
                     damping: float = 1e-3, tol: float = 1e-8,
                     max_retries: int = 6, return_info: bool = False):
    """Distributed Schur-complement BA over a landmark-sharded mesh.

    Same Levenberg-Marquardt schedule as the single-chip solve_ba
    (trial kept iff total cost decreases, damping x10 on reject, /3 on
    accept), but the whole accept/retry loop runs device-side
    (make_lm_iteration): per LM iteration there is ONE host round trip,
    the sharded cost is psum'd, and the sharded landmark slices are
    never re-gathered."""
    S_dev = mesh.devices.size
    L_pad = -(-prob.L // S_dev) * S_dev
    lm_iter = make_lm_iteration(mesh, prob.T, L_pad,
                                max_retries=max_retries)
    poses = jnp.asarray(prob.poses0, jnp.float32)
    landmarks = jnp.asarray(prob.landmarks0, jnp.float32)
    # Pad the landmark system to a multiple of the shard count. Padded
    # rows have no observations, so their normal-equation blocks are
    # pure damping (lam*I) — invertible and inert; they stay at zero.
    if L_pad != prob.L:
        landmarks = jnp.concatenate(
            [landmarks, jnp.zeros((L_pad - prob.L, 2), jnp.float32)])
    anchor = poses[0]
    static = (prob.odom, prob.odom_info, prob.z, prob.lm_idx, prob.mask,
              prob.R, anchor)
    lam = jnp.float32(damping)
    cost = _ba_cost(poses, landmarks, *static)
    costs = [float(cost)]
    n_iters = 0
    for _ in range(iters):
        poses, landmarks, new_cost, lam, acc = lm_iter(
            poses, landmarks, cost, lam, *static)
        n_iters += 1
        new_cost_f = float(new_cost)          # the one host sync
        if not bool(acc):
            break
        gain = float(cost) - new_cost_f
        cost = new_cost
        costs.append(new_cost_f)
        if gain <= tol * max(new_cost_f, 1.0):
            break
    landmarks = landmarks[:prob.L]
    if return_info:
        return poses, landmarks, {"costs": costs, "n_iters": n_iters}
    return poses, landmarks
