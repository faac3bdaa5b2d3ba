"""Batch bundle adjustment: Gauss-Newton + Schur complement, as dense
matrix products.

The trajectory refinement stage over stored keyframes (BASELINE.md; no
reference counterpart — the reference never smooths). Problem structure:

- SE(2) odometry factors between consecutive keyframe poses (measured
  relative transforms, e.g. from the filter trajectory);
- range-bearing observation factors tying keyframe poses to landmarks
  (the same h/Hv/Hf model as the filters, slam_tpu.ops.planes);
- a prior on pose 0 fixing the gauge.

Solved by Levenberg-Marquardt (Gauss-Newton with adaptive damping and
step acceptance: a trial step is kept only if the total weighted cost
decreases, otherwise the damping is raised and the step recomputed) with
the landmarks eliminated via the Schur complement: the landmark system
is block-diagonal (2x2 per landmark), so

    S   = App - W All^-1 W',        rhs = bp - W All^-1 bl
    dp  = S^-1 rhs,                 dl  = All^-1 (bl - W' dp)

where W = Apl is assembled DENSE [3T, 2L]: the S contraction is then one
large matmul instead of sparse scatter math. At the benchmark scale
(T=256 keyframes, L=10k landmarks) W is ~60 MB and the contraction ~12
GFLOP (computed): small for one device, and the landmark axis shards
over a mesh with a psum over shards (solve_ba(mesh=...)).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from slam_tpu.geometry import wrap_angle
from slam_tpu.ops import planes as pk

_HIGHEST = jax.lax.Precision.HIGHEST

# Information weight of the gauge-prior factor anchoring pose 0. This is
# a REAL factor (residual pulls pose 0 back to its anchor), not just a
# diagonal stiffener: without the residual term the whole solution can
# drift to any rigid transform of the optimum (obs + odom factors are
# invariant under global SE(2) motion) while the per-step damping hides
# it — the round-1 divergence-at-scale was exactly this gauge drift.
PRIOR_INFO = 1.0e6


@dataclass(frozen=True)
class BAProblem:
    poses0: jnp.ndarray      # [T, 3] initial keyframe poses
    landmarks0: jnp.ndarray  # [L, 2] initial landmark estimates
    odom: jnp.ndarray        # [T-1, 3] measured relative transforms
    odom_info: jnp.ndarray   # [3, 3] odometry information matrix
    z: jnp.ndarray           # [T, K, 2] observations
    lm_idx: jnp.ndarray      # [T, K] landmark index per obs
    mask: jnp.ndarray        # [T, K] validity
    R: jnp.ndarray           # [2, 2] observation noise

    @property
    def T(self):
        return self.poses0.shape[0]

    @property
    def L(self):
        return self.landmarks0.shape[0]


def to_local(a, b):
    """Relative SE(2) transform of pose b expressed in frame of pose a
    ([..., 3] each)."""
    c, s = jnp.cos(a[..., 2]), jnp.sin(a[..., 2])
    dx = b[..., 0] - a[..., 0]
    dy = b[..., 1] - a[..., 1]
    return jnp.stack([c * dx + s * dy,
                      -s * dx + c * dy,
                      wrap_angle(b[..., 2] - a[..., 2])], axis=-1)


def _odom_residual_jacobians(poses, odom):
    """r_t = to_local(x_t, x_{t+1}) - m_t with SE(2) Jacobians.
    Returns (r [T-1,3], Ja [T-1,3,3], Jb [T-1,3,3])."""
    a = poses[:-1]
    b = poses[1:]
    c, s = jnp.cos(a[:, 2]), jnp.sin(a[:, 2])
    dx = b[:, 0] - a[:, 0]
    dy = b[:, 1] - a[:, 1]
    lx = c * dx + s * dy
    ly = -s * dx + c * dy
    r = jnp.stack([lx - odom[:, 0], ly - odom[:, 1],
                   wrap_angle(b[:, 2] - a[:, 2] - odom[:, 2])], axis=-1)
    zeros = jnp.zeros_like(c)
    ones = jnp.ones_like(c)
    Ja = jnp.stack([
        jnp.stack([-c, -s, ly], -1),
        jnp.stack([s, -c, -lx], -1),
        jnp.stack([zeros, zeros, -ones], -1)], -2)
    Jb = jnp.stack([
        jnp.stack([c, s, zeros], -1),
        jnp.stack([-s, c, zeros], -1),
        jnp.stack([zeros, zeros, ones], -1)], -2)
    return r, Ja, Jb


def _obs_terms(poses, landmarks, z, lm_idx, mask):
    """Per-observation Gauss-Newton contributions (plane math shared
    with the filters). Returns blocks for assembly:
    Hv [T,K,2,3], Hf [T,K,2,2], r [T,K,2] — all masked to zero."""
    lm = landmarks[lm_idx]                      # [T, K, 2]
    J = pk.jacobians_planes(
        poses[:, None, 0], poses[:, None, 1], poses[:, None, 2],
        lm[..., 0], lm[..., 1],
        jnp.zeros_like(lm[..., 0]), jnp.zeros_like(lm[..., 0]),
        jnp.zeros_like(lm[..., 0]),
        0.0, 0.0, 0.0)
    r0 = z[..., 0] - J.zr
    r1 = wrap_angle(z[..., 1] - J.zb)
    m = mask.astype(poses.dtype)
    zeros = jnp.zeros_like(J.a)
    Hv = jnp.stack([
        jnp.stack([J.hv00, J.hv01, zeros], -1),
        jnp.stack([J.hv10, J.hv11, -jnp.ones_like(J.a)], -1)], -2)
    Hf = jnp.stack([
        jnp.stack([J.a, J.b], -1),
        jnp.stack([J.c, J.e], -1)], -2)
    r = jnp.stack([r0, r1], -1) * m[..., None]
    Hv = Hv * m[..., None, None]
    Hf = Hf * m[..., None, None]
    return Hv, Hf, r


def _prior_residual(poses, anchor):
    """Gauge-prior residual: pose 0 vs its anchor, heading wrapped."""
    return jnp.concatenate([
        poses[0, :2] - anchor[:2],
        wrap_angle(poses[0, 2:3] - anchor[2:3])])


def _gn_normal_blocks(poses, landmarks, odom, odom_info, z, lm_idx,
                      mask, R, anchor, L: int):
    """Assemble all Gauss-Newton normal-equation pieces."""
    T = poses.shape[0]
    dtype = poses.dtype
    Rinv = jnp.linalg.inv(jnp.asarray(R, dtype))

    Hv, Hf, r = _obs_terms(poses, landmarks, z, lm_idx, mask)
    # Weighted blocks (residual is z - h => J_pose = -Hv, J_lm = -Hf;
    # signs cancel in the normal matrices, flip in b).
    # HvR = Hv' Rinv: [T, K, 3, 2].
    HvR = jnp.einsum("tkab,ac->tkbc", Hv, Rinv, precision=_HIGHEST)

    # App diagonal blocks from observations: Hv' Rinv Hv summed over K.
    App_diag = jnp.einsum("tkab,tkbc->tac", HvR, Hv,
                          precision=_HIGHEST)          # [T, 3, 3]
    # b_p from observations: +Hv' Rinv r (J=-Hv, b = -J' W r).
    bp_obs = jnp.einsum("tkab,tkb->ta", HvR, r, precision=_HIGHEST)

    # Landmark blocks: All_j = sum Hf' Rinv Hf; scatter-add over lm_idx.
    HfR = jnp.einsum("tkab,ac->tkbc", Hf, Rinv, precision=_HIGHEST)
    All_terms = jnp.einsum("tkab,tkbc->tkac", HfR, Hf,
                           precision=_HIGHEST)         # [T, K, 2, 2]
    bl_terms = jnp.einsum("tkab,tkb->tka", HfR, r, precision=_HIGHEST)
    # Landmark-indexed accumulation as ONE-HOT CONTRACTIONS instead of
    # XLA scatter-adds into the dense blocks. Same sums up to f32
    # accumulation order.
    sel = (lm_idx[..., None] == jnp.arange(L)[None, None, :]
           ).astype(dtype)                             # [T, K, L]
    All = jnp.einsum("tkab,tkl->lab", All_terms, sel,
                     precision=_HIGHEST)               # [L, 2, 2]
    bl = jnp.einsum("tka,tkl->la", bl_terms, sel,
                    precision=_HIGHEST)                # [L, 2]

    # Cross blocks W[t, j] += Hv' Rinv Hf -> dense [3T, 2L].
    Wt = jnp.einsum("tkab,tkbc->tkac", HvR, Hf,
                    precision=_HIGHEST)                # [T, K, 3, 2]
    W = jnp.einsum("tkab,tkl->talb", Wt, sel,
                   precision=_HIGHEST)                 # [T, 3, L, 2]
    W = W.reshape(T * 3, L * 2)

    # Odometry factors.
    r_od, Ja, Jb = _odom_residual_jacobians(poses, odom)
    Info = jnp.asarray(odom_info, dtype)
    JaI = jnp.einsum("tab,bc->tac", jnp.swapaxes(Ja, -1, -2), Info,
                     precision=_HIGHEST)               # Ja' Info
    JbI = jnp.einsum("tab,bc->tac", jnp.swapaxes(Jb, -1, -2), Info,
                     precision=_HIGHEST)
    Aaa = jnp.einsum("tab,tbc->tac", JaI, Ja, precision=_HIGHEST)
    Aab = jnp.einsum("tab,tbc->tac", JaI, Jb, precision=_HIGHEST)
    Abb = jnp.einsum("tab,tbc->tac", JbI, Jb, precision=_HIGHEST)
    ba_ = -jnp.einsum("tab,tb->ta", JaI, r_od, precision=_HIGHEST)
    bb_ = -jnp.einsum("tab,tb->ta", JbI, r_od, precision=_HIGHEST)

    App = jnp.zeros((T, 3, T, 3), dtype)
    tt = jnp.arange(T)
    App = App.at[tt, :, tt, :].add(App_diag)
    t1 = jnp.arange(T - 1)
    App = App.at[t1, :, t1, :].add(Aaa)
    App = App.at[t1, :, t1 + 1, :].add(Aab)
    App = App.at[t1 + 1, :, t1, :].add(jnp.swapaxes(Aab, -1, -2))
    App = App.at[t1 + 1, :, t1 + 1, :].add(Abb)
    # Gauge prior on pose 0: information AND residual (see PRIOR_INFO).
    App = App.at[0, :, 0, :].add(PRIOR_INFO * jnp.eye(3, dtype=dtype))
    App = App.reshape(T * 3, T * 3)

    bp = bp_obs.at[:-1].add(ba_).at[1:].add(bb_)
    bp = bp.at[0].add(-PRIOR_INFO * _prior_residual(poses, anchor))
    return App, W, All, bp.reshape(-1), bl


@jax.jit
def _ba_cost(poses, landmarks, odom, odom_info, z, lm_idx, mask, R,
             anchor):
    """Total weighted squared residual (obs + odom + gauge prior) —
    the LM acceptance criterion."""
    Rinv = jnp.linalg.inv(jnp.asarray(R, poses.dtype))
    lm = landmarks[lm_idx]
    dx = lm[..., 0] - poses[:, None, 0]
    dy = lm[..., 1] - poses[:, None, 1]
    rng = jnp.sqrt(dx * dx + dy * dy)
    brg = jnp.arctan2(dy, dx) - poses[:, None, 2]
    r0 = z[..., 0] - rng
    r1 = wrap_angle(z[..., 1] - brg)
    r = jnp.stack([r0, r1], -1) * mask.astype(poses.dtype)[..., None]
    c_obs = jnp.einsum("tka,ab,tkb->", r, Rinv, r, precision=_HIGHEST)
    r_od, _, _ = _odom_residual_jacobians(poses, odom)
    c_od = jnp.einsum("ta,ab,tb->", r_od,
                      jnp.asarray(odom_info, poses.dtype), r_od,
                      precision=_HIGHEST)
    rp = _prior_residual(poses, anchor)
    return c_obs + c_od + PRIOR_INFO * jnp.dot(rp, rp, precision=_HIGHEST)


@jax.jit
def _gn_step(poses, landmarks, odom, odom_info, z, lm_idx, mask, R,
             anchor, damping):
    """One damped Gauss-Newton trial step with Schur elimination."""
    T = poses.shape[0]
    L = landmarks.shape[0]
    dtype = poses.dtype
    App, W, All, bp, bl = _gn_normal_blocks(
        poses, landmarks, odom, odom_info, z, lm_idx, mask, R, anchor,
        L)

    lam = jnp.asarray(damping, dtype)
    All = All + lam * jnp.eye(2, dtype=dtype)
    # Unobserved landmarks have singular blocks: damping regularizes,
    # and bl there is zero so dl stays zero.
    det = (All[:, 0, 0] * All[:, 1, 1] - All[:, 0, 1] * All[:, 1, 0])
    det = jnp.maximum(det, 1e-20)
    Allinv = jnp.stack([
        jnp.stack([All[:, 1, 1], -All[:, 0, 1]], -1),
        jnp.stack([-All[:, 1, 0], All[:, 0, 0]], -1)], -2) \
        / det[:, None, None]

    # S = App - W Allinv W'; rhs = bp - W Allinv bl (one contraction).
    WA = jnp.einsum("plc,lcd->pld", W.reshape(3 * T, L, 2), Allinv,
                    precision=_HIGHEST).reshape(3 * T, 2 * L)
    S = App + lam * jnp.eye(3 * T, dtype=dtype) \
        - jnp.matmul(WA, W.T, precision=_HIGHEST)
    rhs = bp - jnp.matmul(WA, bl.reshape(-1), precision=_HIGHEST)

    dp = jax.scipy.linalg.solve(S, rhs, assume_a="pos")
    dl_rhs = bl.reshape(-1) - jnp.matmul(W.T, dp, precision=_HIGHEST)
    dl = jnp.einsum("lcd,ld->lc", Allinv, dl_rhs.reshape(L, 2),
                    precision=_HIGHEST)

    new_poses = poses + dp.reshape(T, 3)
    new_poses = new_poses.at[:, 2].set(wrap_angle(new_poses[:, 2]))
    new_landmarks = landmarks + dl
    return new_poses, new_landmarks


def solve_ba(prob: BAProblem, iters: int = 10, damping: float = 1e-3,
             tol: float = 1e-8, max_retries: int = 6,
             return_info: bool = False):
    """Levenberg-Marquardt: up to `iters` ACCEPTED steps, each trial
    step kept only if the total cost decreases (else the damping is
    raised x10 and the step recomputed from the same linearization
    point, up to `max_retries` times). One compiled step/cost program is
    reused across all trials (damping is a traced scalar). Returns
    (poses [T,3], landmarks [L,2]); with return_info=True also a dict
    with cost trace and trial counts (n_steps = total linear solves —
    the unit for ms/iter timing)."""
    poses = jnp.asarray(prob.poses0, jnp.float32)
    landmarks = jnp.asarray(prob.landmarks0, jnp.float32)
    anchor = poses[0]
    static = (prob.odom, prob.odom_info, prob.z, prob.lm_idx, prob.mask,
              prob.R, anchor)
    lam = float(damping)
    cost = float(_ba_cost(poses, landmarks, *static))
    costs = [cost]
    n_steps = 0
    for _ in range(iters):
        accepted = False
        for _retry in range(max_retries + 1):
            trial_p, trial_l = _gn_step(poses, landmarks, *static,
                                        jnp.float32(lam))
            n_steps += 1
            trial_cost = float(_ba_cost(trial_p, trial_l, *static))
            if np.isfinite(trial_cost) and trial_cost <= cost:
                accepted = True
                break
            lam = min(lam * 10.0, 1e8)
        if not accepted:
            break
        poses, landmarks = trial_p, trial_l
        gain = cost - trial_cost
        cost = trial_cost
        costs.append(cost)
        lam = max(lam / 3.0, 1e-9)
        if gain <= tol * max(cost, 1.0):
            break
    if return_info:
        return poses, landmarks, {"costs": costs, "n_steps": n_steps,
                                  "final_damping": lam}
    return poses, landmarks


@functools.partial(jax.jit, static_argnames=("iters", "tol",
                                             "max_retries"))
def _lm_run(poses, landmarks, lam, odom, odom_info, z, lm_idx, mask,
            R, anchor, *, iters: int, tol: float, max_retries: int):
    """The whole LM loop (outer accepted-step loop + inner damping-
    retry loop) as one while_loop nest — module-level jit so repeated
    solves of same-shaped problems hit the trace cache."""
    static = (odom, odom_info, z, lm_idx, mask, R, anchor)
    cost = _ba_cost(poses, landmarks, *static)

    def outer_body(c):
        poses, landmarks, cost, lam, n_acc, n_steps, done = c

        # Inner damping-retry loop: keep trying (lam x10) until a
        # trial from the SAME linearization point decreases cost.
        def icond(ic):
            _, _, _, _, tries, acc = ic
            return (~acc) & (tries <= max_retries)

        def ibody(ic):
            lam_c, _, _, _, tries, _ = ic
            tp, tl = _gn_step(poses, landmarks, *static, lam_c)
            tc = _ba_cost(tp, tl, *static)
            acc = jnp.isfinite(tc) & (tc <= cost)
            lam_n = jnp.where(acc, lam_c,
                              jnp.minimum(lam_c * 10.0, 1e8))
            return (lam_n, tp, tl, tc, tries + 1, acc)

        lam_f, tp, tl, tc, tries, acc = jax.lax.while_loop(
            icond, ibody,
            (lam, poses, landmarks, jnp.float32(jnp.inf),
             jnp.int32(0), jnp.bool_(False)))

        gain = cost - tc
        new_poses = jnp.where(acc, tp, poses)
        new_lms = jnp.where(acc, tl, landmarks)
        new_cost = jnp.where(acc, tc, cost)
        new_lam = jnp.where(acc, jnp.maximum(lam_f / 3.0, 1e-9),
                            lam_f)
        converged = acc & (gain <= tol * jnp.maximum(new_cost, 1.0))
        return (new_poses, new_lms, new_cost, new_lam,
                n_acc + acc.astype(jnp.int32), n_steps + tries,
                (~acc) | converged)

    def outer_cond(c):
        *_, n_acc, _, done = c
        return (~done) & (n_acc < iters)

    return jax.lax.while_loop(
        outer_cond, outer_body,
        (poses, landmarks, cost, lam, jnp.int32(0), jnp.int32(0),
         jnp.bool_(False)))


def solve_ba_device(prob: BAProblem, iters: int = 10,
                    damping: float = 1e-3, tol: float = 1e-8,
                    max_retries: int = 6, return_info: bool = False):
    """solve_ba with the ENTIRE Levenberg-Marquardt loop on device: the
    outer accepted-step loop and the inner damping-retry loop are one
    jitted lax.while_loop nest, so a full solve costs ONE dispatch
    instead of two host syncs per trial. Identical trial/accept
    sequence to solve_ba (same
    float comparisons on the same values — equality-tested in
    tests/test_ba.py)."""
    poses0 = jnp.asarray(prob.poses0, jnp.float32)
    landmarks0 = jnp.asarray(prob.landmarks0, jnp.float32)
    anchor = poses0[0]
    poses, landmarks, cost, lam, n_acc, n_steps, _ = _lm_run(
        poses0, landmarks0, jnp.float32(damping), prob.odom,
        prob.odom_info, prob.z, prob.lm_idx, prob.mask, prob.R,
        anchor, iters=iters, tol=float(tol),
        max_retries=int(max_retries))
    if return_info:
        # One batched fetch instead of a device sync per value.
        vals = np.asarray(jnp.stack([
            cost, lam, n_acc.astype(jnp.float32),
            n_steps.astype(jnp.float32)]))
        return poses, landmarks, {
            "cost": float(vals[0]), "n_steps": int(vals[3]),
            "n_accepted": int(vals[2]), "final_damping": float(vals[1])}
    return poses, landmarks


def problem_from_run(result, config, slam_map=None) -> BAProblem:
    """Build a BA problem from a finished filter run: keyframes = observe
    supersteps, odometry = filter-trajectory relative transforms,
    landmarks initialized from back-projected observations."""
    act = result.active
    poses0 = jnp.asarray(result.est_pose[act], jnp.float32)
    z = np.asarray(result.obs_z[act])
    mask = np.asarray(result.obs_mask[act])
    ids = np.asarray(result.obs_ids[act])
    T = poses0.shape[0]

    L = int(ids[mask].max()) + 1 if mask.any() else 1
    # Back-project each obs from its keyframe pose; average per id.
    p = np.asarray(poses0)
    ang = p[:, 2][:, None] + z[..., 1]
    wx = p[:, 0][:, None] + z[..., 0] * np.cos(ang)
    wy = p[:, 1][:, None] + z[..., 0] * np.sin(ang)
    sums = np.zeros((L, 2))
    counts = np.zeros(L)
    np.add.at(sums, ids[mask], np.stack([wx[mask], wy[mask]], -1))
    np.add.at(counts, ids[mask], 1.0)
    landmarks0 = sums / np.maximum(counts, 1.0)[:, None]

    # Odometry: dead-reckoned relative transforms from the NOISY controls
    # (independent measurements, integrated on-device per superstep) —
    # odom[t+1] measures the motion from keyframe t to t+1.
    odom = np.asarray(result.odom[act])[1:]
    # Information: control noise accumulated over one observe period of
    # n ticks (random-walk diagonal approximation): longitudinal from
    # sigmaV, lateral/heading from sigmaG.
    n_ticks_per = round(config.DT_OBSERVE / config.DT_CONTROLS)
    dt = config.DT_CONTROLS
    var_x = n_ticks_per * (config.sigmaV * dt) ** 2
    var_y = n_ticks_per * (config.V * config.sigmaG * dt) ** 2
    var_t = n_ticks_per * (config.V * dt * config.sigmaG /
                           max(config.WHEELBASE, 1e-6)) ** 2
    info = np.diag([1.0 / max(var_x, 1e-10),
                    1.0 / max(var_y, 1e-10),
                    1.0 / max(var_t, 1e-10)])
    R = np.diag(config.Re).astype(np.float32)
    return BAProblem(
        poses0=poses0,
        landmarks0=jnp.asarray(landmarks0, jnp.float32),
        odom=jnp.asarray(odom, jnp.float32),
        odom_info=jnp.asarray(info, jnp.float32),
        z=jnp.asarray(z, jnp.float32),
        lm_idx=jnp.asarray(np.where(mask, ids, 0), jnp.int32),
        mask=jnp.asarray(mask),
        R=jnp.asarray(R),
    )
