"""Fused FastSLAM observe update as one Pallas kernel through Triton.

One pass over the particle axis does what fastslam1.fs1_update does
between association and resampling: the log-likelihood weight of every
matched observation, the matched 2x2 feature EKF updates, and the
new-feature initialization. The grid runs over blocks of ``block``
particles (a power of two; the tail block is masked). Each block loops
over the K observations, reads the observed slot's 5 plane rows, does
the 2x2 algebra of slam_tpu.ops.planes in registers, and writes the rows
back in place (the landmark planes are aliased to the outputs). Slots
are unique per observation set (known association), so the sequential
per-observation order equals the batched plain path.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from slam_tpu.geometry import wrap_angle
from slam_tpu.ops import planes as pk


def _kernel(xv_ref, logw_ref, z_ref, slot_ref, matched_ref, slot_new_ref,
            ok_ref, r_ref, lm_ref, lmP_ref, logw_out, lm_out, lmP_out, *,
            n_particles: int, block: int, n_obs: int):
    cols = pl.program_id(0) * block + jnp.arange(block)
    live = cols < n_particles

    def ld(ref):
        return plgpu.load(ref, mask=live, other=0.0)

    x, y, t = (ld(xv_ref.at[c, cols]) for c in range(3))
    r00, r01, r11 = r_ref[0], r_ref[1], r_ref[2]

    def body(k, logw):
        zr, zb = z_ref[k, 0], z_ref[k, 1]
        s = slot_ref[k]
        lmx, lmy = (ld(lm_ref.at[c, s, cols]) for c in range(2))
        p00, p01, p11 = (ld(lmP_ref.at[c, s, cols]) for c in range(3))
        J = pk.jacobians_planes(x, y, t, lmx, lmy, p00, p01, p11,
                                r00, r01, r11)
        v0 = zr - J.zr
        v1 = wrap_angle(zb - J.zb)
        matched = matched_ref[k] != 0
        logw = logw + jnp.where(
            matched, pk.log_gauss2_planes(v0, v1, J.s00, J.s01, J.s11),
            0.0)
        upd = pk.feature_update_planes(lmx, lmy, p00, p01, p11, v0, v1, J)
        for c, v in enumerate((upd.nx, upd.ny)):
            plgpu.store(lm_out.at[c, s, cols], v, mask=live & matched)
        for c, v in enumerate((upd.np00, upd.np01, upd.np11)):
            plgpu.store(lmP_out.at[c, s, cols], v, mask=live & matched)

        sn = slot_new_ref[k]
        new = ok_ref[k] != 0
        init = pk.feature_init_planes(x, y, t, zr, zb, r00, r01, r11)
        for c, v in enumerate(init[:2]):
            plgpu.store(lm_out.at[c, sn, cols], v, mask=live & new)
        for c, v in enumerate(init[2:]):
            plgpu.store(lmP_out.at[c, sn, cols], v, mask=live & new)
        return logw

    logw = jax.lax.fori_loop(0, n_obs, body, ld(logw_ref.at[cols]))
    plgpu.store(logw_out.at[cols], logw, mask=live)


def fused_observe_update(logw, xv, lm, lm_P, z, slot, matched, slot_new,
                         ok, R, *, block: int = 256,
                         interpret: bool = False):
    """Returns (logw, lm, lm_P) after the weight, matched-feature and
    new-feature updates. ``slot``/``matched``: [K] matched slots;
    ``slot_new``/``ok``: [K] new-feature slots and their validity."""
    P = logw.shape[-1]
    K = z.shape[0]
    block = min(block, pl.next_power_of_2(P))
    kernel = functools.partial(_kernel, n_particles=P, block=block,
                               n_obs=K)
    R = jnp.asarray(R, lm.dtype)
    rr = jnp.stack([R[0, 0], R[0, 1], R[1, 1]])
    return pl.pallas_call(
        kernel,
        out_shape=(jax.ShapeDtypeStruct(logw.shape, logw.dtype),
                   jax.ShapeDtypeStruct(lm.shape, lm.dtype),
                   jax.ShapeDtypeStruct(lm_P.shape, lm_P.dtype)),
        grid=(pl.cdiv(P, block),),
        input_output_aliases={1: 0, 8: 1, 9: 2},
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="fs_fused_observe_update",
    )(xv, logw, z.astype(lm.dtype), slot.astype(jnp.int32),
      matched.astype(jnp.int32),
      jnp.where(ok, slot_new, 0).astype(jnp.int32), ok.astype(jnp.int32),
      rr, lm, lm_P)
