"""Collective stratified resampling over a sharded particle axis.

The reference resamples on one core over an in-memory vector
(resampleParticles, core.cpp:718-824). At 1M+ sharded particles the naive
port — gather all particle state to one place — is impossible (hundreds of
GB). This module keeps the exact semantics (global stratified positions
u_i = (i + U_i)/N over the normalized weight cumsum, Neff gate) while
exchanging only:

- O(1) scalars via psum/all_gather (normalization, Neff, shard offsets);
- the particle blocks themselves via a ppermute ring: each shard's block
  visits every shard once, and each shard copies out the ancestors whose
  cumulative-weight interval falls in the visiting block. Peak memory is
  2 blocks regardless of mesh size; total bytes moved equal one all-gather
  but streamed, overlapping the selection compute.

All functions run *inside* shard_map with the particle axis mapped.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
from jax import lax
import numpy as np


def _normalized_weights(logw, axis: str):
    """Globally-normalized linear weights + log-normalizer, via collective
    max/sum (stable logsumexp across shards)."""
    local_max = jnp.max(logw)
    gmax = lax.pmax(local_max, axis)
    w = jnp.exp(logw - gmax)
    total = lax.psum(jnp.sum(w), axis)
    return w / total, gmax + jnp.log(total)


def global_neff(logw, axis: str):
    """Neff = 1 / sum(w_i^2) over the global particle set
    (core.cpp:780-788)."""
    wn, _ = _normalized_weights(logw, axis)
    return 1.0 / lax.psum(jnp.sum(wn * wn), axis)


def ring_resample(state: Any, logw, key, n_min, do_resample, axis: str,
                  particle_fields: tuple[str, ...] = (
                      "xv", "Pv", "lm", "lm_P"),
                  static_ring_size: int | None = None):
    """Neff-gated global stratified resampling of a sharded NamedTuple.

    Args:
      state: NamedTuple whose ``particle_fields`` have a leading local
        particle axis (the shard block).
      logw: [Pl] local log-weights (the shard's slice of the global [N]).
      key: PRNG key, identical on every shard (fold in nothing — the
        stratified dither must be a consistent global draw).
      n_min: global Neff threshold.
      do_resample: bool/traced flag (SWITCH_RESAMPLE).
      axis: shard_map axis name.
    Returns (new_state, new_logw [Pl], resampled flag).
    """
    S = static_ring_size or lax.psum(1, axis)
    me = lax.axis_index(axis)
    Pl = logw.shape[0]
    N = S * Pl
    dtype = logw.dtype

    wn, _ = _normalized_weights(logw, axis)
    neff = 1.0 / lax.psum(jnp.sum(wn * wn), axis)
    need = jnp.asarray(do_resample) & (neff < n_min)

    # Shard-local cumsum and this shard's global base offset.
    local_total = jnp.sum(wn)
    shard_totals = lax.all_gather(local_total, axis)            # [S]
    base = jnp.cumsum(shard_totals) - shard_totals              # exclusive
    my_base = base[me]
    csum_rel = jnp.cumsum(wn)                                   # [Pl]

    # Stratified positions for MY output slots (global slot ids).
    gslot = me * Pl + jnp.arange(Pl, dtype=jnp.int32)
    # Per-slot independent dither must differ across shards but derive
    # from the same global stream: fold the shard id into the key.
    dither = jax.random.uniform(jax.random.fold_in(key, me), (Pl,),
                                dtype=dtype)
    u = (gslot.astype(dtype) + dither) / jnp.asarray(N, dtype)  # [Pl]

    def run_local(state):
        # Single p-shard: every ancestor is local, so the ring (which
        # packs the whole state into one [C, Pl] matrix, plus a zeros
        # output and per-step copies — about 3x the state in
        # temporaries) degenerates to a plain stratified gather.
        idx = jnp.clip(jnp.searchsorted(csum_rel, u, side="left"),
                       0, Pl - 1)
        updates = {}
        for f in particle_fields:
            arr = getattr(state, f)
            rows = arr.reshape(-1, arr.shape[-1])
            updates[f] = rows[:, idx].reshape(arr.shape)
        return state._replace(**updates)

    def run_ring(state):
        # Pack the particle fields into one [C, Pl] matrix: the ring
        # moves a single buffer, and the per-step ancestor pick is one
        # gather along the particle axis.
        shapes = {f: getattr(state, f).shape for f in particle_fields}
        flat = jnp.concatenate(
            [getattr(state, f).reshape(-1, Pl) for f in particle_fields],
            axis=0)                                     # [C, Pl]
        out = jnp.zeros_like(flat)

        visit = flat
        visit_csum = csum_rel
        visit_base = my_base
        visit_total = local_total
        visit_id = me

        perm = [(i, (i + 1) % S) for i in range(S)]

        for _ in range(S):
            # Does u fall into the visiting block's global weight
            # interval?
            hi = visit_base + visit_total
            # The globally-last block absorbs the float tail (u may
            # exceed the final cumsum by rounding).
            hi = jnp.where(visit_id == S - 1, jnp.inf, hi)
            valid = (u > visit_base) & (u <= hi)
            idx = jnp.searchsorted(visit_csum, u - visit_base,
                                   side="left")
            idx = jnp.clip(idx, 0, Pl - 1)
            out = jnp.where(valid[None, :], visit[:, idx], out)

            # Rotate blocks around the ring.
            visit = lax.ppermute(visit, axis, perm)
            visit_csum = lax.ppermute(visit_csum, axis, perm)
            visit_base = lax.ppermute(visit_base, axis, perm)
            visit_total = lax.ppermute(visit_total, axis, perm)
            visit_id = lax.ppermute(visit_id, axis, perm)

        flat_out = out                                  # [C, Pl]
        updates = {}
        row = 0
        for f in particle_fields:
            shape = shapes[f]
            n_rows = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
            updates[f] = flat_out[row:row + n_rows].reshape(shape)
            row += n_rows
        return state._replace(**updates)

    # The ring exchange moves the whole particle state once around the
    # mesh — run it only when the Neff gate fires (`need` is derived
    # from psums, hence uniform across shards, so the cond branch is
    # taken collectively).
    if isinstance(S, int) and S == 1:
        new_state = lax.cond(need, run_local, lambda s: s, state)
    else:
        new_state = lax.cond(need, run_ring, lambda s: s, state)

    uniform = jnp.full_like(logw, -jnp.log(jnp.asarray(N, dtype)))
    new_logw = jnp.where(need, uniform, jnp.log(jnp.maximum(wn, 1e-38)))
    return new_state, new_logw, need


def sharded_estimate_position(logw, xv, axis: str):
    """Weighted-mean x/y + max-weight heading over the global particle
    set (the sharded form of estimate_position). ``xv``: [3, Pl]."""
    wn, _ = _normalized_weights(logw, axis)
    xy = lax.psum(jnp.sum(wn[None, :] * xv[:2], axis=-1), axis)

    local_best = jnp.argmax(logw)
    local_max = logw[local_best]
    gmax = lax.pmax(local_max, axis)
    me = lax.axis_index(axis)
    S = lax.psum(1, axis)
    owner = lax.pmin(jnp.where(local_max == gmax, me, S), axis)
    theta = lax.psum(jnp.where(me == owner, xv[2, local_best], 0.0), axis)
    return jnp.concatenate([xy, theta[None]])
