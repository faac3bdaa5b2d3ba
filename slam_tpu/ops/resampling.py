"""Particle resampling: stratified, log-space, sort-free.

Replaces the reference pipeline resampleParticles -> stratifiedResample ->
stratifiedRandom / cumulativeSum (core.cpp:718-824) with:

- log-space weight normalization (the reference's linear weights underflow
  at large particle counts);
- stratified positions u_i = (i + U_i)/N — exactly the reference's
  "deterministic interval midpoints + uniform dither of width 1/N"
  (core.cpp:751-769) without its off-by-one assert failure;
- a CLOSED-FORM O(N) ancestor pick instead of the reference's O(N^2)
  cumulativeSum (core.cpp:813-824) + linear merge. Because the u grid is
  affine-plus-dither, "how many u fall below csum_i" is computable
  directly (the dither evaluated at floor(N*csum)) — no binary search,
  whose log2(N) dependent gathers the closed form replaces with one
  elementwise pass; exactly equivalent up to float-boundary ties of
  zero probability;
- the reference's semantics: weights are normalized on every call, but
  particles are copied (and weights reset to uniform) only when
  ``do_resample`` and Neff < n_min (core.cpp:739-748).

Everything is fixed-shape and jittable; the sharded multi-chip variant
lives in slam_tpu.parallel.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def normalize_log_weights(logw):
    """Normalize so that sum(exp(logw)) == 1."""
    return logw - jax.scipy.special.logsumexp(logw, axis=-1, keepdims=True)


def effective_particles(logw):
    """Neff = 1 / sum(w^2) on normalized weights (core.cpp:780-788)."""
    logw = normalize_log_weights(logw)
    return jnp.exp(-jax.scipy.special.logsumexp(2.0 * logw, axis=-1))


def _cummax_2d(x):
    """lax.cummax for long 1-D int vectors via a [rows, 1024] block
    decomposition: a within-row scan plus a combine of the row
    prefixes. Non-multiple lengths are padded (the identity element at
    the tail doesn't change any prefix)."""
    n = x.shape[0]
    C = 1024
    if n <= C:
        return jax.lax.cummax(x)
    n_pad = -(-n // C) * C
    if n_pad != n:
        x = jnp.concatenate(
            [x, jnp.full((n_pad - n,), jnp.iinfo(x.dtype).min, x.dtype)])
    rows = x.reshape(n_pad // C, C)
    within = jax.lax.cummax(rows, axis=1)
    prefix = jax.lax.cummax(within[:, -1])          # [n/C] small
    prefix = jnp.concatenate([jnp.full((1,), jnp.iinfo(x.dtype).min,
                                       x.dtype), prefix[:-1]])
    return jnp.maximum(within, prefix[:, None]).reshape(n_pad)[:n]


def _cumsum_2d(x):
    """Blocked inclusive cumsum for long 1-D f32 vectors (same block
    decomposition as _cummax_2d). Summation order differs from
    jnp.cumsum by the block regrouping; the stratified pick tolerates
    any consistent prefix-sum."""
    n = x.shape[0]
    C = 1024
    if n <= C:
        return jnp.cumsum(x)
    n_pad = -(-n // C) * C
    if n_pad != n:
        x = jnp.concatenate([x, jnp.zeros((n_pad - n,), x.dtype)])
    rows = x.reshape(n_pad // C, C)
    within = jnp.cumsum(rows, axis=1)
    prefix = jnp.cumsum(within[:, -1])              # [n/C] small
    prefix = jnp.concatenate([jnp.zeros((1,), x.dtype), prefix[:-1]])
    return (within + prefix[:, None]).reshape(n_pad)[:n]


def _uniform_at(key, pos):
    """Counter-based U_pos ~ Uniform[0,1) evaluated pointwise at integer
    positions ``pos`` (equal positions get equal draws — it is one random
    function of position). Replaces "materialize U[n] then gather at
    pos" with a vmapped fold_in: pure elementwise threefry that XLA
    fuses, with no dynamic gather."""
    sub = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(key, pos)
    bits = jax.vmap(lambda q: jax.random.bits(q, (), jnp.uint32))(sub)
    return (bits >> jnp.uint32(8)).astype(jnp.float32) * jnp.float32(
        2.0 ** -24)


def offspring_bounds(key, csum, n_out: int):
    """S_i = #{j : u_j < csum_i} for the stratified grid
    u_j = (j + U_j)/n_out, in closed form.

    u_j < c  ⟺  j + U_j < n_out*c  ⟺  j < k, or j == k and U_k < frac,
    with k = floor(n_out*c) — so S needs only the dither evaluated AT
    position k, which a counter-based PRNG provides without a gather.
    S is non-decreasing; ancestor i owns output slots [S_{i-1}, S_i).
    The last entry is forced to n_out so the float tail of the cumsum is
    absorbed by the final ancestor (the reference's last-block
    semantics, core.cpp:797-805)."""
    n_out_f = jnp.asarray(n_out, csum.dtype)
    t = csum * n_out_f
    k = jnp.clip(t.astype(jnp.int32), 0, n_out - 1)
    Uk = _uniform_at(key, k).astype(csum.dtype)
    S = k + (Uk < t - k.astype(csum.dtype)).astype(jnp.int32)
    # The blocked cumsum's row-prefix chain rounds independently of
    # the within-row chain, so csum can DIP by 1 ulp at row
    # boundaries (measured: 59 one-ulp dips over 1M entries, all at
    # positions == blocklen-1) — which would make S locally
    # decreasing and two ancestors claim the same output slot in
    # ancestors_from_bounds. A running max
    # restores the partition; the affected boundary draws shift by at
    # most one slot.
    S = _cummax_2d(jnp.minimum(S, n_out)).at[-1].set(n_out)
    return S


def ancestors_from_bounds(S, n_out: int):
    """Invert offspring bounds S (non-decreasing, S[-1] == n_out) into
    the ancestor vector idx [n_out]: idx_j = i for j in [S_{i-1}, S_i).

    Scatter-max of i at each positive-count ancestor's first output slot,
    then a cumulative max fills the runs. The scatter indices are sorted
    (S is), which XLA lowers to the fast in-order path."""
    n = S.shape[-1]
    counts = jnp.diff(S, prepend=jnp.zeros((1,), S.dtype))
    first_slot = S - counts                      # exclusive prefix
    pos = jnp.where(counts > 0, first_slot, n_out)  # park empties
    A = jnp.zeros((n_out,), jnp.int32).at[pos].max(
        jnp.arange(n, dtype=jnp.int32), mode="drop",
        indices_are_sorted=True)
    return _cummax_2d(A)


def stratified_indices(key, logw, n_out: int | None = None):
    """Stratified resampling indices.

    Draw u_i = (i + U_i)/n_out with U_i ~ Uniform[0,1), then map each u_i
    to the particle whose cumulative normalized weight first exceeds it.
    Returns int32 [n_out] ancestor indices (non-decreasing). Closed-form
    O(N) — no searchsorted (see module docstring)."""
    n = logw.shape[-1]
    n_out = n if n_out is None else n_out
    w = jnp.exp(normalize_log_weights(logw))
    csum = _cumsum_2d(w)
    S = offspring_bounds(key, csum, n_out)
    return jnp.clip(ancestors_from_bounds(S, n_out), 0, n - 1)


def resample_particles(key, logw, n_min, do_resample: bool = True):
    """Full reference semantics (resampleParticles, core.cpp:718-749).

    Returns (ancestor_idx [N] int32, new_logw [N], resampled bool).
    When Neff >= n_min (or resampling disabled): identity ancestors and
    normalized weights. Otherwise: stratified ancestors and uniform
    weights. Gathering particle state by ``ancestor_idx`` is the caller's
    job (struct-of-arrays gather).
    """
    n = logw.shape[-1]
    logw_n = normalize_log_weights(logw)
    neff = jnp.exp(-jax.scipy.special.logsumexp(2.0 * logw_n, axis=-1))
    need = jnp.asarray(do_resample) & (neff < n_min)

    identity = jnp.arange(n, dtype=jnp.int32)
    # The ancestor pick runs only when the gate fires (lax.cond, not
    # where: even the closed form moves ~3 [N] vectors through HBM).
    idx = jax.lax.cond(need,
                       lambda: stratified_indices(key, logw_n),
                       lambda: identity)
    uniform = jnp.full_like(logw_n, -jnp.log(jnp.float32(n)))
    new_logw = jnp.where(need, uniform, logw_n)
    return idx, new_logw, need
