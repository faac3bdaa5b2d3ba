"""Range-bearing sensor model with semicircular field of view.

Replaces the reference observation pipeline (getObservations ->
findVisibleLandmarks -> computeRangeBearing -> addObservationNoise,
core.cpp:185-273, 438-449) with one fixed-capacity masked computation:
visibility is evaluated for ALL landmarks at once, then the
visible subset is compacted (stably, in landmark-index order, matching
the reference scan order) into ``[max_obs]`` slots with a validity mask.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from slam_tpu.geometry import wrap_angle


class Observation(NamedTuple):
    """Fixed-capacity observation batch.

    ``z``: [max_obs, 2] (range, bearing) — noisy if noise was requested.
    ``ids``: [max_obs] int32 original landmark identifiers (for known
    data association); garbage where ``mask`` is False.
    ``mask``: [max_obs] bool validity.
    ``count``: scalar int32 number of valid observations.
    """
    z: jnp.ndarray
    ids: jnp.ndarray
    mask: jnp.ndarray
    count: jnp.ndarray


def visible_mask(landmarks, pose, max_range):
    """Semicircular FOV test (findVisibleLandmarks, core.cpp:250-273):
    |dx| < R, |dy| < R, forward half-plane (dx cos(th) + dy sin(th) > 0),
    and dx^2 + dy^2 < R^2. ``landmarks``: [N, 2]; returns [N] bool."""
    d = landmarks - pose[:2]
    dx, dy = d[..., 0], d[..., 1]
    c, s = jnp.cos(pose[2]), jnp.sin(pose[2])
    return ((jnp.abs(dx) < max_range)
            & (jnp.abs(dy) < max_range)
            & (dx * c + dy * s > 0.0)
            & (dx * dx + dy * dy < max_range * max_range))


def range_bearing(landmarks, pose):
    """True (range, bearing) to each landmark [N, 2]
    (computeRangeBearing, core.cpp:217-239). Bearing is NOT wrapped here,
    matching the reference (noise is added to the raw difference)."""
    d = landmarks - pose[:2]
    rng = jnp.sqrt(jnp.sum(d * d, axis=-1))
    brg = jnp.arctan2(d[..., 1], d[..., 0]) - pose[2]
    return jnp.stack([rng, brg], axis=-1)


def observe(landmarks, pose, max_range, max_obs: int, key=None,
            sigma_r: float = 0.0, sigma_b: float = 0.0) -> Observation:
    """Full observation step: visibility, compaction, optional noise.

    ``key=None`` (or zero sigmas) yields noiseless observations — the
    SWITCH_SENSOR_NOISE=0 path (ekfslamwrapper.cpp:73-75).
    """
    n = landmarks.shape[0]
    vis = visible_mask(landmarks, pose, max_range)
    count = jnp.sum(vis, dtype=jnp.int32)

    # Stable compaction: visible landmarks first, preserving index order —
    # the reference builds its visible list by scanning indices in order
    # (core.cpp:265-271), which fixes the order new features are appended.
    order = jnp.argsort(~vis, stable=True)
    slots = order[:max_obs]
    slot_mask = (jnp.arange(max_obs) < count) & vis[slots]

    z = range_bearing(landmarks[slots], pose)
    if key is not None:
        noise = jax.random.normal(key, (max_obs, 2), dtype=z.dtype)
        z = z + noise * jnp.array([sigma_r, sigma_b], dtype=z.dtype)
    z = jnp.where(slot_mask[:, None], z, 0.0)
    # Wrap bearing after noise, as the estimators' innovation wrapping
    # makes the representative range irrelevant; keep it tidy regardless.
    z = z.at[:, 1].set(jnp.where(slot_mask, wrap_angle(z[:, 1]), 0.0))

    return Observation(
        z=z,
        ids=slots.astype(jnp.int32),
        mask=slot_mask,
        count=jnp.minimum(count, max_obs),
    )
