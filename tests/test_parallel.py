"""Sharded-filter tests on the virtual 8-device CPU mesh: collective
resampling semantics and end-to-end sharded runs vs single-chip ATE."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as P

from slam_tpu.models.particles import init_particles
from slam_tpu.parallel import (
    ShardedFastSlam1,
    ShardedFastSlam2,
    make_mesh,
)
from slam_tpu.parallel.mesh import particle_state_specs
from slam_tpu.parallel.resampling import (
    global_neff,
    ring_resample,
    sharded_estimate_position,
)
from slam_tpu.runtime import Runner, compute_metrics

NDEV = 8


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() >= NDEV, "conftest should force 8 CPU devs"
    return make_mesh(NDEV)


def _toy_state(n, capacity=4, seed=0):
    rng = np.random.default_rng(seed)
    state = init_particles(n, capacity, 4)
    return state._replace(
        xv=jnp.asarray(rng.normal(size=(3, n)).astype(np.float32)),
        lm=jnp.asarray(rng.normal(size=(2, capacity, n))
                       .astype(np.float32)),
    )


def test_global_neff_matches_local(mesh):
    from slam_tpu.ops.resampling import effective_particles
    logw = jnp.asarray(np.random.default_rng(1)
                       .normal(size=64).astype(np.float32))
    f = jax.jit(shard_map(lambda w: global_neff(w, "p"), mesh=mesh,
                          in_specs=(P("p"),), out_specs=P(),
                          check_vma=False))
    np.testing.assert_allclose(float(f(logw)),
                               float(effective_particles(logw)),
                               rtol=1e-5)


def test_ring_resample_identity_when_uniform(mesh):
    """Uniform weights: Neff = N >= n_min -> no resampling, state
    unchanged."""
    n = 64
    state = _toy_state(n)
    specs = particle_state_specs()

    def run(state):
        new_state, new_logw, did = ring_resample(
            state, state.logw, jax.random.PRNGKey(0),
            jnp.float32(48.0), True, "p", static_ring_size=NDEV)
        return new_state, new_logw, did

    f = jax.jit(shard_map(run, mesh=mesh, in_specs=(specs,),
                          out_specs=(specs, P("p"), P()),
                          check_vma=False))
    new_state, new_logw, did = f(state)
    assert not bool(did)
    np.testing.assert_allclose(np.asarray(new_state.xv),
                               np.asarray(state.xv))
    np.testing.assert_allclose(np.asarray(new_logw),
                               np.full(n, -np.log(n)), rtol=1e-5)


def test_ring_resample_proportional_ancestry(mesh):
    """Degenerate weights concentrated on a few particles: the resampled
    set must consist (almost) exclusively of copies of those particles,
    in proportion to their weights — across shard boundaries."""
    n = 64
    state = _toy_state(n)
    # Two heavy particles on shard 0 and shard 5.
    logw = np.full(n, -50.0, np.float32)
    heavy_a, heavy_b = 3, 45
    logw[heavy_a] = np.log(0.75)
    logw[heavy_b] = np.log(0.25)
    state = state._replace(logw=jnp.asarray(logw))
    specs = particle_state_specs()

    def run(state):
        new_state, new_logw, did = ring_resample(
            state, state.logw, jax.random.PRNGKey(7),
            jnp.float32(48.0), True, "p", static_ring_size=NDEV)
        return new_state, new_logw, did

    f = jax.jit(shard_map(run, mesh=mesh, in_specs=(specs,),
                          out_specs=(specs, P("p"), P()),
                          check_vma=False))
    new_state, new_logw, did = f(state)
    assert bool(did)
    xv = np.asarray(new_state.xv)           # [3, P]
    ref = np.asarray(state.xv)
    from_a = np.all(np.isclose(xv, ref[:, heavy_a][:, None]), axis=0)
    from_b = np.all(np.isclose(xv, ref[:, heavy_b][:, None]), axis=0)
    assert (from_a | from_b).all()
    # Stratified resampling: counts within 1 of N*w.
    assert abs(from_a.sum() - 48) <= 1
    assert abs(from_b.sum() - 16) <= 1
    np.testing.assert_allclose(np.asarray(new_logw),
                               np.full(n, -np.log(n)), rtol=1e-5)


def test_sharded_estimate_position_matches(mesh):
    from slam_tpu.models.particles import estimate_position
    state = _toy_state(64, seed=3)
    logw = jnp.asarray(np.random.default_rng(4)
                       .normal(size=64).astype(np.float32))
    state = state._replace(logw=logw)
    specs = particle_state_specs()
    f = jax.jit(shard_map(
        lambda s: sharded_estimate_position(s.logw, s.xv, "p"),
        mesh=mesh, in_specs=(specs,), out_specs=P(), check_vma=False))
    np.testing.assert_allclose(np.asarray(f(state)),
                               np.asarray(estimate_position(state)),
                               atol=1e-5)


@pytest.mark.parametrize("cls,bound", [(ShardedFastSlam1, 1.5),
                                       (ShardedFastSlam2, 1.0)])
def test_sharded_fastslam_e2e(mesh, cls, bound, workload):
    """Full sharded runs stay within the single-chip ATE bounds."""
    cfg, slam_map = workload("loop1_like")
    est = cls(cfg, slam_map.n_landmarks, mesh, n_particles=64)
    runner = Runner(cfg, slam_map, "FASTSLAM1", estimator=est)
    result = runner.run(seed=7, n_ticks=1600)
    m = compute_metrics(result)
    assert np.isfinite(m.ate_rmse)
    assert m.ate_rmse < bound, f"{cls.__name__}: ATE {m.ate_rmse:.3f}"
    assert int(result.final_state.n) > 0


def test_ring_resample_one_device_local_arm():
    """1-device mesh (static_ring_size=1): run_local's searchsorted arm
    must equal the single-device stratified resampler driven by the
    same dither stream (this branch carries the single-card config #5
    run)."""
    n = 64
    state = _toy_state(n, seed=9)
    logw = np.asarray(np.random.default_rng(5)
                      .normal(size=n).astype(np.float32)) * 3
    state = state._replace(logw=jnp.asarray(logw))
    mesh1 = make_mesh(1)
    specs = particle_state_specs()
    key = jax.random.PRNGKey(11)

    def run(state):
        return ring_resample(state, state.logw, key,
                             jnp.float32(n), True, "p",
                             static_ring_size=1)

    f = jax.jit(shard_map(run, mesh=mesh1, in_specs=(specs,),
                          out_specs=(specs, P("p"), P()),
                          check_vma=False))
    new_state, new_logw, did = f(state)
    assert bool(did)

    # Reference: the same u grid (shard 0's dither) + searchsorted.
    from slam_tpu.ops.resampling import normalize_log_weights
    wn = np.exp(np.asarray(normalize_log_weights(state.logw)))
    dither = np.asarray(jax.random.uniform(
        jax.random.fold_in(key, 0), (n,), dtype=jnp.float32))
    u = (np.arange(n) + dither) / n
    idx = np.clip(np.searchsorted(np.cumsum(wn), u, side="left"),
                  0, n - 1)
    np.testing.assert_allclose(np.asarray(new_state.xv),
                               np.asarray(state.xv)[:, idx], atol=0)
    np.testing.assert_allclose(np.asarray(new_logw),
                               np.full(n, -np.log(n)), rtol=1e-5)
