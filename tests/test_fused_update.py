"""The Pallas/Triton fused observe update (slam_tpu.ops.fused_update) in
interpret mode against the plain fs1_update path on the same state,
including mixed matched/new/masked observations and a particle count
whose tail block needs masking."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slam_tpu.models import rbpf
from slam_tpu.models.fastslam1 import fs1_update
from slam_tpu.models.particles import init_particles
from slam_tpu.ops.fused_update import fused_observe_update
from slam_tpu.ops.resampling import normalize_log_weights

R = jnp.diag(jnp.asarray([0.01, 0.0003], jnp.float32))


def _state(P, L, seed):
    rng = np.random.default_rng(seed)
    state = init_particles(P, L, 12)
    lm = rng.normal(size=(2, L, P)).astype(np.float32) * 5
    lm_P = np.zeros((3, L, P), np.float32)
    lm_P[0] = lm_P[2] = 0.1
    table = -np.ones(12, np.int32)
    table[[3, 7, 9]] = [0, 1, 2]
    return state._replace(
        xv=jnp.asarray(rng.normal(size=(3, P)).astype(np.float32) * 0.1),
        logw=jnp.asarray(rng.normal(size=P).astype(np.float32)),
        lm=jnp.asarray(lm), lm_P=jnp.asarray(lm_P), n=jnp.int32(3),
        da_table=jnp.asarray(table))


def _kernel_update(state, z, ids, zmask, block):
    assoc, is_new = rbpf.associate_known(state, ids, zmask)
    matched = assoc >= 0
    slot_new, ok = rbpf.new_feature_slots(state.n, is_new, state.capacity)
    return fused_observe_update(
        state.logw, state.xv, state.lm, state.lm_P, z,
        jnp.where(matched, assoc, 0), matched, slot_new, ok, R,
        block=block, interpret=True)


@pytest.mark.parametrize("P,block", [(256, 128), (300, 128), (100, 256)])
def test_fused_update_matches_plain(P, block):
    """Obs 0: matched slot 0; obs 1: new id 5; obs 2: masked; obs 3:
    matched slot 2; obs 4: new id 11. P=300 leaves a partial tail
    block; P=100 runs one block larger than the particle count."""
    L = 8
    state = _state(P, L, seed=P)
    z = jnp.asarray(np.array([[5.0, 0.3], [4.0, -0.2], [3.0, 0.1],
                              [6.0, -0.4], [2.5, 0.6]], np.float32))
    ids = jnp.asarray(np.array([3, 5, 4, 9, 11], np.int32))
    zmask = jnp.asarray(np.array([True, True, False, True, True]))

    logw, lm, lm_P = _kernel_update(state, z, ids, zmask, block)
    with jax.default_matmul_precision("highest"):
        want = partial(fs1_update, do_resample=False)(
            state, jax.random.PRNGKey(0), z, ids, zmask, R,
            jnp.float32(0.0))
    # fs1_update's resample step returns normalized log-weights.
    np.testing.assert_allclose(np.asarray(normalize_log_weights(logw)),
                               np.asarray(want.logw), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(lm), np.asarray(want.lm),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(lm_P), np.asarray(want.lm_P),
                               rtol=1e-3, atol=1e-5)


def _choice_args(P=64):
    state = _state(P, 8, seed=1)
    z = jnp.asarray(np.array([[5.0, 0.3], [4.0, -0.2]], np.float32))
    slot = jnp.asarray(np.array([0, 0], np.int32))
    matched = jnp.asarray(np.array([True, False]))
    slot_new = jnp.asarray(np.array([3, 3], np.int32))
    ok = jnp.asarray(np.array([False, True]))
    return state, z, slot, matched, slot_new, ok, R


def _lowered_text(platform):
    from jax import export
    exp = export.export(
        jax.jit(rbpf.observe_update), platforms=[platform],
        disabled_checks=[export.DisabledSafetyCheck.custom_call(
            "__gpu$xla.gpu.triton")])(*_choice_args())
    return exp.mlir_module()


def test_observe_update_runs_plain_path_on_cpu():
    args = _choice_args()
    got = jax.jit(rbpf.observe_update)(*args)
    want = jax.jit(rbpf._plain_observe_update)(*args)
    for f in ("logw", "lm", "lm_P"):
        np.testing.assert_allclose(np.asarray(getattr(got, f)),
                                   np.asarray(getattr(want, f)), rtol=1e-6)
    assert "triton" not in _lowered_text("cpu")


def test_observe_update_lowers_the_kernel_for_a_gpu():
    assert "__gpu$xla.gpu.triton" in _lowered_text("cuda")


def test_observe_update_refuses_other_platforms():
    with pytest.raises(NotImplementedError):
        _lowered_text("rocm")
