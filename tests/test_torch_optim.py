"""repro_torch optimizer and schedules vs the reference's.

The same numpy gradients and state go to both packages' AdamW ``update``
for three steps. The math is elementwise fp32 in the same order, so the
tolerance is the fp32 rounding of two libraries' ``pow``, ``sqrt`` and
summation order (the gradient norm, hence the clip scale, can differ in its
last bit): 1e-6 relative, with 1e-8 absolute for moments near 0, where
``b1 * m + (1 - b1) * g`` cancels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro_torch.models.params import tree_flatten
from repro_torch.optim import adamw, schedule

SHAPES = {"w": (4, 8, 16), "b": {"c": (300,)}, "n": (16,)}


def _tree(rng, scale=1.0):
    return {"w": rng.normal(size=SHAPES["w"]).astype(np.float32) * scale,
            "b": {"c": rng.normal(size=(300,)).astype(np.float32) * scale},
            "n": rng.normal(size=(16,)).astype(np.float32) * scale}


def _t(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _assert_tree(got, want, rtol=1e-6, atol=1e-8):
    for (path, g), w in zip(tree_flatten(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w),
                                   rtol=rtol, atol=atol, err_msg=str(path))


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])   # unclipped, clipped
def test_adamw_update_matches_reference(grad_scale):
    rng = np.random.default_rng(0)
    master = _tree(rng)
    cfg, jcfg = adamw.AdamWConfig(), jadamw.AdamWConfig()
    jmaster = jax.tree.map(jnp.asarray, master)
    jstate = jadamw.init(jmaster)
    state, pmaster = adamw.init(_t(master)), _t(jax.tree.map(np.copy,
                                                            master))
    for step in range(3):
        grads = _tree(rng, grad_scale)
        lr = 1e-3 * (step + 1)
        jmaster, jparams, jstate, jg = jadamw.update(
            jax.tree.map(jnp.asarray, grads), jstate, jmaster,
            jnp.float32(lr), jcfg)
        pmaster, params, state, g = adamw.update(
            _t(grads), state, pmaster, torch.tensor(lr, dtype=torch.float32),
            cfg)
        assert float(g) == pytest.approx(float(jg), rel=1e-6)
        assert int(state.count) == int(jstate.count) == step + 1
        _assert_tree(pmaster, jmaster)
        _assert_tree(state.mu, jstate.mu)
        _assert_tree(state.nu, jstate.nu)
        for (_, c), w in zip(tree_flatten(params), jax.tree.leaves(jparams)):
            assert c.dtype == torch.bfloat16
            np.testing.assert_allclose(c.float().numpy(),
                                       np.asarray(w, np.float32),
                                       rtol=2 ** -8)


def test_global_norm_matches_reference():
    tree = _tree(np.random.default_rng(2), 3.0)
    assert float(adamw.global_norm(_t(tree))) == pytest.approx(
        float(jadamw.global_norm(jax.tree.map(jnp.asarray, tree))),
        rel=1e-6)


@pytest.mark.parametrize("warmup,total", [(10, 100), (1, 10), (0, 5)])
def test_schedules_match_reference(warmup, total):
    for step in range(0, total + 3):
        got = schedule.warmup_cosine(step, peak_lr=3e-4, warmup_steps=warmup,
                                     total_steps=total)
        want = jschedule.warmup_cosine(step, peak_lr=3e-4,
                                       warmup_steps=warmup,
                                       total_steps=total)
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(float(want), rel=1e-6, abs=1e-12)
