"""repro_torch Model vs the reference Model on reduced yi-9b.

Weights are carried from the reference with ``params_from_jax`` (the two
packages' seeded inits can never agree: the reference folds ``hash(path)``
into its keys). Prefill logits, every decode step's logits and the KV caches
are compared for both attention paths, at the tolerances of
``tests/test_decode_parity.py`` in fp32 (rtol = atol). In bf16 the bound
is 2e-2 of the tensor's largest magnitude: the two frameworks round to
bf16 at different points (XLA may keep excess precision inside a fused
elementwise op, such as silu(a) * b, where torch rounds each op), so the
logits of a 2-layer model differ by a few bf16 ulps of their largest value.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from config_view import same_config

from repro.config.base import ParallelConfig as JaxParallelConfig
from repro.config.base import get_config as jax_get_config
from repro.launch.mesh import make_host_mesh
from repro.models.model import Model as JaxModel
from repro_torch.config.base import ParallelConfig, get_config
from repro_torch.models.model import Model
from repro_torch.models.params import params_from_jax

PROMPT, EXTRA = 16, 3
# (prefill logits, decode logits, caches) tolerances per activation dtype
TOL = {"float32": (2e-4, 5e-4, 2e-4), "bfloat16": (2e-2, 2e-2, 2e-2)}
KERNEL = {"eager": "xla", "kernel": "pallas"}   # port setting -> reference's


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tree_close(got: dict, want: dict, tol: float, what: str):
    assert got.keys() == want.keys(), what
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_close(got[k], want[k], tol, f"{what}/{k}")
            continue
        w = np.asarray(want[k], np.float32)
        if got[k].dtype == torch.bfloat16:
            rtol, atol = 0.0, tol * float(np.abs(w).max())
        else:
            rtol, atol = tol, tol
        np.testing.assert_allclose(got[k].float().numpy(), w, rtol=rtol,
                                   atol=atol, err_msg=f"{what}/{k}")


def test_config_copy_matches_reference():
    for reduced in (False, True):
        want = jax_get_config("yi-9b")
        got = get_config("yi-9b")
        if reduced:
            want, got = want.reduced(), got.reduced()
        assert same_config(got, want) == dataclasses.asdict(want)


def test_unknown_attention_kernel_is_refused():
    with pytest.raises(ValueError, match="attention_kernel"):
        ParallelConfig(attention_kernel="pallas")


@pytest.mark.parametrize("cast", [None, jnp.bfloat16])
def test_params_from_jax_round_trip(cast):
    cfg = jax_get_config("yi-9b").reduced()
    jm = JaxModel.create(cfg, make_host_mesh(), JaxParallelConfig())
    params = jm.init(jax.random.key(1))
    if cast is not None:
        params = jax.tree.map(lambda p: p.astype(cast), params)
    ported = params_from_jax(_np_tree(params), "cpu")
    spec_shapes = jax.tree.map(lambda s: tuple(s.shape), jm.specs,
                               is_leaf=lambda x: hasattr(x, "axes"))

    def check(got, want, shapes):
        assert got.keys() == want.keys()
        for k in want:
            if isinstance(want[k], dict):
                check(got[k], want[k], shapes[k])
                continue
            assert tuple(got[k].shape) == shapes[k]
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
            # bit for bit, bf16 included
            np.testing.assert_array_equal(
                got[k].float().numpy(), np.asarray(want[k], np.float32))
    check(ported, params, spec_shapes)
    m = Model.create(get_config("yi-9b").reduced(), device="cpu")
    assert m.num_params == jm.num_params
    m.set_params(ported)
    assert sum(p.numel() for p in m.parameters()) == m.num_params


@pytest.mark.parametrize("kernel,dtype,window", [
    ("eager", "float32", 0), ("kernel", "float32", 0),
    ("eager", "bfloat16", 0), ("kernel", "bfloat16", 0),
    # sliding window: the KV slice in prefill and ring caches in decode
    ("eager", "float32", 8), ("kernel", "float32", 8),
])
def test_prefill_and_decode_match_reference(kernel, dtype, window):
    swa = dict(attn_type="swa", window=window) if window else {}
    jcfg = jax_get_config("yi-9b").reduced(dtype=dtype, **swa)
    jm = JaxModel.create(jcfg, make_host_mesh(), JaxParallelConfig(
        remat="none", attention_kernel=KERNEL[kernel]))
    jparams = jm.init(jax.random.key(0))
    if dtype == "bfloat16":
        jparams = jax.tree.map(lambda p: p.astype(jnp.bfloat16), jparams)
    m = Model.create(get_config("yi-9b").reduced(dtype=dtype, **swa),
                     ParallelConfig(attention_kernel=kernel), device="cpu")
    params = params_from_jax(_np_tree(jparams), "cpu")
    tol_prefill, tol_decode, tol_cache = TOL[dtype]

    rng = np.random.default_rng(0)
    T = PROMPT + EXTRA
    toks = rng.integers(0, jcfg.vocab_size, (2, T)).astype(np.int32)
    jlogits, jcache = jm.prefill(jparams, {"tokens": jnp.asarray(
        toks[:, :PROMPT])}, max_len=T)
    with torch.inference_mode():
        logits, cache = m.prefill(params, {"tokens": torch.from_numpy(
            toks[:, :PROMPT]).long()}, max_len=T)
    _assert_tree_close({"logits": logits}, {"logits": jlogits}, tol_prefill,
                       "prefill")
    _assert_tree_close(cache, jcache, tol_cache, "prefill cache")
    for s in range(EXTRA):
        tok = toks[:, PROMPT + s:PROMPT + s + 1]
        jlogits, jcache = jm.decode(jparams, jcache, jnp.asarray(tok),
                                    jnp.int32(PROMPT + s))
        with torch.inference_mode():
            logits, cache = m.decode(params, cache,
                                     torch.from_numpy(tok).long(),
                                     PROMPT + s)
        _assert_tree_close({"logits": logits}, {"logits": jlogits},
                           tol_decode, f"decode step {s}")
    _assert_tree_close(cache, jcache, tol_cache, "decode cache")
