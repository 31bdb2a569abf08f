"""The port's recurrent blocks and MLA: twins of ``tests/test_ssm_xlstm.py``
(chunked-parallel == step-by-step, decay stability), and SSD, mLSTM, sLSTM
and MLA (prefill and absorbed decode) against the reference's, each with
its decode step, on the reference's weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import kvcache as jkv
from repro.models import ssm as jssm
from repro.models import xlstm as jxl
from repro.models.params import ParamSpec as JaxParamSpec
from repro.models.params import init_params as jax_init_params
from repro_torch.config.base import get_config
from repro_torch.models import attention, kvcache, ssm, xlstm
from repro_torch.models.params import init_params, map_specs, params_from_jax

TOL_PAR, TOL_STEP = 2e-4, 5e-4


def _cfg(arch):
    return get_config(arch).reduced(dtype="float32")


def _x(seed, B, S, d, scale=0.5):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, d)) * scale).astype(np.float32)


def _zeros(specs, m_neg=False):
    cache = map_specs(lambda s: torch.zeros(s.shape), specs)
    if m_neg:
        cache["m"] = torch.full_like(cache["m"], -1e30)
    return cache


def _steps(decode, p, x, cache, cfg):
    ys = []
    for t in range(x.shape[1]):
        y, cache = decode(p, x[:, t:t + 1], cache, cfg)
        ys.append(y)
    return torch.cat(ys, 1), cache


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


# --------------------------------------------------------------------------
# Twins of the reference's tests, on the port's own weights
# --------------------------------------------------------------------------


def test_ssd_chunked_equals_stepwise():
    cfg = _cfg("zamba2-7b")
    p = init_params(ssm.ssm_specs(cfg), torch.Generator().manual_seed(0),
                    "cpu")
    x = torch.from_numpy(_x(0, 2, 24, cfg.d_model))
    y_par, cache_par = ssm.ssm_forward(p, x, cfg, chunk=8)
    y_seq, cache = _steps(ssm.ssm_decode, p, x,
                          _zeros(kvcache.ssm_cache_specs(cfg, 2)), cfg)
    _close(y_seq, y_par, TOL_PAR)
    _close(cache["state"], cache_par["state"], TOL_PAR)


def test_mlstm_chunked_equals_stepwise():
    cfg = _cfg("xlstm-350m")
    p = init_params(xlstm.mlstm_specs(cfg), torch.Generator().manual_seed(1),
                    "cpu")
    x = torch.from_numpy(_x(1, 2, 16, cfg.d_model))
    y_par, _ = xlstm.mlstm_forward(p, x, cfg, chunk=4)
    y_seq, _ = _steps(xlstm.mlstm_decode, p, x,
                      _zeros(kvcache.mlstm_cache_specs(cfg, 2), True), cfg)
    _close(y_seq, y_par, TOL_STEP)


def test_slstm_forward_equals_stepwise():
    cfg = _cfg("xlstm-350m")
    p = init_params(xlstm.slstm_specs(cfg), torch.Generator().manual_seed(2),
                    "cpu")
    x = torch.from_numpy(_x(2, 2, 12, cfg.d_model))
    y_par, _ = xlstm.slstm_forward(p, x, cfg)
    y_seq, _ = _steps(xlstm.slstm_decode, p, x,
                      _zeros(kvcache.slstm_cache_specs(cfg, 2), True), cfg)
    _close(y_seq, y_par, TOL_STEP)


def test_ssd_decay_stability():
    """No NaN/inf for long sequences with extreme gate values."""
    cfg = _cfg("zamba2-7b")
    p = init_params(ssm.ssm_specs(cfg), torch.Generator().manual_seed(3),
                    "cpu")
    p["A_log"] = torch.full_like(p["A_log"], 3.0)     # fast decay
    x = torch.ones((1, 64, cfg.d_model)) * 2
    y, _ = ssm.ssm_forward(p, x, cfg, chunk=16)
    assert torch.isfinite(y).all()


# --------------------------------------------------------------------------
# Against the reference, on its weights
# --------------------------------------------------------------------------


def _ref_params(specs, seed):
    jp = jax_init_params(specs, jax.random.key(seed))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _ref_zeros(specs, m_neg=False):
    cache = jax.tree.map(lambda s: jnp.zeros(s.shape, jnp.dtype(s.dtype)),
                         specs, is_leaf=lambda n: isinstance(n, JaxParamSpec))
    if m_neg:
        cache["m"] = jnp.full_like(cache["m"], -1e30)
    return cache


def _assert_tree(got: dict, want: dict, tol: float, what: str):
    assert got.keys() == want.keys(), what
    for k in want:
        _close(got[k], want[k], tol, f"{what}/{k}")


# (block, its specs / forward / decode / cache specs in each package, the
# arch, a long-enough sequence for several chunks and the chunk)
BLOCKS = {
    "ssm": ("zamba2-7b", jssm, ssm, "ssm", 24, dict(chunk=8)),
    "mlstm": ("xlstm-350m", jxl, xlstm, "mlstm", 16, dict(chunk=4)),
    "slstm": ("xlstm-350m", jxl, xlstm, "slstm", 12, {}),
}


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_block_forward_and_decode_match_reference(block):
    arch, jmod, mod, name, S, kw = BLOCKS[block]
    jcfg = jax_get_config(arch).reduced(dtype="float32")
    cfg = _cfg(arch)
    jp, p = _ref_params(getattr(jmod, f"{name}_specs")(jcfg), 4)
    x = _x(4, 2, S, cfg.d_model)
    jy, jcache = getattr(jmod, f"{name}_forward")(jp, jnp.asarray(x), jcfg,
                                                  **kw)
    y, cache = getattr(mod, f"{name}_forward")(p, torch.from_numpy(x), cfg,
                                               **kw)
    _close(y, jy, TOL_PAR, f"{block} forward")
    _assert_tree(cache, jcache, TOL_PAR, f"{block} forward cache")

    # decode steps continue from the forward's cache, in both packages
    xs = _x(5, 2, 3, cfg.d_model)
    jdec, dec = getattr(jmod, f"{name}_decode"), getattr(mod,
                                                         f"{name}_decode")
    for t in range(xs.shape[1]):
        jy, jcache = jdec(jp, jnp.asarray(xs[:, t:t + 1]), jcache, jcfg)
        y, cache = dec(p, torch.from_numpy(xs[:, t:t + 1]), cache, cfg)
        _close(y, jy, TOL_STEP, f"{block} decode {t}")
        _assert_tree(cache, jcache, TOL_STEP, f"{block} decode cache {t}")


def test_mla_prefill_and_absorbed_decode_match_reference():
    jcfg = jax_get_config("deepseek-v3-671b").reduced(dtype="float32")
    cfg = _cfg("deepseek-v3-671b")
    jp, p = _ref_params(jattn.mla_specs(jcfg), 6)
    B, S, T = 2, 12, 16
    x = _x(6, B, T, cfg.d_model)
    pos = np.broadcast_to(np.arange(S)[None], (B, S))
    jy, jlat = jattn.mla_forward(jp, jnp.asarray(x[:, :S]), jnp.asarray(pos),
                                 jcfg, q_chunk=4)
    y, lat = attention.mla_forward(p, torch.from_numpy(x[:, :S]),
                                   torch.from_numpy(pos.copy()), cfg,
                                   q_chunk=4)
    _close(y, jy, TOL_PAR, "mla_forward")
    _assert_tree(lat, jlat, TOL_PAR, "mla latents")

    # absorbed decode over a cache of T slots that holds the prompt
    jcache = {k: jnp.pad(v, ((0, 0), (0, T - S), (0, 0)))
              for k, v in jlat.items()}
    cache = {k: torch.nn.functional.pad(v, (0, 0, 0, T - S))
             for k, v in lat.items()}
    for s in range(S, T):
        jy, jcache = jattn.mla_decode(jp, jnp.asarray(x[:, s:s + 1]), s,
                                      jcache, jcfg)
        y, cache = attention.mla_decode(p, torch.from_numpy(x[:, s:s + 1]),
                                        torch.tensor([s]), cache, cfg)
        _close(y, jy, TOL_PAR, f"mla_decode {s}")
        _assert_tree(cache, jcache, TOL_PAR, f"mla cache {s}")


def test_cache_specs_match_reference():
    for arch, names in (("zamba2-7b", ("ssm",)),
                        ("xlstm-350m", ("mlstm", "slstm"))):
        jcfg, cfg = jax_get_config(arch), get_config(arch)
        for name in names:
            want = getattr(jkv, f"{name}_cache_specs")(jcfg, 4)
            got = getattr(kvcache, f"{name}_cache_specs")(cfg, 4)
            assert {k: (s.shape, s.dtype) for k, s in got.items()} == \
                {k: (s.shape, s.dtype) for k, s in want.items()}
    jcfg, cfg = (jax_get_config("deepseek-v3-671b"),
                 get_config("deepseek-v3-671b"))
    want = jkv.mla_cache_specs(jcfg, 2, 64, "act_seq")
    got = kvcache.mla_cache_specs(cfg, 2, 64, "act_seq")
    assert {k: s.shape for k, s in got.items()} == \
        {k: s.shape for k, s in want.items()}
