"""whisper-small (encoder-decoder) and qwen2-vl-72b (M-RoPE) in the port
against the reference, on the CPU.

At ``reduced(dtype="float32")`` on the reference's weights (carried with
``params_from_jax``), at the reference tests' bounds (prefill 2e-4, decode
5e-4; ``tests/test_decode_parity.py``): whisper's ``encdec_forward``, its
prefill (the encoder output and the cross caches) and every decode step,
the encoder on both attention paths (the reference's through its Pallas
kernel in interpret mode, at an encoder length its blocks divide), and
qwen2-vl's forward over ``embeds`` with M-RoPE positions whose three rows
differ (equal rows are plain RoPE and would not test the section split),
then its decode steps; each model's decode against the port's own forward;
``loss_fn`` on ``synthetic_batch`` equal to the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import ParallelConfig as JaxParallelConfig
from repro.config.base import ShapeConfig as JaxShapeConfig
from repro.config.base import get_config as jax_get_config
from repro.data.synthetic import synthetic_batch as jax_synthetic_batch
from repro.launch.mesh import make_host_mesh
from repro.models import layers as jlayers
from repro.models.decode import _whisper_prefill as jax_whisper_prefill
from repro.models.layers import unembed as jax_unembed
from repro.models.model import Model as JaxModel
from repro.models.transformer import encdec_forward as jax_encdec_forward
from repro.models.transformer import forward_hidden as jax_forward_hidden
from repro.models.transformer import loss_fn as jax_loss_fn
from repro_torch.config.base import ParallelConfig, ShapeConfig, get_config
from repro_torch.data.synthetic import synthetic_batch
from repro_torch.models import layers
from repro_torch.models.decode import WHISPER_CROSS_LEN
from repro_torch.models.layers import embed_tokens, unembed
from repro_torch.models.model import Model
from repro_torch.models.params import params_from_jax, tree_flatten
from repro_torch.models.transformer import (encdec_forward, forward_hidden,
                                            loss_fn)

TOL_PREFILL, TOL_DECODE = 2e-4, 5e-4
KERNEL = {"eager": "xla", "kernel": "pallas"}   # port setting -> reference's
B, S_ENC, T = 2, 32, 8                 # whisper: frames, decoded tokens
PROMPT, EXTRA = 32, 4                  # qwen2-vl


def _close(got: torch.Tensor, want, tol: float, what: str) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def _assert_tree_close(got: dict, want: dict, tol: float, what: str):
    assert got.keys() == want.keys(), what
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_close(got[k], want[k], tol, f"{what}/{k}")
        else:
            assert tuple(got[k].shape) == tuple(want[k].shape), f"{what}/{k}"
            _close(got[k], want[k], tol, f"{what}/{k}")


def _pair(arch: str, kernel: str = "eager"):
    """(reference model, its params, port model, the same params)."""
    jcfg = jax_get_config(arch).reduced(dtype="float32")
    jm = JaxModel.create(jcfg, make_host_mesh(), JaxParallelConfig(
        remat="none", attention_kernel=KERNEL[kernel]))
    jparams = jm.init(jax.random.key(0))
    m = Model.create(get_config(arch).reduced(dtype="float32"),
                     ParallelConfig(remat="none", attention_kernel=kernel),
                     device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    m.set_params(params)
    assert m.num_params == jm.num_params
    return jm, jparams, m, params


def _whisper_inputs(vocab: int, d: int, s_enc: int = S_ENC):
    rng = np.random.default_rng(0)
    frames = rng.normal(size=(B, s_enc, d)).astype(np.float32)
    toks = rng.integers(0, vocab, (B, T)).astype(np.int32)
    return frames, toks


# --------------------------------------------------------------------------
# whisper
# --------------------------------------------------------------------------


def test_whisper_specs_match_reference():
    jm, _, m, params = _pair("whisper-small")
    assert set(params) == {"embed", "final_norm", "encoder", "enc_norm",
                           "decoder"}
    assert set(params["decoder"]) >= {"xattn", "ln_x"}
    assert set(params["encoder"]["mlp"]) == {"w_up", "b_up", "w_down",
                                             "b_down"}
    cache = m.init_cache(2, 8)
    jcache = jm.init_cache(2, 8)
    _assert_tree_close(cache, jax.tree.map(np.asarray, jcache), 0.0,
                       "init_cache")
    assert tuple(cache["decoder"]["cross"]["k"].shape)[2] == WHISPER_CROSS_LEN


@pytest.mark.parametrize("kernel", ["eager", "kernel"])
def test_encdec_forward_matches_reference(kernel):
    jm, jparams, m, params = _pair("whisper-small", kernel)
    cfg = m.cfg
    frames, toks = _whisper_inputs(cfg.vocab_size, cfg.d_model)
    jx, jcaches, _ = jax_encdec_forward(
        jparams, jm.cfg, jm.mctx, {"frames": jnp.asarray(frames),
                                   "tokens": jnp.asarray(toks)},
        collect=True, q_chunk=8)
    with torch.inference_mode():
        x, caches, aux = encdec_forward(
            params, cfg, m.mctx, {"frames": torch.from_numpy(frames),
                                  "tokens": torch.from_numpy(toks).long()},
            collect=True, q_chunk=8)
    assert float(aux) == 0.0
    _close(unembed(params["embed"], x, cfg.tie_embeddings),
           jax_unembed(jparams["embed"], jx, cfg.tie_embeddings),
           TOL_PREFILL, "encdec_forward logits")
    _assert_tree_close(caches, jax.tree.map(np.asarray, jcaches),
                       TOL_PREFILL, "encdec_forward caches")


@pytest.mark.parametrize("kernel", ["eager", "kernel"])
def test_whisper_prefill_matches_reference(kernel):
    """The encoder output and the per-layer cross K/V; on the kernel path
    the reference's encoder runs its Pallas kernel (interpret mode)."""
    jm, jparams, m, params = _pair("whisper-small", kernel)
    frames, _ = _whisper_inputs(m.cfg.vocab_size, m.cfg.d_model)
    jenc, jcache = jm.prefill(jparams, {"frames": jnp.asarray(frames)},
                              max_len=T)
    with torch.inference_mode():
        enc, cache = m.prefill(params, {"frames": torch.from_numpy(frames)},
                               max_len=T)
    assert tuple(enc.shape) == (B, S_ENC, m.cfg.d_model)
    _close(enc, jenc, TOL_PREFILL, "encoder output")
    _assert_tree_close(cache, jax.tree.map(np.asarray, jcache), TOL_PREFILL,
                       "prefill caches")
    assert not bool(cache["decoder"]["self"]["k"].any())


def test_whisper_prefill_self_cache_defaults_to_1024():
    jm, jparams, m, params = _pair("whisper-small")
    frames, _ = _whisper_inputs(m.cfg.vocab_size, m.cfg.d_model, 16)
    _, jcache = jax_whisper_prefill(jparams, jm.cfg, jm.mctx,
                                    {"frames": jnp.asarray(frames)})
    with torch.inference_mode():
        _, cache = m.prefill(params, {"frames": torch.from_numpy(frames)})
    assert tuple(cache["decoder"]["self"]["v"].shape) == \
        tuple(jcache["decoder"]["self"]["v"].shape)
    assert cache["decoder"]["self"]["v"].shape[2] == 1024


def test_whisper_decode_matches_reference():
    jm, jparams, m, params = _pair("whisper-small")
    frames, toks = _whisper_inputs(m.cfg.vocab_size, m.cfg.d_model)
    _, jcache = jm.prefill(jparams, {"frames": jnp.asarray(frames)},
                           max_len=T)
    with torch.inference_mode():
        _, cache = m.prefill(params, {"frames": torch.from_numpy(frames)},
                             max_len=T)
    for s in range(T):
        tok = toks[:, s:s + 1]
        jlogits, jcache = jm.decode(jparams, jcache, jnp.asarray(tok),
                                    jnp.int32(s))
        with torch.inference_mode():
            logits, cache = m.decode(params, cache,
                                     torch.from_numpy(tok).long(), s)
        _close(logits, jlogits, TOL_DECODE, f"whisper decode step {s}")
    _assert_tree_close(cache, jax.tree.map(np.asarray, jcache), TOL_DECODE,
                       "decode caches")


@pytest.mark.parametrize("kernel", ["eager", "kernel"])
def test_whisper_decode_matches_forward(kernel):
    """The port alone, on its own seeded weights: the counterpart of the
    reference's ``test_whisper_decode_matches_forward``."""
    cfg = get_config("whisper-small").reduced(dtype="float32")
    m = Model.create(cfg, ParallelConfig(remat="none",
                                         attention_kernel=kernel),
                     device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    frames, toks = (torch.from_numpy(a) for a in
                    _whisper_inputs(cfg.vocab_size, cfg.d_model, 16))
    toks = toks.long()
    with torch.inference_mode():
        x, _, _ = encdec_forward(params, cfg, m.mctx,
                                 {"frames": frames, "tokens": toks},
                                 q_chunk=8)
        full = unembed(params["embed"], x, cfg.tie_embeddings)
        _, cache = m.prefill(params, {"frames": frames}, max_len=T)
        for s in range(T):
            logits, cache = m.decode(params, cache, toks[:, s:s + 1], s)
            _close(logits[:, 0], full[:, s].numpy(), TOL_DECODE,
                   f"whisper step {s}")


# --------------------------------------------------------------------------
# qwen2-vl: M-RoPE
# --------------------------------------------------------------------------


def _grid_positions(batch: int, n: int, start: int = 4, side: int = 4
                    ) -> np.ndarray:
    """(3, batch, n) M-RoPE positions: text, then a side x side image grid
    (t fixed, h the row, w the column, offset by the text before it), then
    text again from the grid's largest position + 1."""
    pos = np.zeros((3, n), np.int64)
    pos[:, :start] = np.arange(start)
    g = np.arange(side * side)
    end = start + side * side
    pos[0, start:end] = start
    pos[1, start:end] = start + g // side
    pos[2, start:end] = start + g % side
    nxt = start + side
    pos[:, end:] = nxt + np.arange(n - end)
    return np.broadcast_to(pos[:, None], (3, batch, n)).copy()


@pytest.mark.parametrize("head_dim,sections", [(16, [2, 3, 3]),
                                               (128, [16, 24, 24]),
                                               (80, [10, 15, 15])])
def test_mrope_sections_rescale_as_reference(head_dim, sections):
    assert layers.mrope_sections(head_dim // 2) == sections


@pytest.mark.parametrize("head_dim", [16, 128])
def test_apply_mrope_matches_reference(head_dim):
    """Distinct (t, h, w) rows, so each section turns by its own axis."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 40, 3, head_dim)).astype(np.float32)
    pos = _grid_positions(2, 40)
    pos[2] += rng.integers(0, 50, pos.shape[1:])
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                            mrope=True)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6,
                              mrope=True)
    _close(got, want, 1e-5, "M-RoPE")


def test_mrope_with_equal_rows_is_rope_and_grid_rows_are_not():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2, 40, 3, 16)).astype(np.float32))
    ar = torch.arange(40)[None].expand(2, 40)
    rope = layers.apply_rope(x, ar, 1e4)
    equal = layers.apply_rope(x, ar[None].expand(3, 2, 40), 1e4, mrope=True)
    torch.testing.assert_close(equal, rope, rtol=0, atol=0)
    grid = layers.apply_rope(x, torch.from_numpy(_grid_positions(2, 40)),
                             1e4, mrope=True)
    assert (grid - rope).abs().max() > 0.1


def _vlm_inputs(cfg):
    rng = np.random.default_rng(0)
    n = PROMPT + EXTRA
    toks = rng.integers(0, cfg.vocab_size, (2, n)).astype(np.int32)
    pos = _grid_positions(2, n)
    # the generated tokens sit at their decode positions in every axis,
    # as decode_step places them
    pos[:, :, PROMPT:] = np.arange(PROMPT, n)
    return toks, pos


def test_vlm_forward_prefill_decode_match_reference():
    """embeds equal to the token embeddings (the reference test's stub
    frontend), M-RoPE grid positions: forward logits, prefill logits and
    caches, then each decode step and the caches."""
    jm, jparams, m, params = _pair("qwen2-vl-72b")
    cfg = m.cfg
    assert cfg.mrope and cfg.qkv_bias
    assert set(params["decoder"]["attn"]) >= {"b_q", "b_k", "b_v"}
    toks, pos = _vlm_inputs(cfg)
    jemb = jlayers.embed_tokens(jparams["embed"], jnp.asarray(toks),
                                jnp.float32)
    emb = embed_tokens(params["embed"], torch.from_numpy(toks).long(),
                       torch.float32)
    _close(emb, jemb, 0.0, "embeds")
    jx, _, _ = jax_forward_hidden(jparams, jm.cfg, jm.mctx,
                                  {"embeds": jemb,
                                   "positions": jnp.asarray(pos)}, q_chunk=8)
    with torch.inference_mode():
        x, _, _ = forward_hidden(params, cfg, m.mctx,
                                 {"embeds": emb,
                                  "positions": torch.from_numpy(pos)},
                                 q_chunk=8)
    _close(unembed(params["embed"], x, cfg.tie_embeddings),
           jax_unembed(jparams["embed"], jx, cfg.tie_embeddings),
           TOL_PREFILL, "forward logits")

    n = PROMPT + EXTRA
    jlogits, jcache = jm.prefill(
        jparams, {"embeds": jemb[:, :PROMPT],
                  "positions": jnp.asarray(pos[:, :, :PROMPT])}, max_len=n)
    with torch.inference_mode():
        logits, cache = m.prefill(
            params, {"embeds": emb[:, :PROMPT],
                     "positions": torch.from_numpy(pos[:, :, :PROMPT])},
            max_len=n)
    _close(logits, jlogits, TOL_PREFILL, "prefill logits")
    _assert_tree_close(cache, jax.tree.map(np.asarray, jcache), TOL_PREFILL,
                       "prefill caches")
    for s in range(EXTRA):
        tok = toks[:, PROMPT + s:PROMPT + s + 1]
        jlogits, jcache = jm.decode(jparams, jcache, jnp.asarray(tok),
                                    jnp.int32(PROMPT + s))
        with torch.inference_mode():
            logits, cache = m.decode(params, cache,
                                     torch.from_numpy(tok).long(),
                                     PROMPT + s)
        _close(logits, jlogits, TOL_DECODE, f"vlm decode step {s}")
    _assert_tree_close(cache, jax.tree.map(np.asarray, jcache), TOL_DECODE,
                       "decode caches")


@pytest.mark.parametrize("kernel", ["eager", "kernel"])
def test_vlm_decode_matches_forward(kernel):
    """The port alone: prefill over grid positions, decode steps against
    the forward over the same positions."""
    cfg = get_config("qwen2-vl-72b").reduced(dtype="float32")
    m = Model.create(cfg, ParallelConfig(remat="none",
                                         attention_kernel=kernel),
                     device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    toks, pos = _vlm_inputs(cfg)
    toks, pos = torch.from_numpy(toks).long(), torch.from_numpy(pos)
    emb = embed_tokens(params["embed"], toks, torch.float32)
    with torch.inference_mode():
        x, _, _ = forward_hidden(params, cfg, m.mctx,
                                 {"embeds": emb, "positions": pos},
                                 q_chunk=8)
        full = unembed(params["embed"], x, cfg.tie_embeddings)
        logits, cache = m.prefill(
            params, {"embeds": emb[:, :PROMPT],
                     "positions": pos[:, :, :PROMPT]},
            max_len=PROMPT + EXTRA)
        _close(logits[:, 0], full[:, PROMPT - 1].numpy(), TOL_PREFILL,
               "vlm prefill")
        for s in range(EXTRA):
            logits, cache = m.decode(
                params, cache, toks[:, PROMPT + s:PROMPT + s + 1], PROMPT + s)
            _close(logits[:, 0], full[:, PROMPT + s].numpy(), TOL_DECODE,
                   f"vlm step {s}")


# --------------------------------------------------------------------------
# Losses and layers
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["whisper-small", "qwen2-vl-72b"])
def test_loss_matches_reference_on_synthetic_batch(arch):
    jm, jparams, m, params = _pair(arch)
    shape, jshape = (ShapeConfig("t", 24, 2, "train"),
                     JaxShapeConfig("t", 24, 2, "train"))
    batch = synthetic_batch(m.cfg, shape, step=3, seed=1)
    jbatch = jax_synthetic_batch(jm.cfg, jshape, step=3, seed=1)
    jloss, jparts = jax_loss_fn(jparams, jm.cfg, jm.mctx, jbatch)
    with torch.inference_mode():
        loss, parts = loss_fn(params, m.cfg, m.mctx, batch)
    _close(loss, jloss, TOL_PREFILL, f"{arch} loss")
    _close(parts["ce"], jparts["ce"], TOL_PREFILL, f"{arch} ce")
    assert float(parts["aux"]) == float(jparts["aux"]) == 0.0


def test_loss_gradients_flow_through_encoder_and_decoder():
    """Training whisper: remat on, every leaf of both stacks gets a
    finite gradient, non-zero where the forward reads it."""
    cfg = get_config("whisper-small").reduced(dtype="float32")
    m = Model.create(cfg, ParallelConfig(remat="full"), device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    for _, leaf in tree_flatten(params):
        leaf.requires_grad_(True)
    batch = synthetic_batch(cfg, ShapeConfig("t", 16, 2, "train"), step=0)
    loss, _ = loss_fn(params, cfg, m.mctx, batch)
    loss.backward()
    for part in ("encoder", "decoder"):
        for name, leaf in (("w_q", params[part]["attn"]["w_q"]),
                           ("w_up", params[part]["mlp"]["w_up"])):
            g = leaf.grad
            assert g is not None and bool(torch.isfinite(g).all())
            assert bool(g.abs().sum() > 0), (part, name)
    assert bool(params["decoder"]["xattn"]["w_k"].grad.abs().sum() > 0)


def test_sinusoidal_pos_emb_matches_reference():
    for d, n in ((64, 40), (768, 1500), (2, 3)):
        pos = np.arange(n)
        _close(layers.sinusoidal_pos_emb(torch.from_numpy(pos), d),
               jlayers.sinusoidal_pos_emb(jnp.asarray(pos), d), 1e-5,
               f"sinusoidal d={d}")


def test_ungated_mlp_matches_reference():
    rng = np.random.default_rng(2)
    d, ff = 16, 48
    p = {"w_up": rng.normal(size=(d, ff)), "b_up": rng.normal(size=ff),
         "w_down": rng.normal(size=(ff, d)) / 7, "b_down": rng.normal(size=d)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(2, 5, d)).astype(np.float32)
    got = layers.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x), gated=False)
    want = jlayers.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), gated=False)
    _close(got, want, 1e-4, "ungated mlp")
    specs = layers.mlp_specs(d, ff, gated=False)
    jspecs = jlayers.mlp_specs(d, ff, gated=False)
    assert {k: (s.shape, s.init) for k, s in specs.items()} == \
        {k: (s.shape, s.init) for k, s in jspecs.items()}
