"""Decode (serve) path: cache specs, prefill, single-token decode step.

Decode caches mirror the ``collect=True`` structure of the forward pass
(``{segment: stacked cache tree}``, see ``kvcache.seg_cache_specs``), so
prefill output feeds decode directly. A decode step writes the new K/V
(or latents) into the cache in place and copies each recurrent block's new
state over its old one, so the cache it is given is the cache it returns.

The position of the decoded token is a Python int or a one-element int64
tensor on the device. GQA attention (``attn_decode``) reads it as the
tensor, made once a step from an int, so a step of attention blocks alone
reads no position on the host and can be captured as a CUDA graph and
replayed at every position (``launch/serve.py``); MLA and the mesh path
take the int.

Whisper (encoder-decoder): ``prefill`` of ``{"frames"}`` runs the encoder
and returns its output (not logits) with a zeroed self cache and each
decoder layer's cross K/V of the encoder's output; ``decode_step`` then
runs the decoder one token at a time, reading the cross cache only.

With a mesh the cache leaves are DTensors placed as the rules say (the
K/V and latents sequence-sharded, ``act_cache_seq``; recurrent states by
head, ``act_heads``), every arch decodes through the blocks of
``models/tp.py`` and ``models/tp_recurrent.py``, and logits come back
vocab-sharded (``act_vocab``) where ``model`` divides the vocabulary.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.config.base import ModelConfig
from repro_torch.models import kvcache, tp, tp_recurrent
from repro_torch.models.attention import (_proj_heads, attn_decode,
                                          attn_decode_cross, mla_decode)
from repro_torch.models.context import MCtx
from repro_torch.models.layers import (embed_tokens, mlp_apply, rmsnorm,
                                       sinusoidal_pos_emb, unembed)
from repro_torch.models.moe import moe_ffn
from repro_torch.models.params import (map_specs, stack_specs, torch_dtype,
                                      tree_map)
from repro_torch.models.sharding import local_shape
from repro_torch.models.ssm import ssm_decode
from repro_torch.models.transformer import (Seg, _with_positions, encode,
                                            forward_hidden, layer_views,
                                            segment_plan)
from repro_torch.models.xlstm import mlstm_decode, slstm_decode

WHISPER_CROSS_LEN = 1500   # 30 s of audio at the whisper frame rate


# --------------------------------------------------------------------------
# Cache specs (mirror forward collect structure)
# --------------------------------------------------------------------------


def cache_specs(cfg: ModelConfig, mctx: MCtx, B: int, S: int) -> dict:
    """ParamSpec tree for the decode cache of (cfg, batch B, max len S);
    whisper's cross caches hold ``WHISPER_CROSS_LEN`` frames."""
    if cfg.encoder_decoder:
        layer = {"self": kvcache.attn_cache_specs(cfg, B, S, "act_seq"),
                 "cross": kvcache.cross_cache_specs(cfg, B,
                                                    WHISPER_CROSS_LEN)}
        return {"decoder": stack_specs(layer, cfg.num_layers)}
    return {seg.name: kvcache.seg_cache_specs(cfg, seg, B, S,
                                              mctx.cache_seq_axis)
            for seg in segment_plan(cfg)}


# --------------------------------------------------------------------------
# Block decode applies
# --------------------------------------------------------------------------


def _attn_block_dec(p, x, pos, pos_t, cache, cfg, mctx, *, window,
                    moe=False):
    """``pos`` as given to the step (MLA and the mesh path read it),
    ``pos_t`` the tensor ``attn_decode`` reads."""
    if mctx.mesh is not None:
        return tp.attn_block_dec(p, x, pos, cache, cfg, mctx, window=window,
                                 moe=moe)
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if cfg.attn_type == "mla":
        a, _ = mla_decode(p["attn"], h, pos, cache, cfg)
    else:
        a, _ = attn_decode(p["attn"], h, pos_t, cache, cfg, window=window)
    x = x + a
    h2 = rmsnorm(x, p["ln2"], cfg.norm_eps)
    if moe:
        f, _ = moe_ffn(p["moe"], h2, cfg, mctx)
    else:
        f = mlp_apply(p["mlp"], h2)
    return x + f


def _recurrent_dec(step, key: str, kind: str):
    """A residual block around a recurrent cell's decode step that copies
    the cell's new state into ``cache`` (views of the stacked cache)."""
    def block(p, x, cache, cfg, mctx: MCtx):
        if mctx.mesh is not None:
            return tp_recurrent.block_dec(kind, p, x, cache, cfg, mctx)
        out, new = step(p[key], rmsnorm(x, p["ln"], cfg.norm_eps), cache,
                        cfg)
        tree_map(lambda old, nw: old.copy_(nw), cache, new)
        return x + out
    return block


_mamba_block_dec = _recurrent_dec(ssm_decode, "ssm", "mamba")
_mlstm_block_dec = _recurrent_dec(mlstm_decode, "cell", "mlstm")
_slstm_block_dec = _recurrent_dec(slstm_decode, "cell", "slstm")


# --------------------------------------------------------------------------
# Segment decode
# --------------------------------------------------------------------------


def seg_decode(p, cache, x, pos, pos_t, cfg: ModelConfig, mctx: MCtx,
               seg: Seg, shared_attn=None):
    """One token through a segment; its stacked cache is updated in
    place. ``pos``/``pos_t``: as ``_attn_block_dec`` takes them."""
    for lp, lc in zip(layer_views(p, seg.n), layer_views(cache, seg.n)):
        if seg.kind == "attn":
            x = _attn_block_dec(lp, x, pos, pos_t, lc, cfg, mctx,
                                window=seg.window, moe=seg.moe)
        elif seg.kind == "gemma":
            for ll, cl in zip(layer_views(lp["local"], seg.sub),
                              layer_views(lc["local"], seg.sub)):
                x = _attn_block_dec(ll, x, pos, pos_t, cl, cfg, mctx,
                                    window=seg.window)
            x = _attn_block_dec(lp["global"], x, pos, pos_t, lc["global"],
                                cfg, mctx, window=0)
        elif seg.kind == "zamba":
            for ll, cl in zip(layer_views(lp["mamba"], seg.sub),
                              layer_views(lc["mamba"], seg.sub)):
                x = _mamba_block_dec(ll, x, cl, cfg, mctx)
            sa = shared_attn
            if mctx.mesh is not None:
                x = tp.attn_block_dec(sa, x, pos, lc["attn"], cfg, mctx,
                                      window=0)
                continue
            h = rmsnorm(x, sa["ln1"], cfg.norm_eps)
            a, _ = attn_decode(sa["attn"], h, pos_t, lc["attn"], cfg)
            x = x + a
            x = x + mlp_apply(sa["mlp"], rmsnorm(x, sa["ln2"], cfg.norm_eps))
        elif seg.kind == "mamba":
            x = _mamba_block_dec(lp, x, lc, cfg, mctx)
        elif seg.kind == "xlstm":
            for ll, cl in zip(layer_views(lp["mlstm"], seg.sub),
                              layer_views(lc["mlstm"], seg.sub)):
                x = _mlstm_block_dec(ll, x, cl, cfg, mctx)
            x = _slstm_block_dec(lp["slstm"], x, lc["slstm"], cfg, mctx)
        elif seg.kind == "xlstm_tail":
            x = _mlstm_block_dec(lp, x, lc, cfg, mctx)
        else:
            raise ValueError(seg.kind)
    return x, cache


# --------------------------------------------------------------------------
# Public: prefill + decode_step
# --------------------------------------------------------------------------


def _pad_caches_to(caches, cfg: ModelConfig, mctx: MCtx, B: int,
                   max_len: int):
    """Zero-pad collected prompt caches to the decode cache shapes.

    Prefill produces prompt-length KV; decode needs max_len-length buffers
    (ring caches pad to the window). Any axis shorter than cache_specs is
    padded at the end; recurrent states already have their decode shapes.
    """
    target = cache_specs(cfg, mctx, B, max_len)

    def pad(leaf: torch.Tensor, shape: tuple) -> torch.Tensor:
        if tuple(leaf.shape) == shape:
            return leaf
        pads = []
        for have, want in zip(leaf.shape, shape):
            if want < have:
                raise ValueError(f"cache {tuple(leaf.shape)} exceeds {shape}")
            pads.append(want - have)
        # F.pad lists (left, right) pairs from the last dim backwards
        flat = [n for w in reversed(pads) for n in (0, w)]
        return F.pad(leaf, flat)

    def pad_spec(leaf, spec):
        if not isinstance(leaf, DTensor) or tuple(leaf.shape) == spec.shape:
            return pad(leaf, spec.shape)
        # a sharded sequence cannot be padded in place: gather, pad, and
        # place the padded cache as the rules say for its new length
        mesh = leaf.device_mesh
        whole = leaf.redistribute(mesh, [Replicate()] * mesh.ndim)
        padded = tp.map_local(lambda t: pad(t, spec.shape), whole)
        return padded.redistribute(mesh, tp.act(mctx, spec.axes, spec.shape))

    def walk(c, t):
        if isinstance(c, dict):
            return {k: walk(c[k], t[k]) for k in c}
        return pad_spec(c, t)

    return walk(caches, target)


def prefill(params, cfg: ModelConfig, mctx: MCtx, batch: dict,
            max_len: int = 0, q_chunk: int = 512):
    """Forward over the prompt; returns (last-token logits, caches).

    ``max_len`` sizes the decode cache buffers (0 -> prompt length; pass
    prompt+max_new_tokens for serving). Whisper: see
    ``_whisper_prefill``."""
    if cfg.encoder_decoder:
        return _whisper_prefill(params, cfg, mctx, batch,
                                max_decode_len=max_len or 1024,
                                q_chunk=q_chunk)
    x, caches, _ = forward_hidden(params, cfg, mctx, batch, collect=True,
                                  q_chunk=q_chunk)
    B, S = x.shape[:2]
    if max_len and max_len > S:
        caches = _pad_caches_to(caches, cfg, mctx, B, max_len)
    if mctx.mesh is not None:
        logits = tp.unembed(mctx, params["embed"], tp.last_token(mctx, x),
                            cfg.tie_embeddings)
    else:
        logits = unembed(params["embed"], x[:, -1:], cfg.tie_embeddings)
    logits = mctx.constrain(logits, ("act_batch", None, "act_vocab"))
    return logits, caches


def zeros_cache(s, mctx: MCtx, device) -> torch.Tensor:
    """A zeroed cache leaf of spec ``s``: on a mesh a DTensor placed by the
    rules, each rank holding zeros of its shard only."""
    dt = torch_dtype(s.dtype)
    if mctx.mesh is None:
        return torch.zeros(s.shape, dtype=dt, device=device)
    pl = tp.act(mctx, s.axes, s.shape)
    local = torch.zeros(local_shape(s.shape, pl, mctx.mesh), dtype=dt,
                        device=device)
    return DTensor.from_local(local, mctx.mesh, pl, run_check=False)


def _whisper_prefill(params, cfg: ModelConfig, mctx: MCtx, batch: dict,
                     max_decode_len: int = 1024, q_chunk: int = 512):
    """The encoder over ``batch["frames"]`` (B, S_enc, d). Returns (the
    encoder output, caches): a zeroed self cache of ``max_decode_len``
    positions and each decoder layer's cross K/V (B, S_enc, Hkv, dh), the
    encoder output's projections (no bias, as in the reference)."""
    enc_out = encode(params, cfg, mctx, batch["frames"], q_chunk=q_chunk)
    B = enc_out.shape[0]
    dec = params["decoder"]
    specs = cache_specs(cfg, mctx, B, max_decode_len)["decoder"]
    self_c = map_specs(lambda s: zeros_cache(s, mctx, enc_out.device),
                       specs["self"])
    if mctx.mesh is not None:
        axes = specs["cross"]["k"].axes[1:]
        cross = {name: tp.stack([
            mctx.constrain(tp._proj(mctx, enc_out, w,
                                    ("embed", "kv_heads", None)), axes)
            for w in tp.unbind(dec["xattn"][key])])
            for name, key in (("k", "w_k"), ("v", "w_v"))}
        return enc_out, {"decoder": {"self": self_c, "cross": cross}}
    cross = {name: torch.stack([_proj_heads(enc_out, w)
                                for w in torch.unbind(dec["xattn"][key])])
             for name, key in (("k", "w_k"), ("v", "w_v"))}
    return enc_out, {"decoder": {"self": self_c, "cross": cross}}


def _whisper_decode(params, cfg: ModelConfig, cache: dict, x: torch.Tensor,
                    pos_t: torch.Tensor) -> torch.Tensor:
    """One token through whisper's decoder: sinusoidal position, causal
    self-attention against the self cache (written in place), then
    cross-attention to the cached encoder K/V and the ungated MLP."""
    dtype = x.dtype
    x = x + sinusoidal_pos_emb(pos_t, cfg.d_model).to(dtype)
    dec = cache["decoder"]
    for lp, lc in zip(layer_views(params["decoder"], cfg.num_layers),
                      layer_views(dec, cfg.num_layers)):
        h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        a, _ = attn_decode(lp["attn"], h, pos_t, lc["self"], cfg,
                           use_rope=False)
        x = x + a
        hx = rmsnorm(x, lp["ln_x"], cfg.norm_eps)
        x = x + attn_decode_cross(lp["xattn"], hx, lc["cross"], cfg)
        x = x + mlp_apply(lp["mlp"], rmsnorm(x, lp["ln2"], cfg.norm_eps),
                          gated=False)
    return x


def decode_step(params, cfg: ModelConfig, mctx: MCtx, cache: dict,
                tokens: torch.Tensor, pos) -> tuple[torch.Tensor, dict]:
    """One token step. tokens: (B, 1) int; pos: position of the token, an
    int or a one-element int64 tensor on the tokens' device (the int
    everywhere on a mesh, and wherever MLA decodes).

    ``cache`` is updated in place and returned."""
    if mctx.mesh is not None:
        return _decode_step_mesh(params, cfg, mctx, cache, tokens, pos)
    pos_t = (pos if isinstance(pos, torch.Tensor) else
             torch.full((1,), pos, dtype=torch.int64, device=tokens.device))
    x = embed_tokens(params["embed"], tokens, torch_dtype(cfg.dtype))
    if cfg.encoder_decoder:
        x = _whisper_decode(params, cfg, cache, x, pos_t)
    else:
        shared = params.get("shared_attn")
        for seg in segment_plan(cfg):
            x, cache[seg.name] = seg_decode(params[seg.name],
                                            cache[seg.name], x, pos, pos_t,
                                            cfg, mctx, seg,
                                            shared_attn=shared)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(params["embed"], x, cfg.tie_embeddings)
    return logits, cache


def _decode_step_mesh(params, cfg: ModelConfig, mctx: MCtx, cache: dict,
                      tokens, pos: int):
    x = tp.embed(mctx, params["embed"]["tok"], tokens, torch_dtype(cfg.dtype))
    x = mctx.constrain(x, ("act_batch", None, "act_embed"))
    if cfg.encoder_decoder:
        x = _with_positions(x, sinusoidal_pos_emb(
            torch.full((1,), pos, device=x.device), cfg.d_model).to(x.dtype),
            mctx)
        for lp, lc in zip(layer_views(params["decoder"], cfg.num_layers),
                          layer_views(cache["decoder"], cfg.num_layers)):
            x = tp.cross_block_dec(lp, x, pos, lc, cfg, mctx)
    else:
        shared = params.get("shared_attn")
        for seg in segment_plan(cfg):
            x, cache[seg.name] = seg_decode(params[seg.name],
                                            cache[seg.name], x, pos, None,
                                            cfg, mctx, seg,
                                            shared_attn=shared)
    x = tp.rms_norm(mctx, x, params["final_norm"], cfg.norm_eps)
    logits = tp.unembed(mctx, params["embed"], x, cfg.tie_embeddings)
    logits = mctx.constrain(logits, ("act_batch", None, "act_vocab"))
    return logits, cache
