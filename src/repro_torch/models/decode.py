"""Decode (serve) path: cache specs, prefill, single-token decode step.

Decode caches mirror the ``collect=True`` structure of the forward pass
(``{segment: stacked cache tree}``, see ``kvcache.seg_cache_specs``), so
prefill output feeds decode directly. A decode step writes the new K/V
(or latents) into the cache in place and copies each recurrent block's new
state over its old one, so the cache it is given is the cache it returns.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.models import kvcache
from repro_torch.models.attention import attn_decode, mla_decode
from repro_torch.models.context import MCtx
from repro_torch.models.layers import embed_tokens, mlp_apply, rmsnorm, unembed
from repro_torch.models.moe import moe_ffn
from repro_torch.models.params import torch_dtype, tree_map
from repro_torch.models.ssm import ssm_decode
from repro_torch.models.transformer import (Seg, forward_hidden,
                                            layer_views, segment_plan)
from repro_torch.models.xlstm import mlstm_decode, slstm_decode


# --------------------------------------------------------------------------
# Cache specs (mirror forward collect structure)
# --------------------------------------------------------------------------


def cache_specs(cfg: ModelConfig, mctx: MCtx, B: int, S: int) -> dict:
    """ParamSpec tree for the decode cache of (cfg, batch B, max len S)."""
    return {seg.name: kvcache.seg_cache_specs(cfg, seg, B, S,
                                              mctx.cache_seq_axis)
            for seg in segment_plan(cfg)}


# --------------------------------------------------------------------------
# Block decode applies
# --------------------------------------------------------------------------


def _attn_block_dec(p, x, pos, cache, cfg, mctx, *, window, moe=False):
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if cfg.attn_type == "mla":
        a, _ = mla_decode(p["attn"], h, pos, cache, cfg)
    else:
        a, _ = attn_decode(p["attn"], h, pos, cache, cfg, window=window)
    x = x + a
    h2 = rmsnorm(x, p["ln2"], cfg.norm_eps)
    if moe:
        f, _ = moe_ffn(p["moe"], h2, cfg, mctx)
    else:
        f = mlp_apply(p["mlp"], h2)
    return x + f


def _recurrent_dec(step, key: str):
    """A residual block around a recurrent cell's decode step that copies
    the cell's new state into ``cache`` (views of the stacked cache)."""
    def block(p, x, cache, cfg):
        out, new = step(p[key], rmsnorm(x, p["ln"], cfg.norm_eps), cache,
                        cfg)
        tree_map(lambda old, nw: old.copy_(nw), cache, new)
        return x + out
    return block


_mamba_block_dec = _recurrent_dec(ssm_decode, "ssm")
_mlstm_block_dec = _recurrent_dec(mlstm_decode, "cell")
_slstm_block_dec = _recurrent_dec(slstm_decode, "cell")


# --------------------------------------------------------------------------
# Segment decode
# --------------------------------------------------------------------------


def seg_decode(p, cache, x, pos, cfg: ModelConfig, mctx: MCtx, seg: Seg,
               shared_attn=None):
    """One token through a segment; its stacked cache is updated in
    place."""
    for lp, lc in zip(layer_views(p, seg.n), layer_views(cache, seg.n)):
        if seg.kind == "attn":
            x = _attn_block_dec(lp, x, pos, lc, cfg, mctx,
                                window=seg.window, moe=seg.moe)
        elif seg.kind == "gemma":
            for ll, cl in zip(layer_views(lp["local"], seg.sub),
                              layer_views(lc["local"], seg.sub)):
                x = _attn_block_dec(ll, x, pos, cl, cfg, mctx,
                                    window=seg.window)
            x = _attn_block_dec(lp["global"], x, pos, lc["global"], cfg,
                                mctx, window=0)
        elif seg.kind == "zamba":
            for ll, cl in zip(layer_views(lp["mamba"], seg.sub),
                              layer_views(lc["mamba"], seg.sub)):
                x = _mamba_block_dec(ll, x, cl, cfg)
            sa = shared_attn
            h = rmsnorm(x, sa["ln1"], cfg.norm_eps)
            a, _ = attn_decode(sa["attn"], h, pos, lc["attn"], cfg)
            x = x + a
            x = x + mlp_apply(sa["mlp"], rmsnorm(x, sa["ln2"], cfg.norm_eps))
        elif seg.kind == "mamba":
            x = _mamba_block_dec(lp, x, lc, cfg)
        elif seg.kind == "xlstm":
            for ll, cl in zip(layer_views(lp["mlstm"], seg.sub),
                              layer_views(lc["mlstm"], seg.sub)):
                x = _mlstm_block_dec(ll, x, cl, cfg)
            x = _slstm_block_dec(lp["slstm"], x, lc["slstm"], cfg)
        elif seg.kind == "xlstm_tail":
            x = _mlstm_block_dec(lp, x, lc, cfg)
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

    def walk(c, t):
        if isinstance(c, dict):
            return {k: walk(c[k], t[k]) for k in c}
        return pad(c, t.shape)

    return walk(caches, target)


def prefill(params, cfg: ModelConfig, mctx: MCtx, batch: dict,
            max_len: int = 0, q_chunk: int = 512):
    """Forward over the prompt; returns (last-token logits, caches).

    ``max_len`` sizes the decode cache buffers (0 -> prompt length; pass
    prompt+max_new_tokens for serving)."""
    x, caches, _ = forward_hidden(params, cfg, mctx, batch, collect=True,
                                  q_chunk=q_chunk)
    B, S = x.shape[:2]
    if max_len and max_len > S:
        caches = _pad_caches_to(caches, cfg, mctx, B, max_len)
    logits = unembed(params["embed"], x[:, -1:], cfg.tie_embeddings)
    return logits, caches


def decode_step(params, cfg: ModelConfig, mctx: MCtx, cache: dict,
                tokens: torch.Tensor, pos: int) -> tuple[torch.Tensor, dict]:
    """One token step. tokens: (B, 1) int; pos: position of the token.

    ``cache`` is updated in place and returned."""
    x = embed_tokens(params["embed"], tokens, torch_dtype(cfg.dtype))
    shared = params.get("shared_attn")
    for seg in segment_plan(cfg):
        x, cache[seg.name] = seg_decode(params[seg.name], cache[seg.name], x,
                                        pos, cfg, mctx, seg,
                                        shared_attn=shared)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(params["embed"], x, cfg.tie_embeddings)
    return logits, cache
