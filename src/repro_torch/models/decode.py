"""Decode (serve) path: cache specs, prefill, single-token decode step.

Decode caches mirror the ``collect=True`` structure of the forward pass
(``{segment: {"k", "v": [L, B, S, Hkv, dh]}}``), so prefill output feeds
decode directly. A decode step writes the new k/v into the cache in place.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.models import kvcache
from repro_torch.models.attention import attn_decode
from repro_torch.models.context import MCtx
from repro_torch.models.layers import embed_tokens, mlp_apply, rmsnorm, unembed
from repro_torch.models.params import stack_specs, torch_dtype
from repro_torch.models.transformer import (Seg, forward_hidden,
                                            layer_views, segment_plan)


# --------------------------------------------------------------------------
# Cache specs (mirror forward collect structure)
# --------------------------------------------------------------------------


def cache_specs(cfg: ModelConfig, mctx: MCtx, B: int, S: int) -> dict:
    """ParamSpec tree for the decode cache of (cfg, batch B, max len S)."""
    out: dict[str, Any] = {}
    for seg in segment_plan(cfg):
        out[seg.name] = stack_specs(
            kvcache.attn_cache_specs(cfg, B, S, mctx.cache_seq_axis,
                                     window=seg.window), seg.n)
    return out


# --------------------------------------------------------------------------
# Block and segment decode
# --------------------------------------------------------------------------


def _attn_block_dec(p, x, pos, cache, cfg, mctx, *, window):
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    a, cache = attn_decode(p["attn"], h, pos, cache, cfg, window=window)
    x = x + a
    h2 = rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + mlp_apply(p["mlp"], h2), cache


def seg_decode(p, cache, x, pos, cfg: ModelConfig, mctx: MCtx, seg: Seg):
    """One token through a segment; its stacked cache is updated in place."""
    for lp, lc in zip(layer_views(p, seg.n), layer_views(cache, seg.n)):
        x, _ = _attn_block_dec(lp, x, pos, lc, cfg, mctx, window=seg.window)
    return x, cache


# --------------------------------------------------------------------------
# Public: prefill + decode_step
# --------------------------------------------------------------------------


def _pad_caches_to(caches, cfg: ModelConfig, mctx: MCtx, B: int,
                   max_len: int):
    """Zero-pad collected prompt caches to the decode cache shapes.

    Prefill produces prompt-length KV; decode needs max_len-length buffers
    (ring caches pad to the window). Any axis shorter than cache_specs is
    padded at the end.
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
    x, caches = forward_hidden(params, cfg, mctx, batch, collect=True,
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
    for seg in segment_plan(cfg):
        x, cache[seg.name] = seg_decode(params[seg.name], cache[seg.name], x,
                                        pos, cfg, mctx, seg)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(params["embed"], x, cfg.tie_embeddings)
    return logits, cache
