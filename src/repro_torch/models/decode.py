"""Decode (serve) path: cache specs, prefill, single-token decode step.

Decode caches mirror the ``collect=True`` structure of the forward pass
(``{segment: stacked cache tree}``, see ``kvcache.seg_cache_specs``), so
prefill output feeds decode directly. A decode step writes the new K/V
(or latents) into the cache in place and copies each recurrent block's new
state over its old one, so the cache it is given is the cache it returns.

The position of the decoded token is given to ``decode_step`` as a Python
int or a one-element int64 tensor on the device, and converted there once.
Off a mesh every block reads it as that tensor (GQA's ``attn_decode`` and
MLA's ``mla_decode`` alike), made once a step from an int, so a step reads
no position on the host and can be captured as a CUDA graph and replayed
at every position (``launch/serve.py``); on a mesh the blocks take the
int.

Whisper (encoder-decoder): ``prefill`` of ``{"frames"}`` runs the encoder
and returns its output (not logits) with a zeroed self cache and each
decoder layer's cross K/V of the encoder's output; ``decode_step`` then
runs the decoder one token at a time, reading the cross cache only.

As in ``models/transformer.py``, each entry point (``prefill``,
``decode_step``, ``zeros_cache``) picks its path once by ``MCtx.mesh``:
``PLAIN`` or ``MESH``, the forward's records with the decode blocks added.
With a mesh the cache leaves are DTensors placed as the rules say (the
K/V and latents sequence-sharded, ``act_cache_seq``; recurrent states by
head, ``act_heads``), every arch decodes through the blocks of
``models/tp.py`` and ``models/tp_recurrent.py``, and logits come back
vocab-sharded (``act_vocab``) where ``model`` divides the vocabulary.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.config.base import ModelConfig
from repro_torch.models import kvcache, tp, tp_recurrent, transformer
from repro_torch.models.attention import (_proj_heads, attn_decode,
                                          attn_decode_cross, mla_decode)
from repro_torch.models.context import MCtx
from repro_torch.models.layers import (add_rmsnorm, mlp_apply, rmsnorm,
                                       sinusoidal_pos_emb, unembed)
from repro_torch.models.moe import moe_ffn
from repro_torch.models.params import (map_specs, stack_specs, torch_dtype,
                                      tree_map)
from repro_torch.models.sharding import local_shape
from repro_torch.models.ssm import ssm_decode
from repro_torch.models.transformer import (Blocks, Seg, _stack,
                                            _with_positions, encode,
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


def _attn_block_dec(p, x, pos: torch.Tensor, cache, cfg, mctx, *, window,
                    moe=False):
    """``pos``: the step's one-element int64 device tensor."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if cfg.attn_type == "mla":
        a, _ = mla_decode(p["attn"], h, pos, cache, cfg)
    else:
        a, _ = attn_decode(p["attn"], h, pos, cache, cfg, window=window)
    x, h2 = add_rmsnorm(x, a, p["ln2"], cfg.norm_eps)
    if moe:
        f, _ = moe_ffn(p["moe"], h2, cfg, mctx)
    else:
        f = mlp_apply(p["mlp"], h2)
    return x + f


def _cross_block_dec(p, x, pos: torch.Tensor, cache, cfg, mctx):
    """One token through whisper's decoder block: causal self-attention
    against the self cache (written in place), then cross-attention to the
    cached encoder K/V and the ungated MLP."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    a, _ = attn_decode(p["attn"], h, pos, cache["self"], cfg, use_rope=False)
    x = x + a
    hx = rmsnorm(x, p["ln_x"], cfg.norm_eps)
    x = x + attn_decode_cross(p["xattn"], hx, cache["cross"], cfg)
    return x + mlp_apply(p["mlp"], rmsnorm(x, p["ln2"], cfg.norm_eps),
                         gated=False)


_CELL_DEC = {"mamba": ssm_decode, "mlstm": mlstm_decode,
             "slstm": slstm_decode}


def _recurrent_block_dec(kind: str, p, x, cache, cfg, mctx: MCtx):
    """A residual block around a recurrent cell's decode step that copies
    the cell's new state into ``cache`` (views of the stacked cache)."""
    out, new = _CELL_DEC[kind](p["ssm" if kind == "mamba" else "cell"],
                               rmsnorm(x, p["ln"], cfg.norm_eps), cache, cfg)
    tree_map(lambda old, nw: old.copy_(nw), cache, new)
    return x + out


@dataclasses.dataclass(frozen=True)
class DecodeBlocks(Blocks):
    """A path's forward functions and its decode blocks, in the mesh's
    signatures."""
    attn_dec: Callable        # (p, x, pos, cache, cfg, mctx, *, window, moe)
    recurrent_dec: Callable   # (kind, p, x, cache, cfg, mctx)
    cross_dec: Callable       # whisper's decoder block, one token
    last_token: Callable      # (mctx, x): x[:, -1:]
    unembed: Callable         # (mctx, emb, x, tied)
    kv_proj: Callable         # (mctx, enc_out, w): whisper's cross K or V


PLAIN = DecodeBlocks(
    **vars(transformer.PLAIN), attn_dec=_attn_block_dec,
    recurrent_dec=_recurrent_block_dec, cross_dec=_cross_block_dec,
    last_token=lambda mctx, x: x[:, -1:],
    unembed=lambda mctx, emb, x, tied: unembed(emb, x, tied),
    kv_proj=lambda mctx, x, w: _proj_heads(x, w))
MESH = DecodeBlocks(
    **vars(transformer.MESH), attn_dec=tp.attn_block_dec,
    recurrent_dec=tp_recurrent.block_dec, cross_dec=tp.cross_block_dec,
    last_token=tp.last_token, unembed=tp.unembed,
    kv_proj=lambda mctx, x, w: tp._proj(mctx, x, w,
                                        ("embed", "kv_heads", None)))


# --------------------------------------------------------------------------
# Segment decode
# --------------------------------------------------------------------------


def seg_decode(p, cache, x, pos, cfg: ModelConfig, mctx: MCtx, seg: Seg,
               blocks: DecodeBlocks, shared_attn=None):
    """One token through a segment's ``blocks``; its stacked cache is
    updated in place. ``pos``: the path's position (``decode_step``)."""
    for lp, lc in zip(layer_views(p, seg.n), layer_views(cache, seg.n)):
        if seg.kind == "attn":
            x = blocks.attn_dec(lp, x, pos, lc, cfg, mctx, window=seg.window,
                                moe=seg.moe)
        elif seg.kind == "gemma":
            for ll, cl in zip(layer_views(lp["local"], seg.sub),
                              layer_views(lc["local"], seg.sub)):
                x = blocks.attn_dec(ll, x, pos, cl, cfg, mctx,
                                    window=seg.window)
            x = blocks.attn_dec(lp["global"], x, pos, lc["global"], cfg,
                                mctx, window=0)
        elif seg.kind == "zamba":
            for ll, cl in zip(layer_views(lp["mamba"], seg.sub),
                              layer_views(lc["mamba"], seg.sub)):
                x = blocks.recurrent_dec("mamba", ll, x, cl, cfg, mctx)
            x = blocks.attn_dec(shared_attn, x, pos, lc["attn"], cfg, mctx,
                                window=0)
        elif seg.kind == "mamba":
            x = blocks.recurrent_dec("mamba", lp, x, lc, cfg, mctx)
        elif seg.kind == "xlstm":
            for ll, cl in zip(layer_views(lp["mlstm"], seg.sub),
                              layer_views(lc["mlstm"], seg.sub)):
                x = blocks.recurrent_dec("mlstm", ll, x, cl, cfg, mctx)
            x = blocks.recurrent_dec("slstm", lp["slstm"], x, lc["slstm"],
                                     cfg, mctx)
        elif seg.kind == "xlstm_tail":
            x = blocks.recurrent_dec("mlstm", lp, x, lc, cfg, mctx)
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
    blocks = MESH if mctx.mesh is not None else PLAIN
    if cfg.encoder_decoder:
        return _whisper_prefill(params, cfg, mctx, blocks, batch,
                                max_decode_len=max_len or 1024,
                                q_chunk=q_chunk)
    x, caches, _ = forward_hidden(params, cfg, mctx, batch, collect=True,
                                  q_chunk=q_chunk)
    B, S = x.shape[:2]
    if max_len and max_len > S:
        caches = _pad_caches_to(caches, cfg, mctx, B, max_len)
    logits = blocks.unembed(mctx, params["embed"], blocks.last_token(mctx, x),
                            cfg.tie_embeddings)
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


def _whisper_prefill(params, cfg: ModelConfig, mctx: MCtx,
                     blocks: DecodeBlocks, batch: dict,
                     max_decode_len: int = 1024, q_chunk: int = 512):
    """The encoder over ``batch["frames"]`` (B, S_enc, d). Returns (the
    encoder output, caches): a zeroed self cache of ``max_decode_len``
    positions and each decoder layer's cross K/V (B, S_enc, Hkv, dh), the
    encoder output's projections (no bias, as in the reference)."""
    enc_out = encode(params, cfg, mctx, batch["frames"], q_chunk=q_chunk)
    B = enc_out.shape[0]
    specs = cache_specs(cfg, mctx, B, max_decode_len)["decoder"]
    self_c = map_specs(lambda s: zeros_cache(s, mctx, enc_out.device),
                       specs["self"])
    axes = specs["cross"]["k"].axes[1:]
    xattn = layer_views(params["decoder"]["xattn"], cfg.num_layers)
    cross = {name: _stack([mctx.constrain(
        blocks.kv_proj(mctx, enc_out, lp[key]), axes) for lp in xattn])
        for name, key in (("k", "w_k"), ("v", "w_v"))}
    return enc_out, {"decoder": {"self": self_c, "cross": cross}}


def decode_step(params, cfg: ModelConfig, mctx: MCtx, cache: dict,
                tokens: torch.Tensor, pos) -> tuple[torch.Tensor, dict]:
    """One token step. tokens: (B, 1) int; pos: position of the token, an
    int or a one-element int64 tensor on the tokens' device. Off a mesh
    the blocks read it as that tensor, made here from an int; on a mesh
    as an int.

    ``cache`` is updated in place and returned."""
    if mctx.mesh is None:
        blocks = PLAIN
        if not isinstance(pos, torch.Tensor):
            pos = torch.full((1,), pos, dtype=torch.int64,
                             device=tokens.device)
    else:
        blocks, pos = MESH, int(pos)
    x = blocks.embed(mctx, params["embed"], tokens, torch_dtype(cfg.dtype))
    x = mctx.constrain(x, ("act_batch", None, "act_embed"))
    if cfg.encoder_decoder:
        pe = sinusoidal_pos_emb(torch.as_tensor(pos, device=x.device)
                                .reshape(1), cfg.d_model)
        x = _with_positions(x, pe.to(x.dtype), mctx)
        for lp, lc in zip(layer_views(params["decoder"], cfg.num_layers),
                          layer_views(cache["decoder"], cfg.num_layers)):
            x = blocks.cross_dec(lp, x, pos, lc, cfg, mctx)
    else:
        shared = params.get("shared_attn")
        for seg in segment_plan(cfg):
            x, cache[seg.name] = seg_decode(params[seg.name],
                                            cache[seg.name], x, pos, cfg,
                                            mctx, seg, blocks,
                                            shared_attn=shared)
    x = blocks.norm(mctx, x, params["final_norm"], cfg.norm_eps)
    logits = blocks.unembed(mctx, params["embed"], x, cfg.tie_embeddings)
    return mctx.constrain(logits, ("act_batch", None, "act_vocab")), cache
