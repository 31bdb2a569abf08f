"""Attention: GQA (full / sliding-window / local:global), MLA, prefill and
decode paths.

Prefill uses *chunked* attention — a loop over query blocks so the (S x S)
score matrix is never materialized (O(q_chunk x S_kv) transient). Sliding
windows additionally slice the KV to (window + q_chunk). With
``ParallelConfig.attention_kernel == "kernel"`` prefill instead goes
through the hand-written flash attention kernel (``repro_torch.kernels``).

Decode uses single-token attention against a KV cache, which it updates in
place. Scores, softmax and context are fp32 in every path, cast to the
activation dtype at the end. GQA decode (self and cross) goes through the
hand-written dense decode attention kernel on CUDA tensors and its plain
version (``decode_attention``, re-exported here) on the CPU. MLA
(deepseek-v3) prefills through chunked attention, as the reference does
(its value head dim differs from its query head dim), over slices of the
batch that bound its fp32 scores, and decodes in the absorbed latent
form; both turn its rope parts by YaRN's frequencies and scale its
softmax by YaRN's temperature where ``cfg.rope_scaling`` is set. Whisper's
decoder attends to its encoder's output through cross-attention: in
prefill through chunked attention (the flash kernel's gate wants as many
keys as queries, as the reference's does), in decode against the cross
K/V cached by prefill (``attn_decode_cross``). qwen2-vl turns q and k by
M-RoPE (``cfg.mrope``: positions (3, B, S)). q and k are turned by one
``layers.rope`` call: the hand-written rope kernel where no gradient is
recorded, the plain chain where one is.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config.base import ModelConfig, yarn_mscale
from repro_torch.kernels.decode_attention import dense_decode_attention
from repro_torch.kernels.decode_attention.ref import (  # noqa: F401
    NEG_INF, _gqa_ctx, _gqa_scores, decode_attention)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import rmsnorm, rmsnorm_spec, rope
from repro_torch.models.params import ParamSpec


# --------------------------------------------------------------------------
# Core chunked attention
# --------------------------------------------------------------------------


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      q_chunk: int = 512, q_offset: int = 0,
                      scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, Hq, dh); k, v: (B, Skv, Hkv, dh) -> (B, Sq, Hq, dh).

    ``q_offset`` is the absolute position of q[0] relative to k[0]
    (chunked-prefill support). ``window`` > 0 restricts each query to the
    last ``window`` keys (inclusive of self).
    """
    B, Sq, Hq, dh = q.shape
    _, Skv, Hkv, _ = k.shape
    dv = v.shape[-1]
    G = Hq // Hkv
    scale = scale if scale is not None else dh ** -0.5
    qc = q_chunk if (Sq % q_chunk == 0 and Sq >= q_chunk) else Sq
    nq = Sq // qc
    qg = q.reshape(B, nq, qc, Hkv, G, dh)

    use_window = window > 0 and Skv > window + qc
    kv_span = window + qc if use_window else Skv
    dev = q.device

    outs = []
    for c in range(nq):
        q0 = c * qc + q_offset                       # abs pos of first query
        if use_window:
            start = min(max(q0 - window, 0), Skv - kv_span)
            k_c = k[:, start:start + kv_span]
            v_c = v[:, start:start + kv_span]
            kv_pos = start + torch.arange(kv_span, device=dev)
        else:
            k_c, v_c = k, v
            kv_pos = torch.arange(Skv, device=dev)
        scores = _gqa_scores(qg[:, c], k_c) * scale  # (B,Hkv,G,qc,kv)
        q_pos = q0 + torch.arange(qc, device=dev)
        mask = torch.ones((qc, kv_span), dtype=torch.bool, device=dev)
        if causal:
            mask &= kv_pos[None, :] <= q_pos[:, None]
        if window > 0:
            mask &= kv_pos[None, :] > q_pos[:, None] - window
        scores = torch.where(mask, scores, NEG_INF)
        p = torch.softmax(scores, dim=-1)
        outs.append(_gqa_ctx(p, v_c).to(q.dtype))   # (B,qc,Hkv,G,dh)
    return torch.cat(outs, dim=1).reshape(B, Sq, Hq, dv)


# --------------------------------------------------------------------------
# Standard (GQA) attention block projections
# --------------------------------------------------------------------------


def attention_specs(cfg: ModelConfig) -> dict:
    """Self- or cross-attention projections (the same shapes)."""
    d, Hq, Hkv, dh = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                      cfg.resolved_head_dim)
    specs = {
        "w_q": ParamSpec((d, Hq, dh), ("embed", "heads", None)),
        "w_k": ParamSpec((d, Hkv, dh), ("embed", "kv_heads", None)),
        "w_v": ParamSpec((d, Hkv, dh), ("embed", "kv_heads", None)),
        "w_o": ParamSpec((Hq, dh, d), ("heads", None, "embed")),
    }
    if cfg.qkv_bias:
        specs["b_q"] = ParamSpec((Hq, dh), ("heads", None), init="zeros")
        specs["b_k"] = ParamSpec((Hkv, dh), ("kv_heads", None), init="zeros")
        specs["b_v"] = ParamSpec((Hkv, dh), ("kv_heads", None), init="zeros")
    return specs


def _proj_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bsd,dhk->bshk') as one matmul, in x's dtype."""
    d, H, dh = w.shape
    return (x @ w.reshape(d, H * dh).to(x.dtype)).unflatten(-1, (H, dh))


def _out_proj(ctx: torch.Tensor, w_o: torch.Tensor) -> torch.Tensor:
    """einsum('bshk,hkd->bsd') as one matmul, in ctx's dtype."""
    H, dh, d = w_o.shape
    return ctx.flatten(-2) @ w_o.reshape(H * dh, d).to(ctx.dtype)


def _project_qkv(p: dict, x: torch.Tensor,
                 x_kv: Optional[torch.Tensor] = None):
    """q from ``x``, k and v from ``x_kv`` (default ``x``)."""
    x_kv = x if x_kv is None else x_kv
    q = _proj_heads(x, p["w_q"])
    k = _proj_heads(x_kv, p["w_k"])
    v = _proj_heads(x_kv, p["w_v"])
    if "b_q" in p:
        q = q + p["b_q"].to(q.dtype)
        k = k + p["b_k"].to(k.dtype)
        v = v + p["b_v"].to(v.dtype)
    return q, k, v


def attn_forward(p: dict, x: torch.Tensor, positions: torch.Tensor,
                 cfg: ModelConfig, *, causal: bool = True, window: int = 0,
                 use_rope: bool = True, x_kv: Optional[torch.Tensor] = None,
                 kv_positions: Optional[torch.Tensor] = None,
                 q_chunk: int = 512, mctx=None) -> tuple[torch.Tensor, dict]:
    """Full-sequence attention (prefill), causal unless ``causal=False``:
    self-attention, or cross-attention to ``x_kv`` (keys at
    ``kv_positions``). q and k are turned by rope (M-RoPE where
    ``cfg.mrope``) unless ``use_rope=False``. Returns (out, kv) where kv
    holds the rope'd k/v for cache construction. Without ``mctx`` it takes
    chunked attention, as the reference does."""
    q, k, v = _project_qkv(p, x, x_kv)
    if use_rope and kv_positions is None and k.shape[:2] == q.shape[:2]:
        q, k = rope(q, k, positions, cfg.rope_theta, cfg.mrope)
    elif use_rope:
        kp = positions if kv_positions is None else kv_positions
        q = rope(q, None, positions, cfg.rope_theta, cfg.mrope)[0]
        k = rope(k, None, kp, cfg.rope_theta, cfg.mrope)[0]
    if (mctx is not None
            and mctx.parallel.attention_kernel == "kernel"
            and q.shape[1] == k.shape[1]):
        # The hand-written flash kernel reads the (B, S, H, d) tensors
        # through (B, H, S, d) views and writes its output in q's layout,
        # so no transpose is copied. Semantics == chunked_attention.
        ctx = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal,
                              window=window).transpose(1, 2)
    else:
        ctx = chunked_attention(q, k, v, causal=causal, window=window,
                                q_chunk=q_chunk)
    return _out_proj(ctx, p["w_o"]), {"k": k, "v": v}


def attn_decode(p: dict, x: torch.Tensor, pos: torch.Tensor, cache: dict,
                cfg: ModelConfig, *, window: int = 0, use_rope: bool = True
                ) -> tuple[torch.Tensor, dict]:
    """One decode step. x: (B, 1, d). cache: {k,v: (B, S_or_W, Hkv, dh)}.

    ``pos`` is the current absolute position, a one-element int64 tensor
    on x's device: the rope position (every M-RoPE axis at ``pos``, as in
    the reference) and the cache slot. The step reads it only on the
    device, so a CUDA graph captured around it serves every position. The
    new k/v are written into ``cache`` in place (at ``pos``, or ``pos %
    window`` for ring caches) — where the reference returns an updated
    copy — and ``cache`` is returned.
    """
    q, k_new, v_new = _project_qkv(p, x)
    if use_rope:
        positions = pos.expand(x.shape[0], 1)
        if cfg.mrope:
            positions = positions.expand(3, *positions.shape)
        q, k_new = rope(q, k_new, positions, cfg.rope_theta, cfg.mrope)
    k_cache, v_cache = cache["k"], cache["v"]
    S = k_cache.shape[1]
    slot = pos % S if window > 0 else pos
    k_cache.index_copy_(1, slot, k_new.to(k_cache.dtype))
    v_cache.index_copy_(1, slot, v_new.to(v_cache.dtype))
    # the first min(pos + 1, S) slots are live: a ring cache that has
    # wrapped has all of them
    ctx = dense_decode_attention(q, k_cache, v_cache, pos)
    return _out_proj(ctx, p["w_o"]), cache


def attn_decode_cross(p: dict, x: torch.Tensor, cross_kv: dict,
                      cfg: ModelConfig) -> torch.Tensor:
    """Cross-attention decode step against the encoder's K/V, which
    prefill cached (read only). x: (B, 1, d)."""
    q = _proj_heads(x, p["w_q"])
    if "b_q" in p:
        q = q + p["b_q"].to(q.dtype)
    ctx = dense_decode_attention(q, cross_kv["k"], cross_kv["v"])
    return _out_proj(ctx, p["w_o"])


# --------------------------------------------------------------------------
# MLA (DeepSeek-V3 multi-head latent attention)
# --------------------------------------------------------------------------


def mla_specs(cfg: ModelConfig) -> dict:
    m = cfg.mla
    d, H = cfg.d_model, cfg.num_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "w_dq": ParamSpec((d, m.q_lora_rank), ("embed", None)),
        "q_norm": rmsnorm_spec(m.q_lora_rank),
        "w_uq": ParamSpec((m.q_lora_rank, H, qk), (None, "heads", None)),
        "w_dkv": ParamSpec((d, m.kv_lora_rank), ("embed", None)),
        "kv_norm": rmsnorm_spec(m.kv_lora_rank),
        "w_kr": ParamSpec((d, m.qk_rope_head_dim), ("embed", None)),
        "w_uk": ParamSpec((m.kv_lora_rank, H, m.qk_nope_head_dim),
                          (None, "heads", None)),
        "w_uv": ParamSpec((m.kv_lora_rank, H, m.v_head_dim),
                          (None, "heads", None)),
        "w_o": ParamSpec((H, m.v_head_dim, d), ("heads", None, "embed")),
    }


# the most bytes of fp32 scores that one slice of an MLA prefill's batch
# builds in ``chunked_attention`` (a (b, H, q_chunk, S) block)
MLA_SCORE_BYTES = 1 << 31


def mla_scale(cfg: ModelConfig) -> float:
    """MLA's softmax scale: one over the root of the q.k head dim, times
    YaRN's ``yarn_mscale(factor, mscale_all_dim)`` squared where the rope
    is stretched (DeepSeek-V3: 192 ** -0.5 * 1.3689 ** 2)."""
    m, y = cfg.mla, cfg.rope_scaling
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    if y is not None and y.mscale_all_dim:
        scale *= yarn_mscale(y.factor, y.mscale_all_dim) ** 2
    return scale


def _mla_q(p: dict, x: torch.Tensor, positions: torch.Tensor,
           cfg: ModelConfig):
    m = cfg.mla
    cq = rmsnorm(x @ p["w_dq"].to(x.dtype), p["q_norm"], cfg.norm_eps)
    q = _proj_heads(cq, p["w_uq"])
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = rope(q[..., m.qk_nope_head_dim:], None, positions,
                  cfg.rope_theta, yarn=cfg.rope_scaling)[0]
    return q_nope, q_rope


def _mla_latents(p: dict, x: torch.Tensor, positions: torch.Tensor,
                 cfg: ModelConfig):
    ckv = rmsnorm(x @ p["w_dkv"].to(x.dtype), p["kv_norm"], cfg.norm_eps)
    k_rope = rope((x @ p["w_kr"].to(x.dtype))[:, :, None, :], None,
                  positions, cfg.rope_theta,
                  yarn=cfg.rope_scaling)[0][:, :, 0, :]
    return ckv, k_rope


def mla_forward(p: dict, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig, q_chunk: int = 512):
    """Train/prefill MLA. Returns (out, latent_cache).

    The attention runs over slices of the batch, each through chunked
    attention on its own up-projected K and V, so that no fp32 block of
    scores holds more than ``MLA_SCORE_BYTES`` (DeepSeek-V3 at 256 x 512:
    16 sequences a slice, not one 34 GB block); a batch that fits is one
    slice."""
    m = cfg.mla
    q_nope, q_rope = _mla_q(p, x, positions, cfg)
    q = torch.cat([q_nope, q_rope], dim=-1)
    del q_nope, q_rope
    ckv, k_rope = _mla_latents(p, x, positions, cfg)
    B, S, H = q.shape[:3]                # H: this rank's heads on a mesh
    qc = q_chunk if (S % q_chunk == 0 and S >= q_chunk) else S
    per = max(1, MLA_SCORE_BYTES // (H * qc * S * 4))
    scale = mla_scale(cfg)
    ctx = q.new_empty((B, S, H, m.v_head_dim))
    for b in range(0, B, per):
        c = ckv[b:b + per]
        k_nope = _proj_heads(c, p["w_uk"])
        k = torch.cat([k_nope, k_rope[b:b + per, :, None, :].expand(
            *k_nope.shape[:3], m.qk_rope_head_dim)], dim=-1)
        del k_nope
        ctx[b:b + per] = chunked_attention(
            q[b:b + per], k, _proj_heads(c, p["w_uv"]), causal=True,
            q_chunk=q_chunk, scale=scale)
        del k
    del q
    return _out_proj(ctx, p["w_o"]), {"ckv": ckv, "k_rope": k_rope}


def mla_decode(p: dict, x: torch.Tensor, pos: torch.Tensor, cache: dict,
               cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """Absorbed-form MLA decode: scores and context computed in latent
    space (per step O(S * (kv_lora + rope)) per head, the DeepSeek serving
    formulation), in fp32. ``pos`` is a one-element int64 tensor on x's
    device, read on the device only, as ``attn_decode`` reads it. cache:
    {ckv: (B, S, r), k_rope: (B, S, rope)}, written at ``pos`` in place
    and returned. Rope (YaRN's where ``cfg.rope_scaling``) and the scale
    (``mla_scale``) are prefill's."""
    positions = pos.expand(x.shape[0], 1)
    q_nope, q_rope = _mla_q(p, x, positions, cfg)          # (B,1,H,*)
    ckv_new, krope_new = _mla_latents(p, x, positions, cfg)
    ckv, k_rope = cache["ckv"], cache["k_rope"]
    ckv.index_copy_(1, pos, ckv_new.to(ckv.dtype))
    k_rope.index_copy_(1, pos, krope_new.to(k_rope.dtype))
    S = ckv.shape[1]
    # absorb W_uk into q: (B,1,H,nope) x (r,H,nope) -> (B,1,H,r)
    q_abs = torch.einsum("bshk,rhk->bshr", q_nope, p["w_uk"].to(x.dtype))
    scores = (torch.einsum("bshr,bkr->bhsk", q_abs.float(), ckv.float())
              + torch.einsum("bshr,bkr->bhsk", q_rope.float(),
                             k_rope.float()))
    scores = scores * mla_scale(cfg)
    valid = torch.arange(S, device=x.device) <= pos
    scores = torch.where(valid[None, None, None, :], scores, NEG_INF)
    pr = torch.softmax(scores, dim=-1)
    ctx_lat = torch.einsum("bhsk,bkr->bshr", pr, ckv.float())
    out_h = torch.einsum("bshr,rhv->bshv", ctx_lat.to(x.dtype),
                         p["w_uv"].to(x.dtype))
    return _out_proj(out_h, p["w_o"]), cache
