"""Plain PyTorch version of the dense decode attention kernel, and the GQA
einsums that the model's chunked attention and the mesh path share with
it."""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B, Sq, Hkv, G, dh), k: (B, Sk, Hkv, dh) -> fp32 (B, Hkv, G, Sq, Sk)."""
    return torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float())


def _gqa_ctx(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p: (B, Hkv, G, Sq, Sk), v: (B, Sk, Hkv, dh) -> (B, Sq, Hkv, G, dh)."""
    return torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(p.dtype))


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, valid_mask: torch.Tensor,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, 1, Hq, dh); caches: (B, S, Hkv, dh); valid_mask: (S,) or (B,S)."""
    B, _, Hq, dh = q.shape
    _, S, Hkv, _ = k_cache.shape
    G = Hq // Hkv
    scale = scale if scale is not None else dh ** -0.5
    qg = q.reshape(B, 1, Hkv, G, dh)
    scores = _gqa_scores(qg, k_cache) * scale        # (B,Hkv,G,1,S)
    if valid_mask.dim() == 1:
        valid_mask = valid_mask[None, :]
    scores = torch.where(valid_mask[:, None, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    ctx = _gqa_ctx(p, v_cache)
    return ctx.reshape(B, 1, Hq, dh).to(q.dtype)


def live_mask(S: int, pos: Optional[torch.Tensor],
              device: torch.device) -> torch.Tensor:
    """(S,) bool: the keys a decode step at ``pos`` attends to, the first
    ``min(pos + 1, S)`` slots (a ring cache that has wrapped has all S
    live); every slot where ``pos`` is None (cross-attention)."""
    if pos is None:
        return torch.ones(S, dtype=torch.bool, device=device)
    valid = torch.arange(S, device=device) <= pos
    valid |= pos >= S
    return valid


def dense_decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor,
                               pos: Optional[torch.Tensor] = None,
                               scale: Optional[float] = None) -> torch.Tensor:
    """The kernel's function: ``decode_attention`` over the caches cast to
    q's dtype, masked to the live keys ``live_mask`` gives."""
    valid = live_mask(k_cache.shape[1], pos, q.device)
    return decode_attention(q, k_cache.to(q.dtype), v_cache.to(q.dtype),
                            valid, scale)
