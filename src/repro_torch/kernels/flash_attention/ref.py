"""Plain PyTorch version of the flash attention kernel."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        scale: float | None = None) -> torch.Tensor:
    """q: (B, Hq, Sq, d); k, v: (B, Hkv, Skv, d) -> (B, Hq, Sq, d).

    GQA via head grouping (Hq % Hkv == 0). Mask semantics match
    ``repro_torch.models.attention.chunked_attention``: causal, and
    optionally a sliding window of ``window`` keys inclusive of self.
    Scores, softmax and context are fp32; the output is in q's dtype.
    """
    B, Hq, Sq, d = q.shape
    _, Hkv, Skv, _ = k.shape
    G = Hq // Hkv
    scale = d ** -0.5 if scale is None else scale
    qg = q.reshape(B, Hkv, G, Sq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float()) * scale
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return out.reshape(B, Hq, Sq, d).to(q.dtype)
