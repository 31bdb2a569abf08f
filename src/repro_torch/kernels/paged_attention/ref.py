"""Plain PyTorch versions of the paged decode attention kernels."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, block_table: torch.Tensor,
                        seq_lens: torch.Tensor,
                        scale: float | None = None) -> torch.Tensor:
    """Decode attention over paged KV.

    q:           (B, Hq, d) — one query token per sequence
    k/v_pages:   (n_pages, page_size, Hkv, d) — the global page pool
    block_table: (B, pages_per_seq) int32 — page ids per sequence
    seq_lens:    (B,) int32 — valid token count per sequence
    returns      (B, Hq, d) in q's dtype
    """
    B, Hq, d = q.shape
    n_pages, page, Hkv, _ = k_pages.shape
    G = Hq // Hkv
    scale = d ** -0.5 if scale is None else scale
    bt = block_table.long()
    k_seq = k_pages[bt].reshape(B, -1, Hkv, d)
    v_seq = v_pages[bt].reshape(B, -1, Hkv, d)
    S = k_seq.shape[1]
    qg = q.reshape(B, Hkv, G, d)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k_seq.float()) * scale
    valid = (torch.arange(S, device=q.device)[None, :]
             < seq_lens.to(q.device)[:, None])[:, None, None, :]
    s = torch.where(valid, s, NEG_INF)
    # masked softmax with a safe denominator: a zero-length sequence (its
    # padded block-table row may alias live pages) gets an all-zero row
    p = torch.where(valid, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    denom = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(denom == 0.0, 1.0, denom)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_seq.float())
    return out.reshape(B, Hq, d).to(q.dtype)


def paged_attention_quant_ref(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor, k_scales: torch.Tensor,
                              v_scales: torch.Tensor,
                              block_table: torch.Tensor,
                              seq_lens: torch.Tensor,
                              scale: float | None = None) -> torch.Tensor:
    """The int8 path: dequantize the pools (per-(page, head) scales), then
    the fp version."""
    kf = k_pages.float() * k_scales[:, None, :, None]
    vf = v_pages.float() * v_scales[:, None, :, None]
    return paged_attention_ref(q, kf, vf, block_table, seq_lens, scale)
