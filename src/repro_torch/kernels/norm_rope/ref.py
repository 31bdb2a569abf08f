"""Plain PyTorch versions of the RMS norm (K9) and rope (K10) kernels: the
model's fp32 elementwise chains, op for op as ``models/layers.py`` ran
them before the kernels. The CPU runs these, the training path (which
records gradients) runs them on any device, and the card's tests hold the
kernels to them."""

from __future__ import annotations

from typing import Optional

import torch


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, eps: float
                ) -> torch.Tensor:
    """Computed in fp32, cast back to x's dtype."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * w.float()).to(dtype)


def add_rmsnorm_ref(x: torch.Tensor, a: torch.Tensor, w: torch.Tensor,
                    eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(s, rmsnorm(s)) with s = x + a: the residual add and the norm that
    reads it."""
    s = x + a
    return s, rmsnorm_ref(s, w, eps)


def rope_angles(positions: torch.Tensor, freqs: torch.Tensor,
                sections: list[int]) -> torch.Tensor:
    """fp32 angles (B, S, half) of positions (B, S) and the half-width
    inverse frequencies ``freqs``; with ``sections`` (M-RoPE) positions are
    (3, B, S) and each section of the frequencies turns with its own axis
    (t, h, w)."""
    if not sections:
        return positions[..., None].float() * freqs
    parts, off = [], 0
    for row, sec in enumerate(sections):
        parts.append(positions[row][..., None].float()
                     * freqs[off:off + sec])
        off += sec
    return torch.cat(parts, dim=-1)


def rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D) turned by ``angles`` (B, S, D / 2): split halves, not
    interleaved pairs, in fp32, cast back to x's dtype."""
    cos = torch.cos(angles)[..., None, :]                  # (B, S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope_ref(q: torch.Tensor, k: Optional[torch.Tensor],
             positions: torch.Tensor, freqs: torch.Tensor,
             sections: list[int]) -> list[torch.Tensor]:
    """[q turned] or [q, k turned], both at ``positions``."""
    angles = rope_angles(positions, freqs, sections)
    return [rotate(t, angles) for t in (q, k) if t is not None]
