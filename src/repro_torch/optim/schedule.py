"""Learning-rate schedules, in fp32 as the reference computes them.

Each returns a 0-dim fp32 CPU tensor, so the optimizer can scale a CUDA
tensor by it without a host-device copy.
"""

from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, min_ratio: float = 0.1) -> torch.Tensor:
    step = _f32(step)
    warm = peak_lr * step / max(1.0, warmup_steps)
    frac = torch.clamp((step - warmup_steps)
                       / max(1.0, total_steps - warmup_steps), 0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio)
                     * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup_steps, warm, cos)


def constant(step, *, peak_lr: float, **_) -> torch.Tensor:
    return torch.full_like(_f32(step), peak_lr)
