"""Plain PyTorch versions of the HEIMDALL probe kernels.

They compute what the reference's jitted probe loops compute
(``repro/heimdall/micro.py``): a dependent chain of loads, a sum, a
scatter-add and an elementwise copy, each on the device its output lives on.
The CPU tests run these; on the card ``chip_smoke.py`` holds each kernel
against them.
"""

from __future__ import annotations

import torch

MODES = ("chase", "sweep")


def wrap_int32(x: int) -> int:
    """``x`` wrapped to int32, as an int32 sum overflows in JAX."""
    return (x + (1 << 31)) % (1 << 32) - (1 << 31)


def pointer_chase_ref(p: torch.Tensor, steps: int,
                      mode: str = "chase") -> int:
    """The final value of a ``steps``-long dependent chain through the
    int32 vector ``p``: ``idx = p[idx]`` from 0 (``chase``; a negative
    index counts from the end and the result is clamped into range, as
    JAX's gather does), or ``acc = acc + p[acc mod n]`` from 0 (``sweep``;
    int32 with wraparound, floor modulo as JAX's ``%``)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}; got {mode!r}")
    flat = p.reshape(-1)
    n = flat.numel()
    if mode == "chase":
        idx = 0
        for _ in range(steps):
            i = idx + n if idx < 0 else idx
            idx = int(flat[min(max(i, 0), n - 1)])
        return idx
    acc = 0
    for _ in range(steps):
        acc = wrap_int32(acc + int(flat[acc % n]))   # Python's % floors
    return acc


def tier_sum_ref(x: torch.Tensor, device) -> torch.Tensor:
    """fp32 sum of ``x``, computed on ``device``."""
    return x.to(device).sum(dtype=torch.float32)


def tier_scatter_add_ref(t: torch.Tensor, idx: torch.Tensor,
                         u: torch.Tensor) -> torch.Tensor:
    """``t[idx] += u`` in place (repeated indices accumulate); a negative
    index counts from the end and one still out of range is dropped, as
    JAX's ``.at[].add`` does. Returns ``t``."""
    n = t.numel()
    i = idx.to(t.device, torch.int64)
    i = torch.where(i < 0, i + n, i)
    keep = (i >= 0) & (i < n)
    t.index_add_(0, i[keep], u.to(t.device)[keep])
    return t


def tier_copy_ref(x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``out = x * 1.0`` on ``out``'s device. Returns ``out``."""
    return out.copy_(x.to(out.device) * 1.0)
