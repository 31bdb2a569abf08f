"""Plain PyTorch versions of the quantize/dequantize kernels.

Symmetric int8 with one fp32 scale per block, as the reference's
``quantize_ref`` / ``dequantize_ref`` (flat 256-element blocks) and
``quantize_pages_ref`` / ``dequantize_pages_ref`` (one block per
(page, kv_head)). The quantizers divide tensor by tensor: PyTorch on CUDA turns a division by a Python scalar into a
multiplication by its reciprocal, which can differ from true division in the
last bit, and the kernels must match these bit for bit.
"""

from __future__ import annotations

import torch


def quantize_ref(x: torch.Tensor, block: int = 256):
    """x: (N,) f32/bf16 with N % block == 0 ->
    (q int8 (N,), scales f32 (N/block,))."""
    blocks = x.float().reshape(-1, block)
    absmax = blocks.abs().amax(dim=1, keepdim=True)
    scales = torch.clamp_min(absmax, 1e-12) / torch.full_like(absmax, 127.0)
    q = torch.clamp(torch.round(blocks / scales), -127, 127).to(torch.int8)
    return q.reshape(-1), scales[:, 0]


def dequantize_ref(q: torch.Tensor, scales: torch.Tensor, block: int = 256
                   ) -> torch.Tensor:
    return (q.reshape(-1, block).float() * scales[:, None]).reshape(-1)


def quantize_pages_ref(pages: torch.Tensor):
    """Per-(page, kv_head) blocks: (n_pages, page, Hkv, d) ->
    (q int8 same shape, scales f32 (n_pages, Hkv))."""
    x = pages.float()
    absmax = x.abs().amax(dim=(1, 3), keepdim=True)
    scales = torch.clamp_min(absmax, 1e-12) / torch.full_like(absmax, 127.0)
    q = torch.clamp(torch.round(x / scales), -127, 127).to(torch.int8)
    return q, scales[:, 0, :, 0].contiguous()


def dequantize_pages_ref(q: torch.Tensor, scales: torch.Tensor,
                         out_dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scales[:, None, :, None]).to(out_dtype)
