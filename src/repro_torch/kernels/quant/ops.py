"""Public wrappers for the page quantize/dequantize kernels (K4, K5).

On CUDA tensors they launch the hand-written Hopper kernels
(``csrc/quant_pages.cu``) on the current stream, or raise; on CPU tensors
they run the plain versions in ``ref.py``. The flat blockwise
``quantize``/``dequantize`` of the reference (used by gradient compression)
are not ported yet.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import (count_launch, launch, load_library,
                                 use_kernel)
from repro_torch.kernels.quant.ref import (dequantize_pages_ref,
                                           quantize_pages_ref)

LIBRARY = "quant"
SOURCES = [Path(__file__).resolve().parent / "csrc" / "quant_pages.cu"]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _library() -> ctypes.CDLL:
    lib = load_library(LIBRARY, SOURCES)
    # x/q, q/scales, scales/out; dtype, n_pages, page, hkv, d; stream
    for fn in (lib.repro_quantize_pages, lib.repro_dequantize_pages):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + \
            [ctypes.c_void_p]
    return lib


def _check_pool(name: str, t: torch.Tensor) -> None:
    if t.dim() != 4:
        raise ValueError(f"{name} must be (n_pages, page, Hkv, d); got "
                         f"shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous; strides {t.stride()}")


def quantize_pages(pages: torch.Tensor):
    """Per-(page, kv_head) int8 quantization of a KV page pool:
    (n_pages, page, Hkv, d) f32/bf16 -> (q int8 same shape,
    scales f32 (n_pages, Hkv))."""
    if not use_kernel(pages):
        return quantize_pages_ref(pages)
    _check_pool("pages", pages)
    if pages.dtype not in _DTYPES:
        raise TypeError(f"quantize_pages kernel takes float32 or bfloat16 "
                        f"pages; got {pages.dtype}")
    n_pages, page, hkv, d = pages.shape
    q = torch.empty(pages.shape, dtype=torch.int8, device=pages.device)
    scales = torch.empty((n_pages, hkv), dtype=torch.float32,
                         device=pages.device)
    if pages.numel() == 0:
        return q, scales
    launch(_library().repro_quantize_pages, pages.data_ptr(), q.data_ptr(),
            scales.data_ptr(), _DTYPES[pages.dtype], n_pages, page, hkv, d,
            device=pages.device)
    count_launch("quantize_pages")
    return q, scales


def dequantize_pages(q: torch.Tensor, scales: torch.Tensor,
                     out_dtype=None) -> torch.Tensor:
    """Inverse of ``quantize_pages``: (q int8 pool, (n_pages, Hkv) scales)
    -> pool of the same shape in ``out_dtype`` (default float32)."""
    out_dtype = torch.float32 if out_dtype is None else out_dtype
    if isinstance(out_dtype, str):
        out_dtype = getattr(torch, out_dtype)
    if not use_kernel(q, scales):
        return dequantize_pages_ref(q, scales, out_dtype)
    _check_pool("q", q)
    n_pages, page, hkv, d = q.shape
    if q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"dequantize_pages kernel takes int8 q and float32 "
                        f"scales; got {q.dtype}, {scales.dtype}")
    if tuple(scales.shape) != (n_pages, hkv) or not scales.is_contiguous():
        raise ValueError(f"scales must be contiguous ({n_pages}, {hkv}); "
                         f"got {tuple(scales.shape)}, strides "
                         f"{scales.stride()}")
    if out_dtype not in _DTYPES:
        raise TypeError(f"dequantize_pages kernel writes float32 or "
                        f"bfloat16; got {out_dtype}")
    if q.device != scales.device:
        raise ValueError(f"q on {q.device}, scales on {scales.device}")
    out = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    if q.numel() == 0:
        return out
    launch(_library().repro_dequantize_pages, q.data_ptr(),
            scales.data_ptr(), out.data_ptr(), _DTYPES[out_dtype], n_pages,
            page, hkv, d, device=q.device)
    count_launch("dequantize_pages")
    return out


__all__ = ["quantize_pages", "dequantize_pages", "quantize_pages_ref",
           "dequantize_pages_ref"]
