"""Public wrapper for the flash attention kernel.

On CUDA tensors it launches the hand-written Hopper kernel
(``csrc/flash_attention.cu``) on the current stream, or raises; on CPU
tensors it runs the plain version in ``ref.py``. Model code selects it via
``ParallelConfig.attention_kernel == "kernel"``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import (count_launch, launch, load_library,
                                 use_kernel)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

LIBRARY = "flash_attention"
SOURCES = [Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"]
HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT32_MAX = 2**31 - 1


def _library() -> ctypes.CDLL:
    lib = load_library(LIBRARY, SOURCES)
    fn = lib.repro_flash_attention_fwd
    fn.restype = ctypes.c_int
    # q, k, v, o; dtype, B, Hq, Hkv, Sq, Skv, d and 12 strides; scale,
    # causal, window; stream
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 19
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int) -> None:
    if q.device != k.device or q.device != v.device:
        raise ValueError(f"q, k, v on different devices: "
                         f"{q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16 "
                        f"q, k, v of one dtype; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B,Hq,Sq,d) and k, v (B,Hkv,Skv,d); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Hq, Sq, d = q.shape
    Bk, Hkv, Skv, dk = k.shape
    if Bk != B or dk != d or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)} (need equal B and d, "
                         f"Hq % Hkv == 0)")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if Sq == 0 or Skv == 0:
        raise ValueError("empty sequence")
    if window < 0:
        raise ValueError(f"window={window} < 0")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have a contiguous last dim; "
                             f"strides {t.stride()}")
        if max(t.stride()) > _INT32_MAX:
            raise ValueError(f"{name} strides {t.stride()} exceed int32")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """q: (B, Hq, Sq, d); k, v: (B, Hkv, Skv, d) -> (B, Hq, Sq, d).

    Any strides with a contiguous last dim are read in place; the output has
    q's strides (so a (B, S, H, d) tensor viewed as (B, H, S, d) comes back
    in the same layout).
    """
    if not use_kernel(q, k, v):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)
    _check(q, k, v, window)
    B, Hq, Sq, d = q.shape
    _, Hkv, Skv, _ = k.shape
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    launch(_library().repro_flash_attention_fwd, q.data_ptr(), k.data_ptr(),
           v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype], B, Hq, Hkv, Sq,
           Skv, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
           *out.stride()[:3], float(scale), int(bool(causal)), int(window),
           device=q.device)
    count_launch("flash_attention")
    return out


__all__ = ["flash_attention", "flash_attention_ref"]
