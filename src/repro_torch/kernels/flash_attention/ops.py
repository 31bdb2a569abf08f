"""Public wrapper for the flash attention kernel.

On CUDA tensors it launches the hand-written Hopper kernel
(``csrc/flash_attention.cu``) on the current stream, or raises; on CPU
tensors it runs the plain version in ``ref.py``. Model code selects it via
``ParallelConfig.attention_kernel == "kernel"``.

The wrapper is the custom op ``repro_torch::flash_attention``: under
``FakeTensorMode`` (the dry-run) its fake gives the output's shape and
strides without touching memory, and its FLOP formula lets a FLOP counter
(``torch.utils.flop_counter``, the roofline walker) see the kernel's work.
The mesh path calls it on each rank's local heads.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import (count_launch, launch, load_library,
                                 use_kernel)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

LIBRARY = "flash_attention"
SOURCES = [Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"]
# The head dims the kernel takes: any multiple of 8 up to 128, in fp32 and
# bf16. It runs the instantiation for 16, 32, 64 or 128 (fp32) or 64 or 128
# (bf16) that rounds d up, with the extra columns zero; a multiple of 8
# keeps a bf16 row a whole number of the 16-byte pieces its copies and
# stores move. The reference's Pallas kernel takes any d; above 128 the
# tiles of one item would not fit in shared memory.
MAX_HEAD_DIM = 128


def takes_head_dim(d: int) -> bool:
    return 0 < d <= MAX_HEAD_DIM and d % 8 == 0
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
    if not takes_head_dim(d):
        raise ValueError(f"head dim {d}: the kernel takes a multiple of 8 "
                         f"up to {MAX_HEAD_DIM}")
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


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, window: int, scale: float
                        ) -> torch.Tensor:
    if not use_kernel(q, k, v):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)
    _check(q, k, v, window)
    B, Hq, Sq, d = q.shape
    _, Hkv, Skv, _ = k.shape
    out = torch.empty_like(q)
    launch(_library().repro_flash_attention_fwd, q.data_ptr(), k.data_ptr(),
           v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype], B, Hq, Hkv, Sq,
           Skv, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
           *out.stride()[:3], float(scale), int(bool(causal)), int(window),
           device=q.device)
    count_launch("flash_attention")
    if window:
        count_launch("flash_attention_windowed")
    return out


@_flash_attention_op.register_fake
def _flash_attention_fake(q, k, v, causal, window, scale):
    if q.device.type == "cuda":
        _check(q, k, v, window)
    # the kernel's output: torch.empty_like(q), q's strides
    return torch.empty_like(q)


@functools.lru_cache(maxsize=64)
def attended_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask lets through: the work the kernel does
    (it skips masked tiles; the count is exact, not rounded to tiles)."""
    total = 0
    for i in range(Sq) if (causal or window) else ():
        hi = min(i, Skv - 1) if causal else Skv - 1
        lo = max(0, i - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total if (causal or window) else Sq * Skv


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_attention_flops(q_shape, k_shape, v_shape, causal, window,
                           scale, *args, **kwargs) -> int:
    """2 * d FLOPs for each score and each context product, per attended
    (query, key) pair and query head."""
    B, Hq, Sq, d = q_shape
    return 4 * B * Hq * d * attended_pairs(Sq, k_shape[2], causal, window)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """q: (B, Hq, Sq, d); k, v: (B, Hkv, Skv, d) -> (B, Hq, Sq, d).

    Any strides with a contiguous last dim are read in place; on CUDA the
    output has q's strides (so a (B, S, H, d) tensor viewed as (B, H, S, d)
    comes back in the same layout).
    """
    use_kernel(q, k, v)          # raises for inputs on mixed devices
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return _flash_attention_op(q, k, v, bool(causal), int(window),
                               float(scale))


__all__ = ["flash_attention", "flash_attention_ref"]
