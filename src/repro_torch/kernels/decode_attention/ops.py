"""Public wrapper for the dense GQA decode attention kernel (K8).

On CUDA tensors it launches the hand-written Hopper kernel
(``csrc/decode_attention.cu``) on the current stream, or raises; on CPU
tensors it runs the plain version in ``ref.py``. The model's decode
(``models/attention.attn_decode``, ``attn_decode_cross``) calls it on every
GQA layer; the mesh path (``models/tp.py``) keeps the plain function.

The kernel reads the (B, S, Hkv, d) layer view of the cache in place by its
batch and sequence strides (the last two dims contiguous) and the step's
position on the device: it attends to the first ``min(pos + 1, S)`` keys,
or to all S where ``pos`` is None. Nothing here reads ``pos`` on the host
or syncs, so a CUDA graph captured around a call replays at any position.

A call is flash-decoding: a split kernel whose block s of a (sequence, kv
head) attends over keys ``[s * per, s * per + per)`` and, where a sequence
is cut into more than one range, a combine kernel that merges the fp32
partials by log-sum-exp. ``split_plan`` picks (split, per) from the shapes
and the SM count alone.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import (count_launch, launch, load_library,
                                 use_kernel)
from repro_torch.kernels.decode_attention.ref import (
    dense_decode_attention_ref)

LIBRARY = "decode_attention"
SOURCES = [Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# blocks an SM holds at once (the kernel's launch bounds); the plan fills
# the card in one wave
BLOCKS_PER_SM = 2
MIN_KEYS = 64         # keys a block takes at least: one tile
MAX_G = 16            # query heads a kv head serves (the kernel's rows)
MAX_HEAD_DIM = 256


def split_plan(B: int, Hkv: int, S: int, sms: int) -> tuple[int, int]:
    """(split, per): each of the B * Hkv (sequence, kv head) pairs is cut
    into ``split`` blocks of ``per`` keys, block s taking keys
    ``[s * per, min(s * per + per, S))``: as many blocks as fit on the card
    at once, at least ``MIN_KEYS`` keys a block, and no block without a
    key."""
    split = max(1, min(S // MIN_KEYS, BLOCKS_PER_SM * sms // (B * Hkv)))
    per = -(-S // split)
    return -(-S // per), per


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _library() -> ctypes.CDLL:
    lib = load_library(LIBRARY, SOURCES)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = lib.repro_decode_attention
    fn.restype = i32
    # q, k, v, pos, o, ws; dtype, B, Hq, Hkv, D, S; k_sb, k_ss, v_sb, v_ss;
    # split, per; scale; stream
    fn.argtypes = ([ptr] * 6 + [i32] * 6 + [i64] * 4 + [i32] * 2
                   + [ctypes.c_float, ptr])
    return lib


def _check(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
           pos: Optional[torch.Tensor]) -> tuple:
    """Shapes (B, Hq, Hkv, d, S) of a call the kernel takes, or raise."""
    tensors = {"q": q, "k_cache": k_cache, "v_cache": v_cache}
    if pos is not None:
        tensors["pos"] = pos
    if len({t.device for t in tensors.values()}) != 1:
        raise ValueError(f"inputs on different devices: "
                         f"{ {n: str(t.device) for n, t in tensors.items()} }")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype or \
            v_cache.dtype != q.dtype:
        raise TypeError(f"q, k_cache and v_cache must share one dtype of "
                        f"float32, bfloat16; got {q.dtype}, {k_cache.dtype}, "
                        f"{v_cache.dtype}")
    if pos is not None and (pos.dtype != torch.int64 or pos.numel() != 1):
        raise TypeError(f"pos must be one int64; got {pos.dtype} "
                        f"{tuple(pos.shape)}")
    if q.dim() != 4 or q.shape[1] != 1 or k_cache.dim() != 4 or \
            v_cache.shape != k_cache.shape:
        raise ValueError(f"expected q (B, 1, Hq, d) and caches (B, S, Hkv, "
                         f"d); got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, _, Hq, d = q.shape
    Bk, S, Hkv, dk = k_cache.shape
    if Bk != B or dk != d or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)} (need equal B and d, "
                         f"Hq % Hkv == 0)")
    # G: the kernel's accumulator rows; d: whole 16-byte pieces of a bf16 row
    if not (Hq // Hkv <= MAX_G and 0 < d <= MAX_HEAD_DIM and d % 8 == 0):
        raise ValueError(f"G = {Hq // Hkv} query heads a kv head at head dim "
                         f"{d}: the kernel takes G up to {MAX_G} and d a "
                         f"multiple of 8 up to {MAX_HEAD_DIM}")
    if S == 0 or B == 0 or B > 65535 or Hkv > 65535 or S >= 2 ** 31:
        raise ValueError(f"caches {tuple(k_cache.shape)}: need 1 <= B <= "
                         f"65535, Hkv <= 65535 and 1 <= S < 2**31")
    if not q.is_contiguous():
        raise ValueError(f"q must be contiguous; strides {q.stride()}")
    size = k_cache.element_size()
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.stride(3) != 1 or t.stride(2) != d:
            raise ValueError(f"{name} must have contiguous (Hkv, d) rows; "
                             f"strides {t.stride()}")
        if t.data_ptr() % 16 or (t.stride(0) * size) % 16 or \
                (t.stride(1) * size) % 16:
            raise ValueError(f"{name}'s rows must start on 16 bytes (the "
                             f"kernel copies them in 16-byte pieces); "
                             f"strides {t.stride()}")
    if q.data_ptr() % 16:
        raise ValueError("q must start on 16 bytes")
    return B, Hq, Hkv, d, S


def dense_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor,
                           pos: Optional[torch.Tensor] = None, *,
                           scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, 1, Hq, d); caches: (B, S, Hkv, d), float32 or bfloat16 (on
    CUDA q's dtype; the plain version casts them to it); pos: a one-element
    int64 tensor, the step's position (keys ``[0, min(pos + 1, S))`` are
    live), or None (all S) -> (B, 1, Hq, d) in q's dtype."""
    extra = (pos,) if pos is not None else ()
    if not use_kernel(q, k_cache, v_cache, *extra):
        return dense_decode_attention_ref(q, k_cache, v_cache, pos, scale)
    B, Hq, Hkv, d, S = _check(q, k_cache, v_cache, pos)
    scale = d ** -0.5 if scale is None else scale
    split, per = split_plan(B, Hkv, S, _sm_count(q.device.index))
    ws = (torch.empty(B * Hq * split * (d + 2), dtype=torch.float32,
                      device=q.device) if split > 1 else None)
    out = torch.empty_like(q)
    launch(_library().repro_decode_attention, q.data_ptr(),
           k_cache.data_ptr(), v_cache.data_ptr(),
           pos.data_ptr() if pos is not None else None, out.data_ptr(),
           ws.data_ptr() if ws is not None else None,
           _DTYPES[q.dtype], B, Hq, Hkv, d, S,
           k_cache.stride(0), k_cache.stride(1), v_cache.stride(0),
           v_cache.stride(1), split, per, float(scale), device=q.device)
    count_launch("decode_attention")
    return out


__all__ = ["dense_decode_attention", "dense_decode_attention_ref"]
