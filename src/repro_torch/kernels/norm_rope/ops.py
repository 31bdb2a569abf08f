"""Public wrappers for the RMS norm (K9) and rope (K10) kernels.

On CUDA tensors each launches its hand-written Hopper kernel
(``csrc/norm_rope.cu``) on the current stream, or raises; on CPU tensors
it runs the plain version in ``ref.py``. Each is a custom op
(``repro_torch::rmsnorm``, ``::add_rmsnorm``, ``::rope``) whose fake gives
the kernel's output shapes and strides under ``FakeTensorMode`` (the
dry-run). They have no backward: the model's layers call them only where
no gradient is being recorded (``models/layers.py``).

* ``rmsnorm(x, w, eps)``: the normed rows of x (..., n), in x's dtype.
* ``add_rmsnorm(x, a, w, eps)``: ``(s, rmsnorm(s))`` with s = x + a
  rounded to x's dtype, the residual add and the norm in one pass.
* ``rope(q, k, positions, freqs, sections)``: q (B, S, Hq, D) and k (B, S,
  Hkv, D) (or None) turned at positions (B, S), or (3, B, S) with M-RoPE's
  ``sections``, in one launch; read by their (B, S, H) strides with D
  contiguous, written as new contiguous tensors. The positions are read on
  the device, by their strides, so a CUDA graph captured around a call
  replays at any position.

Each shape picks its launch from what it sees (row width, head count and
dim, alignment, strides); nothing names a model.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import (count_launch, launch, load_library,
                                 use_kernel)
from repro_torch.kernels.norm_rope.ref import (add_rmsnorm_ref, rmsnorm_ref,
                                               rope_ref)

LIBRARY = "norm_rope"
SOURCES = [Path(__file__).resolve().parent / "csrc" / "norm_rope.cu"]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_POS_DTYPES = {torch.int32: 0, torch.int64: 1}
MAX_ROW_THREADS = 1024
ROW_BLOCK = 256          # threads a block of K9 gathers rows into
ROPE_THREADS = 256       # threads of K10's block (one token) at most


def _chunks(vec: bool) -> int:
    """Chunks (16-byte vectors, or single elements off the vector path) a
    K9 thread holds: the kernel's CH."""
    return 4 if vec else 8


def _library() -> ctypes.CDLL:
    lib = load_library(LIBRARY, SOURCES)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    norm = lib.repro_rmsnorm
    norm.restype = i32
    # x, a, w, out, sum; dtype, wdtype, vec; rows, n, x_rs, a_rs; tpr, rpb;
    # eps, inv_n; stream
    norm.argtypes = ([ptr] * 5 + [i32] * 3 + [i64, i32, i64, i64]
                     + [i32] * 2 + [ctypes.c_float] * 2 + [ptr])
    rope = lib.repro_rope
    rope.restype = i32
    # q, k, qo, ko, pos, freqs; dtype, pos_i64, vec; tokens; S, Hq, Hkv,
    # half; 9 strides; sec0, sec1, threads; stream
    rope.argtypes = ([ptr] * 6 + [i32] * 3 + [i64] + [i32] * 4 + [i64] * 9
                     + [i32] * 3 + [ptr])
    return lib


def _aligned(*vals: int) -> bool:
    return all(v % 16 == 0 for v in vals)


# --------------------------------------------------------------------------
# K9
# --------------------------------------------------------------------------


def norm_plan(n: int, size: int, vec: bool) -> tuple[int, int]:
    """(tpr, rpb): threads a row (a multiple of 32, each holding at most
    ``_chunks`` chunks) and rows a block, for rows of ``n`` elements of
    ``size`` bytes cut into 16-byte chunks (``vec``) or single elements."""
    nchunk = n // (16 // size) if vec else n
    tpr = 32 * -(-nchunk // (32 * _chunks(vec)))
    if tpr > MAX_ROW_THREADS:
        raise ValueError(f"rows of {n} elements: K9 holds at most "
                         f"{MAX_ROW_THREADS * _chunks(vec)} chunks a row")
    return tpr, max(1, ROW_BLOCK // tpr)


def _rows(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t`` as (rows, n), a view where the leading dims allow one."""
    t = t.reshape(-1, n)
    return t if t.stride(1) == 1 else t.contiguous()


def _check_norm(x: torch.Tensor, w: torch.Tensor,
                a: Optional[torch.Tensor]) -> None:
    ts = [x, w] + ([a] if a is not None else [])
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"inputs on different devices: "
                         f"{[str(t.device) for t in ts]}")
    if x.dtype not in _DTYPES or w.dtype not in _DTYPES:
        raise TypeError(f"K9 takes float32 or bfloat16 x and w; got "
                        f"{x.dtype}, {w.dtype}")
    if a is not None and (a.dtype != x.dtype or a.shape != x.shape):
        raise ValueError(f"the residual add needs a of x's dtype and shape; "
                         f"got {a.dtype} {tuple(a.shape)} and {x.dtype} "
                         f"{tuple(x.shape)}")
    if x.dim() == 0 or w.shape != (x.shape[-1],):
        raise ValueError(f"w must be (n,) for x (..., n); got "
                         f"{tuple(w.shape)}, {tuple(x.shape)}")
    if x.numel() == 0:
        raise ValueError("empty x")


def _norm(x: torch.Tensor, a: Optional[torch.Tensor], w: torch.Tensor,
          eps: float) -> tuple[Optional[torch.Tensor], torch.Tensor]:
    """(s or None, the normed rows) from one K9 launch."""
    _check_norm(x, w, a)
    n = x.shape[-1]
    x2 = _rows(x, n)
    a2 = _rows(a, n) if a is not None else None
    w = w.contiguous()
    size = x.element_size()
    vec = (n * size) % 16 == 0 and _aligned(
        x2.data_ptr(), x2.stride(0) * size, w.data_ptr(),
        *((a2.data_ptr(), a2.stride(0) * size) if a2 is not None else ()))
    tpr, rpb = norm_plan(n, size, vec)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    s = torch.empty_like(out) if a is not None else None
    rows = x2.shape[0]
    launch(_library().repro_rmsnorm, x2.data_ptr(),
           a2.data_ptr() if a2 is not None else None, w.data_ptr(),
           out.data_ptr(), s.data_ptr() if s is not None else None,
           _DTYPES[x.dtype], _DTYPES[w.dtype], int(vec), rows, n,
           x2.stride(0), a2.stride(0) if a2 is not None else 0, tpr, rpb,
           float(eps), float(np.float32(1) / np.float32(n)),
           device=x.device)
    count_launch("rmsnorm" if a is None else "add_rmsnorm")
    return s, out


@torch.library.custom_op("repro_torch::rmsnorm", mutates_args=())
def _rmsnorm_op(x: torch.Tensor, w: torch.Tensor, eps: float
                ) -> torch.Tensor:
    if not use_kernel(x, w):
        return rmsnorm_ref(x, w, eps)
    return _norm(x, None, w, eps)[1]


@_rmsnorm_op.register_fake
def _rmsnorm_fake(x, w, eps):
    _check_norm(x, w, None)
    return x.new_empty(x.shape)


@torch.library.custom_op("repro_torch::add_rmsnorm", mutates_args=())
def _add_rmsnorm_op(x: torch.Tensor, a: torch.Tensor, w: torch.Tensor,
                    eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    if not use_kernel(x, a, w):
        return add_rmsnorm_ref(x, a, w, eps)
    return _norm(x, a, w, eps)


@_add_rmsnorm_op.register_fake
def _add_rmsnorm_fake(x, a, w, eps):
    _check_norm(x, w, a)
    return x.new_empty(x.shape), x.new_empty(x.shape)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """x (..., n), w (n,) -> rmsnorm(x) * w in x's dtype (fp32 inside)."""
    use_kernel(x, w)             # raises for inputs on mixed devices
    return _rmsnorm_op(x, w, float(eps))


def add_rmsnorm(x: torch.Tensor, a: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """(x + a, rmsnorm(x + a) * w), the sum rounded to x's dtype first."""
    use_kernel(x, a, w)
    return _add_rmsnorm_op(x, a, w, float(eps))


# --------------------------------------------------------------------------
# K10
# --------------------------------------------------------------------------


def _check_rope(q: torch.Tensor, k: Optional[torch.Tensor],
                positions: torch.Tensor, freqs: torch.Tensor,
                sections: list[int]) -> None:
    ts = {"q": q, "positions": positions, "freqs": freqs}
    if k is not None:
        ts["k"] = k
    if len({t.device for t in ts.values()}) != 1:
        raise ValueError(f"inputs on different devices: "
                         f"{ {n: str(t.device) for n, t in ts.items()} }")
    if q.dtype not in _DTYPES or (k is not None and k.dtype != q.dtype):
        raise TypeError(f"K10 takes float32 or bfloat16 q and k of one "
                        f"dtype; got {q.dtype}, "
                        f"{None if k is None else k.dtype}")
    if positions.dtype not in _POS_DTYPES or freqs.dtype != torch.float32:
        raise TypeError(f"positions must be int32 or int64 and freqs "
                        f"float32; got {positions.dtype}, {freqs.dtype}")
    if q.dim() != 4 or q.shape[-1] % 2 or q.shape[-1] == 0:
        raise ValueError(f"q must be (B, S, H, D) with D even; got "
                         f"{tuple(q.shape)}")
    B, S, _, D = q.shape
    if k is not None and (k.dim() != 4 or k.shape[:2] != (B, S) or
                          k.shape[-1] != D):
        raise ValueError(f"k must be (B, S, Hkv, D) of q's B, S and D; got "
                         f"{tuple(k.shape)} for q {tuple(q.shape)}")
    if freqs.shape != (D // 2,):
        raise ValueError(f"freqs must be ({D // 2},); got "
                         f"{tuple(freqs.shape)}")
    want = (3, B, S) if sections else (B, S)
    if sections and (len(sections) != 3 or sum(sections) != D // 2):
        raise ValueError(f"M-RoPE takes 3 sections summing to {D // 2}; "
                         f"got {sections}")
    if positions.dim() != len(want) or any(
            p not in (1, w) for p, w in zip(positions.shape, want)):
        raise ValueError(f"positions {tuple(positions.shape)} do not "
                         f"broadcast to {want}")
    for name, t in (("q", q), ("k", k)):
        if t is not None and t.stride(-1) != 1:
            raise ValueError(f"{name} must have a contiguous last dim; "
                             f"strides {t.stride()}")


def _rope_outputs(q, k) -> list[torch.Tensor]:
    return [torch.empty(t.shape, dtype=t.dtype, device=t.device)
            for t in (q, k) if t is not None]


@torch.library.custom_op("repro_torch::rope", mutates_args=())
def _rope_op(q: torch.Tensor, k: Optional[torch.Tensor],
             positions: torch.Tensor, freqs: torch.Tensor,
             sections: list[int]) -> list[torch.Tensor]:
    extra = (k,) if k is not None else ()
    if not use_kernel(q, positions, freqs, *extra):
        return rope_ref(q, k, positions, freqs, sections)
    _check_rope(q, k, positions, freqs, sections)
    B, S, Hq, D = q.shape
    Hkv = k.shape[2] if k is not None else 0
    half = D // 2
    pos = positions.expand((3, B, S) if sections else (B, S))
    p_sr, p_sb, p_ss = (pos.stride() if sections else (0, *pos.stride()))
    outs = _rope_outputs(q, k)
    size = q.element_size()
    ins = [q] + ([k] if k is not None else [])
    vec = (half * size) % 16 == 0 and _aligned(
        *(t.data_ptr() for t in ins),
        *(st * size for t in ins for st in t.stride()[:3]))
    per = half // (16 // size) if vec else half
    threads = min(ROPE_THREADS, 32 * -(-((Hq + Hkv) * per) // 32))
    sec0, sec1 = (sections[0], sections[1]) if sections else (half, 0)
    ks = k.stride()[:3] if k is not None else (0, 0, 0)
    launch(_library().repro_rope, q.data_ptr(),
           k.data_ptr() if k is not None else None, outs[0].data_ptr(),
           outs[1].data_ptr() if k is not None else None, pos.data_ptr(),
           freqs.data_ptr(), _DTYPES[q.dtype],
           _POS_DTYPES[positions.dtype], int(vec), B * S, S, Hq, Hkv, half,
           *q.stride()[:3], *ks, p_sr, p_sb, p_ss, sec0, sec1, threads,
           device=q.device)
    count_launch("rope")
    return outs


@_rope_op.register_fake
def _rope_fake(q, k, positions, freqs, sections):
    _check_rope(q, k, positions, freqs, sections)
    return _rope_outputs(q, k)


def rope(q: torch.Tensor, k: Optional[torch.Tensor], positions: torch.Tensor,
         freqs: torch.Tensor, sections: list[int]
         ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(q, k) turned at ``positions`` by split halves (k None: (q, None));
    ``freqs`` the fp32 inverse frequencies (D / 2,), ``sections`` M-RoPE's
    (t, h, w) split of them, or [] for plain RoPE."""
    extra = (k,) if k is not None else ()
    use_kernel(q, positions, freqs, *extra)
    outs = _rope_op(q, k, positions, freqs, list(sections))
    return outs[0], (outs[1] if k is not None else None)


__all__ = ["add_rmsnorm", "add_rmsnorm_ref", "rmsnorm", "rmsnorm_ref",
           "rope", "rope_ref"]
