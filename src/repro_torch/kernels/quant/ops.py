"""Public wrappers for the quantize/dequantize kernels: the flat blockwise
``quantize``/``dequantize`` of gradient compression (K6, K7) and the
per-(page, kv_head) ``quantize_pages``/``dequantize_pages`` of the KV pager
(K4, K5).

On CUDA tensors they launch the hand-written Hopper kernels
(``csrc/quant_pages.cu``) on the current stream, or raise; on CPU tensors
they run the plain versions in ``ref.py``.
"""

from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path

import torch

from repro_torch.kernels import (count_launch, launch, load_library,
                                 use_kernel)
from repro_torch.kernels.quant.ref import (dequantize_pages_ref,
                                           dequantize_ref,
                                           quantize_pages_ref, quantize_ref)

LIBRARY = "quant"
SOURCES = [Path(__file__).resolve().parent / "csrc" / "quant_pages.cu"]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _library() -> ctypes.CDLL:
    lib = load_library(LIBRARY, SOURCES)
    # x, q, scales; dtype, n_pages, page, hkv, d, path, threads, chunks;
    # stream
    fn = lib.repro_quantize_pages
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + \
        [ctypes.c_void_p]
    # q, scales, out; dtype, n_pages, page, hkv, d; stream
    fn = lib.repro_dequantize_pages
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p]
    # x, q, scales; dtype, n; stream
    lib.repro_quantize.restype = ctypes.c_int
    lib.repro_quantize.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    # q, scales, out; n; stream
    lib.repro_dequantize.restype = ctypes.c_int
    lib.repro_dequantize.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_void_p]
    return lib


FLAT_BLOCK = 256          # the block the flat kernels are built for


def _check_flat(name: str, t: torch.Tensor, block: int, align: int) -> None:
    if t.dim() != 1:
        raise ValueError(f"{name} must be 1-D (N,); got shape "
                         f"{tuple(t.shape)}")
    if t.numel() % block:
        raise ValueError(f"{name} has {t.numel()} elements, not a multiple "
                         f"of the block {block}")
    if block != FLAT_BLOCK:
        raise ValueError(f"the flat quant kernels take block={FLAT_BLOCK}; "
                         f"got {block}")
    if not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"{name} must be contiguous and {align}-byte "
                         f"aligned; strides {t.stride()}, address "
                         f"{t.data_ptr():#x}")


def quantize(x: torch.Tensor, block: int = FLAT_BLOCK):
    """Blockwise int8 quantization of a flat array:
    x (N,) f32/bf16, N % block == 0 -> (q int8 (N,), scales f32 (N/block,)).
    The kernel reads bf16 directly and widens in registers."""
    if not use_kernel(x):
        if x.dim() != 1 or x.numel() % block:
            raise ValueError(f"x must be (N,) with N % {block} == 0; got "
                             f"shape {tuple(x.shape)}")
        return quantize_ref(x, block)
    if x.dtype not in _DTYPES:
        raise TypeError(f"quantize kernel takes float32 or bfloat16; got "
                        f"{x.dtype}")
    _check_flat("x", x, block, 16)
    n = x.numel()
    q = torch.empty(n, dtype=torch.int8, device=x.device)
    scales = torch.empty(n // block, dtype=torch.float32, device=x.device)
    if n == 0:
        return q, scales
    launch(_library().repro_quantize, x.data_ptr(), q.data_ptr(),
           scales.data_ptr(), _DTYPES[x.dtype], n, device=x.device)
    count_launch("quantize")
    return q, scales


def dequantize(q: torch.Tensor, scales: torch.Tensor,
               block: int = FLAT_BLOCK) -> torch.Tensor:
    """Inverse of ``quantize``: (q int8 (N,), scales (N/block,)) -> f32
    (N,)."""
    if not use_kernel(q, scales):
        return dequantize_ref(q, scales, block)
    if q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"dequantize kernel takes int8 q and float32 "
                        f"scales; got {q.dtype}, {scales.dtype}")
    _check_flat("q", q, block, 8)
    n = q.numel()
    if tuple(scales.shape) != (n // block,) or not scales.is_contiguous():
        raise ValueError(f"scales must be contiguous ({n // block},); got "
                         f"{tuple(scales.shape)}, strides {scales.stride()}")
    if q.device != scales.device:
        raise ValueError(f"q on {q.device}, scales on {scales.device}")
    out = torch.empty(n, dtype=torch.float32, device=q.device)
    if n == 0:
        return out
    launch(_library().repro_dequantize, q.data_ptr(), scales.data_ptr(),
           out.data_ptr(), n, device=q.device)
    count_launch("dequantize")
    return out


def _check_pool(name: str, t: torch.Tensor) -> None:
    if t.dim() != 4:
        raise ValueError(f"{name} must be (n_pages, page, Hkv, d); got "
                         f"shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous; strides {t.stride()}")


QUANT_THREADS = 256       # threads of a K4 block at most (the kernel's)
VEC_CHUNKS = (1, 2, 4, 8)  # 16-byte chunks a vector-path thread can hold
_PATHS = {"general": 0, "vector": 1}


@dataclasses.dataclass(frozen=True)
class PagesPlan:
    """How K4 covers one (page, head) block of ``page`` d-rows: on the
    vector path thread t of ``threads`` holds the 16-byte chunks
    ``t + k * threads`` for k < ``chunks``, chunk c being d-row
    ``c // chunks_per_row``, elements ``vec * (c % chunks_per_row)`` on; on
    the general path ``QUANT_THREADS`` threads loop over the elements."""
    path: str
    threads: int = QUANT_THREADS
    chunks: int = 0
    vec: int = 1
    chunks_per_row: int = 0


def quantize_pages_plan(shape, dtype: torch.dtype,
                        address: int) -> PagesPlan:
    """K4's path for a contiguous pool of ``shape`` (n_pages, page, Hkv, d)
    and ``dtype`` starting at byte ``address``. The vector path needs whole
    16-byte chunks (d % 8 == 0 in bf16, d % 4 == 0 in fp32), a 16-byte
    aligned pool, a (page, head) block of at most ``QUANT_THREADS`` x 8
    chunks (the registers a thread holds) and a page of fewer than 2^31
    elements; everything else takes the general path."""
    _, page, hkv, d = shape
    vec = 16 // dtype.itemsize
    if d % vec or address % 16 or page * hkv * d >= 2 ** 31:
        return PagesPlan("general")
    cpr = d // vec
    n_chunks = page * cpr
    threads = min(QUANT_THREADS, -(-n_chunks // 32) * 32)
    per = -(-n_chunks // threads)
    chunks = next((c for c in VEC_CHUNKS if c >= per), None)
    if chunks is None:
        return PagesPlan("general")
    return PagesPlan("vector", threads, chunks, vec, cpr)


def quantize_pages(pages: torch.Tensor):
    """Per-(page, kv_head) int8 quantization of a KV page pool:
    (n_pages, page, Hkv, d) f32/bf16 -> (q int8 same shape,
    scales f32 (n_pages, Hkv)). On CUDA tensors the path is
    ``quantize_pages_plan``'s."""
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
    plan = quantize_pages_plan(pages.shape, pages.dtype, pages.data_ptr())
    launch(_library().repro_quantize_pages, pages.data_ptr(), q.data_ptr(),
           scales.data_ptr(), _DTYPES[pages.dtype], n_pages, page, hkv, d,
           _PATHS[plan.path], plan.threads, plan.chunks,
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


__all__ = ["quantize", "dequantize", "quantize_ref", "dequantize_ref",
           "quantize_pages", "dequantize_pages", "quantize_pages_ref",
           "dequantize_pages_ref"]
