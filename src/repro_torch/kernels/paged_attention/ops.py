"""Public wrappers for the paged decode attention kernels (K2, K3).

On CUDA tensors they launch the hand-written Hopper kernels
(``csrc/paged_attention.cu``) on the current stream, or raise; on CPU
tensors they run the plain versions in ``ref.py``. The kernels read the
pool in place, so pools, q, the block table and the lengths must be
contiguous; page ids in the block table must lie in the pool (they are not
checked on the device).

A call is flash-decoding in two kernels: a split kernel whose block s of
(sequence, kv head) attends over pages ``[s * per, s * per + per)`` and
writes fp32 partials (m, l, acc) to a workspace, then a combine kernel that
merges them by log-sum-exp. ``split_plan`` picks (split, per) from the
table width and the SM count alone, never from ``seq_lens``.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import (count_launch, launch, load_library,
                                 use_kernel)
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_quant_ref, paged_attention_ref)

LIBRARY = "paged_attention"
SOURCES = [Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# split-kernel blocks an SM holds at once on the tensor-core path (shared
# memory and registers allow three); the plan fills the card in one wave
BLOCKS_PER_SM = 3
MAX_PER = 256         # table columns a block takes at most (the kernel's)
MAX_HEAD_DIM = 256


def split_plan(B: int, Hkv: int, pps: int, sms: int) -> tuple[int, int]:
    """(split, per): each of the B * Hkv (sequence, kv head) pairs is cut
    into ``split`` blocks of ``per`` table columns, block s taking columns
    ``[s * per, min(s * per + per, pps))``: as many blocks as fit on the
    card at once, at most ``MAX_PER`` columns a block, and no block without
    a column."""
    split = max(1, min(pps, BLOCKS_PER_SM * sms // (B * Hkv)),
                -(-pps // MAX_PER))
    per = -(-pps // split)
    return -(-pps // per), per


def block_pages(s: int, per: int, n_used: int) -> range:
    """The table columns block ``s`` attends over for a sequence whose
    first ``n_used = ceil(seq_len / page)`` columns hold its tokens (the
    split kernel's ``block_range``); empty past them."""
    return range(s * per, min(s * per + per, n_used))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _plan(q: torch.Tensor, Hkv: int, pps: int) -> tuple:
    """(split, per) of a call, and its fp32 workspace: (m, l, acc) for
    every query row and split, B * Hq * split * (d + 2) floats."""
    B, Hq, d = q.shape
    split, per = split_plan(B, Hkv, pps, _sm_count(q.device.index))
    ws = torch.empty(B * Hq * split * (d + 2), dtype=torch.float32,
                     device=q.device)
    return split, per, ws


def _library() -> ctypes.CDLL:
    lib = load_library(LIBRARY, SOURCES)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn = lib.repro_paged_attention
    fn.restype = i32
    # q, k, v, table, lens, o, ws; q_dtype, kv_dtype, B, Hq, Hkv, D, page,
    # pps, split, per; scale; stream
    fn.argtypes = [ptr] * 7 + [i32] * 10 + [ctypes.c_float, ptr]
    fn = lib.repro_paged_attention_quant
    fn.restype = i32
    # q, k, v, k_scales, v_scales, table, lens, o, ws; q_dtype, B, Hq, Hkv,
    # D, page, pps, split, per; scale; stream
    fn.argtypes = [ptr] * 9 + [i32] * 9 + [ctypes.c_float, ptr]
    return lib


def _check(q, k_pages, v_pages, block_table, seq_lens, kv_dtypes) -> tuple:
    """Shapes (B, Hq, Hkv, d, page, pps) of a call the kernel takes, or
    raise."""
    tensors = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
               "block_table": block_table, "seq_lens": seq_lens}
    if len({t.device for t in tensors.values()}) != 1:
        raise ValueError(f"inputs on different devices: "
                         f"{ {n: str(t.device) for n, t in tensors.items()} }")
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous; strides "
                             f"{t.stride()}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16; got {q.dtype}")
    if k_pages.dtype not in kv_dtypes or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"k_pages and v_pages must share one dtype of "
                        f"{sorted(map(str, kv_dtypes))}; got "
                        f"{k_pages.dtype}, {v_pages.dtype}")
    if block_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError(f"block_table and seq_lens must be int32; got "
                        f"{block_table.dtype}, {seq_lens.dtype}")
    if q.dim() != 3 or k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f"expected q (B, Hq, d) and pages (n_pages, page, "
                         f"Hkv, d); got {tuple(q.shape)}, "
                         f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    B, Hq, d = q.shape
    _, page, Hkv, dk = k_pages.shape
    if dk != d or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)} (need equal d and "
                         f"Hq % Hkv == 0)")
    if d % 16 or d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} is not a multiple of 16 up to "
                         f"{MAX_HEAD_DIM} (the kernel reads pages in "
                         f"16-byte vectors into shared memory)")
    if block_table.dim() != 2 or block_table.shape[0] != B or \
            tuple(seq_lens.shape) != (B,):
        raise ValueError(f"expected block_table (B, pps) and seq_lens (B,) "
                         f"with B = {B}; got {tuple(block_table.shape)}, "
                         f"{tuple(seq_lens.shape)}")
    if block_table.shape[1] == 0 or B == 0 or B > 65535:
        raise ValueError(f"block_table {tuple(block_table.shape)}: need "
                         f"1 <= B <= 65535 and at least one column")
    return B, Hq, Hkv, d, page, block_table.shape[1]


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_table: torch.Tensor,
                    seq_lens: torch.Tensor, *,
                    scale: float | None = None) -> torch.Tensor:
    """q: (B, Hq, d); pages: (n_pages, page, Hkv, d);
    block_table: (B, pages_per_seq) int32; seq_lens: (B,) int32
    -> (B, Hq, d) in q's dtype."""
    if not use_kernel(q, k_pages, v_pages, block_table, seq_lens):
        return paged_attention_ref(q, k_pages, v_pages, block_table,
                                   seq_lens, scale)
    B, Hq, Hkv, d, page, pps = _check(q, k_pages, v_pages, block_table,
                                      seq_lens, _DTYPES)
    scale = d ** -0.5 if scale is None else scale
    split, per, ws = _plan(q, Hkv, pps)
    out = torch.empty_like(q)
    launch(_library().repro_paged_attention, q.data_ptr(),
           k_pages.data_ptr(), v_pages.data_ptr(), block_table.data_ptr(),
           seq_lens.data_ptr(), out.data_ptr(), ws.data_ptr(),
           _DTYPES[q.dtype], _DTYPES[k_pages.dtype], B, Hq, Hkv, d, page,
           pps, split, per, float(scale), device=q.device)
    count_launch("paged_attention")
    return out


def paged_attention_quant(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, k_scales: torch.Tensor,
                          v_scales: torch.Tensor, block_table: torch.Tensor,
                          seq_lens: torch.Tensor, *,
                          scale: float | None = None) -> torch.Tensor:
    """Fused int8 paged decode attention.

    q: (B, Hq, d) fp; k/v_pages: (n_pages, page, Hkv, d) int8;
    k/v_scales: (n_pages, Hkv) f32 (``quantize_pages`` layout);
    block_table: (B, pages_per_seq) int32; seq_lens: (B,) int32
    -> (B, Hq, d) in q's dtype.
    """
    if not use_kernel(q, k_pages, v_pages, k_scales, v_scales, block_table,
                      seq_lens):
        return paged_attention_quant_ref(q, k_pages, v_pages, k_scales,
                                         v_scales, block_table, seq_lens,
                                         scale)
    B, Hq, Hkv, d, page, pps = _check(q, k_pages, v_pages, block_table,
                                      seq_lens, {torch.int8})
    n_pages = k_pages.shape[0]
    for name, s in (("k_scales", k_scales), ("v_scales", v_scales)):
        if s.dtype != torch.float32 or tuple(s.shape) != (n_pages, Hkv) \
                or not s.is_contiguous() or s.device != q.device:
            raise ValueError(f"{name} must be contiguous float32 "
                             f"({n_pages}, {Hkv}) on {q.device}; got "
                             f"{s.dtype} {tuple(s.shape)} on {s.device}")
    scale = d ** -0.5 if scale is None else scale
    split, per, ws = _plan(q, Hkv, pps)
    out = torch.empty_like(q)
    launch(_library().repro_paged_attention_quant, q.data_ptr(),
           k_pages.data_ptr(), v_pages.data_ptr(), k_scales.data_ptr(),
           v_scales.data_ptr(), block_table.data_ptr(), seq_lens.data_ptr(),
           out.data_ptr(), ws.data_ptr(), _DTYPES[q.dtype], B, Hq, Hkv, d,
           page, pps, split, per, float(scale), device=q.device)
    count_launch("paged_attention_quant")
    return out


__all__ = ["paged_attention", "paged_attention_ref", "paged_attention_quant",
           "paged_attention_quant_ref"]
