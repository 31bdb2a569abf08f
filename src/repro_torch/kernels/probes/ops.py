"""Public wrappers for the HEIMDALL probe kernels (P1-P4).

Each takes the buffer it probes on one memory tier: a CUDA tensor (HBM) or
a pinned CPU tensor (the host tier, read by the kernel through its mapped
device pointer). Where the work runs is the device of its output: ``device``
for ``pointer_chase`` and ``tier_sum``, the indices and updates for
``tier_scatter_add``, ``out`` for ``tier_copy``. On a CUDA device they launch
the hand-written kernels (``csrc/probes.cu``) on the current stream, or
raise; on the CPU, where every tensor must then lie, they run the plain
versions in ``ref.py``. A pageable CPU tensor is never read by a kernel.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import count_launch, launch, load_library
from repro_torch.kernels.probes.ref import (MODES, pointer_chase_ref,
                                            tier_copy_ref,
                                            tier_scatter_add_ref,
                                            tier_sum_ref)

LIBRARY = "probes"
SOURCES = [Path(__file__).resolve().parent / "csrc" / "probes.cu"]


def _library() -> ctypes.CDLL:
    lib = load_library(LIBRARY, SOURCES)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, args in (
            ("repro_pointer_chase", [P, I, L, I, I, P, P]),
            ("repro_tier_sum", [P, I, L, P, P, P]),
            ("repro_tier_scatter_add", [P, I, L, P, P, L, P]),
            ("repro_tier_copy", [P, I, P, L, P])):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = args
    return lib


def _on_card(device: torch.device, tier: torch.Tensor, *dev_tensors
             ) -> bool:
    """True when the work runs on CUDA ``device`` (launch the kernel):
    ``tier`` must then lie on that device or in pinned host memory, and
    ``dev_tensors`` on that device. False on the CPU (the plain version),
    where every tensor must lie on the CPU."""
    if device.type == "cpu":
        devs = {t.device.type for t in (tier, *dev_tensors)}
        if devs != {"cpu"}:
            raise ValueError(f"work on the CPU takes CPU tensors; got "
                             f"{sorted(devs)}")
        return False
    if device.type != "cuda":
        raise ValueError(f"probes run on cuda or the CPU; got {device}")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    for t in dev_tensors:
        if t.device != device:
            raise ValueError(f"expected a tensor on {device}; got "
                             f"{t.device}")
    if tier.device.type == "cpu":
        if not tier.is_pinned():
            raise ValueError("a host-tier buffer must be pinned memory: a "
                             "kernel reads it through its mapped device "
                             "pointer, which pageable memory lacks")
    elif tier.device != device:
        raise ValueError(f"tier buffer on {tier.device}, work on {device}")
    return True


def _check(name: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}; got {t.dtype}")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D tensor; got "
                         f"shape {tuple(t.shape)}, strides {t.stride()}")


def _host(t: torch.Tensor) -> int:
    return int(t.device.type == "cpu")


def pointer_chase(p: torch.Tensor, steps: int, mode: str = "chase", *,
                  device=None) -> torch.Tensor:
    """P1: the final value of a dependent chain of ``steps`` loads through
    the int32 vector ``p`` (``ref.pointer_chase_ref`` says what each mode
    computes), as an int32 scalar tensor on ``device`` (default: ``p``'s).
    On the card one thread runs the chain, so its time per step is the
    tier's load latency."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}; got {mode!r}")
    if steps < 0:
        raise ValueError(f"steps must be >= 0; got {steps}")
    _check("p", p, torch.int32)
    if p.numel() == 0:
        raise ValueError("p is empty: nothing to chase")
    device = torch.device(device) if device is not None else p.device
    if not _on_card(device, p):
        return torch.tensor(pointer_chase_ref(p, steps, mode),
                            dtype=torch.int32)
    out = torch.empty((), dtype=torch.int32, device=device)
    launch(_library().repro_pointer_chase, p.data_ptr(), _host(p),
           p.numel(), steps, MODES.index(mode), out.data_ptr(),
           device=out.device)
    count_launch("pointer_chase")
    return out


def tier_sum(x: torch.Tensor, *, device=None) -> torch.Tensor:
    """P2: the fp32 sum of the float32 vector ``x`` as a scalar tensor on
    ``device`` (default: ``x``'s). The kernel sums in another order than
    the plain version: compare at a relative tolerance."""
    _check("x", x, torch.float32)
    device = torch.device(device) if device is not None else x.device
    if not _on_card(device, x):
        return tier_sum_ref(x, device)
    out = torch.empty((), dtype=torch.float32, device=device)
    scratch = torch.empty(2, dtype=torch.float64, device=out.device)
    launch(_library().repro_tier_sum, x.data_ptr(), _host(x), x.numel(),
           scratch.data_ptr(), out.data_ptr(), device=out.device)
    count_launch("tier_sum")
    return out


def tier_scatter_add(t: torch.Tensor, idx: torch.Tensor,
                     u: torch.Tensor) -> torch.Tensor:
    """P3: ``t[idx] += u`` in place (float32 ``t`` and ``u``, int32
    ``idx``; repeated indices accumulate), run on the device of ``idx`` and
    ``u``. Returns ``t``."""
    _check("t", t, torch.float32)
    _check("idx", idx, torch.int32)
    _check("u", u, torch.float32)
    if idx.numel() != u.numel():
        raise ValueError(f"idx has {idx.numel()} entries, u {u.numel()}")
    if t.numel() == 0:
        raise ValueError("t is empty: nothing to add into")
    if not _on_card(idx.device, t, idx, u):
        return tier_scatter_add_ref(t, idx, u)
    if idx.numel() == 0:
        return t
    launch(_library().repro_tier_scatter_add, t.data_ptr(), _host(t),
           t.numel(), idx.data_ptr(), u.data_ptr(), idx.numel(),
           device=idx.device)
    count_launch("tier_scatter_add")
    return t


def tier_copy(x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """P4: ``out = x * 1.0`` (float32), the loads and stores done by the
    SMs of ``out``'s device, not by a copy engine. Returns ``out``."""
    _check("x", x, torch.float32)
    _check("out", out, torch.float32)
    if x.numel() != out.numel():
        raise ValueError(f"x has {x.numel()} elements, out {out.numel()}")
    if not _on_card(out.device, x, out):
        return tier_copy_ref(x, out)
    if out.numel() == 0:
        return out
    launch(_library().repro_tier_copy, x.data_ptr(), _host(x),
           out.data_ptr(), out.numel(), device=out.device)
    count_launch("tier_copy")
    return out
