"""The roofline walker over a torch program.

The reference walks a compiled program's HLO text and multiplies loop
bodies by their trip counts (``repro/roofline/hlo_walk.py``). The port has
no compiled program: ``analyze(fn, *args)`` runs ``fn`` under
``FakeTensorMode`` (no memory behind any tensor, no kernel runs) with a
dispatch mode that sees every op as it is issued. A Python loop over
layers issues each layer's ops, so the count needs no trip counts; a loop
over thousands of identical steps (the sLSTM's recurrence over the
sequence) runs one step inside ``trips(n)`` under a walk, which counts its
ops n times, as the reference's walker counts a scan's body.

Counts are per chip, as the reference's: on the mesh path every block body
runs on one rank's local shards, and DTensor's collectives are issued on
local tensors, so the ops the walker sees are one rank's. An op issued on
DTensors (the residual add) is counted from its local tensors.

Accounting (an eager program runs one kernel per op, unfused):

* FLOPs: matmuls, convolutions, attention and the flash kernel from
  ``torch.utils.flop_counter``'s formulas (``flop_registry``; the kernel's
  custom op registers its own), also reported alone as ``dot_flops``; 1
  per output element for a pointwise op; 1 per input element for a
  reduction (the reference's HloCostAnalysis convention);
* bytes: every input and output of an op that moves data, read once and
  written once; views, metadata and allocations are free;
* collectives: the result bytes of each functional collective
  (``_c10d_functional``), by the reference's kinds;
* memory: the peak of live storage bytes over the run, inputs included
  (``peak_bytes``), the counterpart of the reference's
  ``memory_analysis``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Callable

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

COLL_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
              "collective-permute", "ragged-all-to-all")

# _c10d_functional op name -> the reference's collective kind
_COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
}

_FREE = frozenset((
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "detach", "alias", "lift_fresh", "_local_scalar_dense", "device",
    "sym_size", "sym_stride", "sym_numel", "sym_storage_offset", "dim",
    "is_contiguous", "_to_copy_meta", "_unsafe_view"))

_REDUCTIONS = frozenset((
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin", "prod",
    "logsumexp", "_softmax", "_log_softmax", "softmax", "log_softmax",
    "var_mean", "norm", "linalg_vector_norm", "cumsum", "sort", "topk",
    "any", "all"))


_WALKS: list = []       # the walk analyze() is running, if any


def walking() -> bool:
    """Is a walk counting the ops issued now (a fake-tensor trace)?"""
    return bool(_WALKS)


@contextlib.contextmanager
def trips(n: int):
    """Count every op issued inside ``n`` times: the body of a loop whose
    ``n`` iterations issue the same ops on tensors of the same shapes, run
    once under a walk. Outside a walk it changes nothing."""
    if not _WALKS:
        yield
        return
    walk = _WALKS[-1]
    old = walk.mult
    walk.mult = old * n
    try:
        yield
    finally:
        walk.mult = old


def _tensors(tree) -> list:
    leaves, _ = tree_flatten(tree)
    return [t for t in leaves if isinstance(t, torch.Tensor)]


def _local(t: torch.Tensor) -> torch.Tensor:
    return t._local_tensor if isinstance(t, DTensor) else t


def _nbytes(t: torch.Tensor) -> int:
    t = _local(t)
    return t.numel() * t.element_size()


def _aliases(func) -> bool:
    """Does the op return a view of (or write into) an input?"""
    return any(r.alias_info is not None for r in func._schema.returns)


@dataclasses.dataclass
class Totals:
    flops: float = 0.0
    bytes: float = 0.0
    coll: dict = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLL_KINDS})

    def add(self, other: "Totals", mult: float = 1.0):
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        for k in COLL_KINDS:
            self.coll[k] += other.coll[k] * mult

    @property
    def collective_bytes(self) -> float:
        return sum(self.coll.values())


class HloCost(TorchDispatchMode):
    """The reference's walker, over the ops a torch program issues (a
    dispatch mode) where the reference's parses HLO text: each op's FLOPs,
    bytes and collective bytes go into ``totals()``; ``dot_flops`` keeps the
    matmuls' share, ``peak`` the peak of live storage bytes."""

    def __init__(self, record: bool = False):
        super().__init__()
        self.t = Totals()
        self.dot_flops = 0.0
        self.warnings: list[str] = []
        self.ops: list = [] if record else None
        self.live = 0
        self.peak = 0
        self.mult = 1           # trips() of the loop body being issued
        self._seen: dict[int, weakref.ref] = {}

    def totals(self) -> Totals:
        return self.t

    # -- live storage bytes -------------------------------------------------
    def track(self, t: torch.Tensor) -> None:
        st = _local(t).untyped_storage()
        key = id(st)
        if key in self._seen and self._seen[key]() is st:
            return
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)

        def gone(_, n=n, key=key):
            self.live -= n
            self._seen.pop(key, None)
        self._seen[key] = weakref.ref(st, gone)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        outs = _tensors(out)
        for t in outs:
            self.track(t)
        if ns == "_c10d_functional":
            kind = _COLLECTIVES.get(name)
            if kind is not None:
                nb = sum(_nbytes(t) for t in outs) * self.mult
                self.t.coll[kind] += nb
                self.t.bytes += nb
                if self.ops is not None:
                    self.ops.append((f"{ns}::{name}", kind, nb))
            return out
        if ns == "prim" or name in _FREE or (
                _aliases(func) and not name.endswith("_")):
            return out
        ins = _tensors((args, kwargs))
        nb = self._operand_bytes(ins) + self._operand_bytes(outs)
        fl = 0.0
        if func.overloadpacket in flop_registry:
            if any(isinstance(t, DTensor) for t in ins):
                self.warnings.append(f"{name} on DTensors: FLOPs of the "
                                     f"global op, not one rank's")
            fl = self._dot_flops(func, args, kwargs, out)
            self.dot_flops += fl * self.mult
        elif torch.Tag.pointwise in func.tags:
            fl = self._operand_elems(outs)
        elif name.rstrip("_") in _REDUCTIONS or name in _REDUCTIONS:
            fl = float(max((_local(t).numel() for t in ins), default=0))
        fl, nb = fl * self.mult, nb * self.mult
        self.t.flops += fl
        self.t.bytes += nb
        if self.ops is not None:
            self.ops.append((f"{ns}::{name}", fl, nb))
        return out


    @staticmethod
    def _dot_flops(func, args, kwargs, out) -> float:
        """A matmul's (or attention's, or the flash kernel's) FLOPs from
        ``torch.utils.flop_counter``'s formula for it."""
        return float(flop_registry[func.overloadpacket](*args, **kwargs,
                                                        out_val=out))

    @staticmethod
    def _operand_elems(ts) -> float:
        return float(sum(_local(t).numel() for t in ts))

    @staticmethod
    def _operand_bytes(ts) -> float:
        return float(sum(_nbytes(t) for t in ts))


def analyze(fn: Callable, *args, record: bool = False, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` under ``FakeTensorMode`` and count its
    per-chip FLOPs, bytes and collective bytes (the reference's keys), and
    its peak of live bytes. ``args`` are fake tensors (or trees of them)
    made under ``models.params.fake_mode()``; real tensors are read as
    constants. With ``record`` the result also holds ``op_record``: one
    (op, FLOPs or collective kind, bytes) row per op, in order."""
    from repro_torch.models.params import fake_mode
    walk = HloCost(record)
    with fake_mode():
        for t in _tensors((args, kwargs)):
            walk.track(t)
        _WALKS.append(walk)
        try:
            with walk:
                fn(*args, **kwargs)
        finally:
            _WALKS.pop()
    t = walk.totals()
    out = {"flops": t.flops, "dot_flops": walk.dot_flops, "bytes": t.bytes,
           "collective_bytes": t.collective_bytes,
           "collectives_by_kind": dict(t.coll),
           "warnings": sorted(set(walk.warnings))[:20],
           "peak_bytes": walk.peak}
    if record:
        out["op_record"] = walk.ops
    return out
