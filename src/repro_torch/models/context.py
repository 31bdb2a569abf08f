"""MCtx: the parallelism config, device and pod group threaded through
model functions.

On one card there is no mesh, so the reference's sharding constraints
(``MCtx.constrain``, ``constrain_kv``) have no counterpart here; they come
with the slice that ports the mesh. ``pod_group`` is the counterpart of a
``pod`` axis in the reference's mesh: the ``torch.distributed`` process
group over which the training step averages compressed gradients, or
None. ``stats``, where a caller sets it to a dict, collects counters a run
asks for (``"moe_dropped"``: the (token, slot) pairs the MoE layers drop
for want of capacity).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.config.base import ParallelConfig


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``.

    Raises if CUDA is asked for (explicitly or by default) and no CUDA
    device is available: the port never moves to the CPU on its own.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: repro_torch runs on cuda by "
            "default; pass device='cpu' to run the plain PyTorch versions "
            "on the CPU")
    return dev


@dataclasses.dataclass
class MCtx:
    parallel: ParallelConfig = ParallelConfig()
    device: torch.device = dataclasses.field(
        default_factory=lambda: torch.device("cpu"))
    pod_group: Optional[Any] = None     # a ProcessGroup, or None
    stats: Optional[dict] = None        # counters a caller asks for

    @property
    def cache_seq_axis(self) -> Optional[str]:
        return "act_cache_seq"
