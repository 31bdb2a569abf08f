"""MCtx: the mesh, parallelism config, device and pod group threaded
through model functions.

``mesh`` is None by default: the model then runs on plain tensors on one
device, and ``constrain`` / ``constrain_kv`` return what they are given.
With a ``DeviceMesh`` the model holds its weights as DTensors placed by
``rules`` (``models/sharding.logical_rules``) and redistributes its
activations at the reference's constraint points (the mesh path,
``models/tp.py``). ``pod_group`` is the counterpart of a ``pod`` axis in the
reference's mesh: the ``torch.distributed`` process group over which the
training step averages compressed gradients, or None; with a mesh that has
a ``pod`` axis it is that axis's group. ``stats``, where a caller sets it
to a dict, collects counters a run asks for (``"moe_dropped"``: the
(token, slot) pairs the MoE layers drop for want of capacity; on a mesh,
this rank's; with ``dropless``, ``moe.COUNTS``: the pairs the dropless
layers route). ``dropless``, which the serving roles (``Model.prefill``,
``Model.decode``) set, runs the MoE layers off a mesh without capacity:
no (token, slot) pair is dropped (``models/moe.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.config.base import ParallelConfig
from repro_torch.launch.mesh import (DATA_AXIS, MODEL_AXIS, POD_AXIS,
                                     mesh_shape)
from repro_torch.models.sharding import constrain, logical_rules


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
    mesh: Optional[Any] = None          # a DeviceMesh, or None
    seq_sharded_cache: bool = False     # long-context: KV seq over 'data'
    manual_pod: bool = False            # inside a body manual over 'pod'
    rules: Optional[dict] = None
    dropless: bool = False              # MoE routes every pair (serving)

    def __post_init__(self):
        if self.mesh is None:
            return
        if self.rules is None:
            self.rules = logical_rules(self.mesh, self.parallel,
                                       self.seq_sharded_cache)
            if self.manual_pod:
                self.rules = dict(self.rules)
                self.rules["act_batch"] = tuple(
                    a for a in self.rules["act_batch"] if a != POD_AXIS)
        if (self.pod_group is None
                and POD_AXIS in self.mesh.mesh_dim_names):
            self.pod_group = self.mesh.get_group(POD_AXIS)

    @property
    def batch_axes(self) -> tuple[str, ...]:
        if self.mesh is None:
            return ()
        axes = tuple(a for a in (POD_AXIS, DATA_AXIS)
                     if a in self.mesh.mesh_dim_names)
        if self.manual_pod:
            axes = tuple(a for a in axes if a != POD_AXIS)
        return axes

    @property
    def data_size(self) -> int:
        return 1 if self.mesh is None else mesh_shape(self.mesh).get(
            DATA_AXIS, 1)

    @property
    def model_size(self) -> int:
        return 1 if self.mesh is None else mesh_shape(self.mesh).get(
            MODEL_AXIS, 1)

    def constrain(self, x, axes: tuple[Optional[str], ...]):
        if self.mesh is None:
            return x
        return constrain(x, self.mesh, self.rules, axes)

    @property
    def cache_seq_axis(self) -> Optional[str]:
        return "act_cache_seq"

    def constrain_kv(self, kv: Optional[dict], stacked: bool = False):
        """Sharding constraints for per-layer cache leaves (``stacked``:
        a leading layers dim)."""
        if kv is None or self.mesh is None:
            return kv
        lead = ("layers",) if stacked else ()
        out = {}
        for k, v in kv.items():
            if k in ("k", "v", "ckv", "k_rope"):
                axes = lead + ("act_batch", "act_cache_seq") + (None,) * (
                    v.dim() - 2 - len(lead))
                out[k] = self.constrain(v, axes)
            else:
                out[k] = v
        return out
