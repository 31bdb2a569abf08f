"""Mesh construction for single-pod and multi-pod runs.

The port of the reference's ``repro/launch/mesh.py`` over
``torch.distributed.device_mesh.DeviceMesh``. A mesh spans the ranks of
the default process group, so ``make_production_mesh`` is a FUNCTION: the
dry-run (``launch/dryrun.py``) first sets up a fake process group of 256 or
512 ranks in its own process, as the reference sets its 512 placeholder
devices there; everything else sees the real world size. Meshes are
``cuda`` meshes unless the caller asks for the CPU.

``shard_map`` is the counterpart of ``jax.shard_map``: it runs a function
on the local shards of its inputs and wraps the outputs as DTensors with
the placements it is given.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Placement

# Canonical mesh axis names.
POD_AXIS = "pod"
DATA_AXIS = "data"    # doubles as the FSDP axis
MODEL_AXIS = "model"  # tensor-parallel axis


def _device_type(device_type: Optional[str]) -> str:
    return "cuda" if device_type is None else torch.device(device_type).type


def _make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
               device_type: Optional[str] = None) -> DeviceMesh:
    return init_device_mesh(_device_type(device_type), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None) -> DeviceMesh:
    """The production mesh: 16x16 single pod, or 2x16x16 across two pods
    (needs a world of 256 or 512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ((POD_AXIS, DATA_AXIS, MODEL_AXIS) if multi_pod
            else (DATA_AXIS, MODEL_AXIS))
    return make_mesh(shape, axes, device_type)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device_type: Optional[str] = None) -> DeviceMesh:
    """Arbitrary mesh helper (tests, the elastic runtime); raises when the
    mesh needs more ranks than the world has."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if int(np.prod(shape)) > world:
        raise ValueError(f"mesh {shape} needs {int(np.prod(shape))} "
                         f"devices, have {world}")
    return _make_mesh(shape, axes, device_type)


def make_host_mesh(model_parallel: int = 1,
                   device_type: Optional[str] = None) -> DeviceMesh:
    """A (data, model) mesh over every rank of the default process group
    (smoke tests, examples, the HEIMDALL apps); ``local_process_group``
    gives a one-rank group where there is none."""
    n = dist.get_world_size()
    dp = max(1, n // model_parallel)
    return _make_mesh((dp, model_parallel), (DATA_AXIS, MODEL_AXIS),
                      device_type)


@contextlib.contextmanager
def local_process_group(device_type: Optional[str] = None):
    """A one-rank default process group on an in-process store (``nccl``
    for ``cuda``, else ``gloo``) for the duration, torn down after; where
    a default group exists already it is used as it is."""
    if dist.is_initialized():
        yield
        return
    backend = "nccl" if _device_type(device_type) == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def mesh_axis_names(mesh: DeviceMesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def mesh_shape(mesh: DeviceMesh) -> dict[str, int]:
    """{axis name: size}, the reference's ``mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def data_axes(mesh: DeviceMesh) -> tuple[str, ...]:
    """Axes over which the batch is sharded (pod+data when multi-pod)."""
    names = mesh_axis_names(mesh)
    return tuple(a for a in (POD_AXIS, DATA_AXIS) if a in names)


def num_chips(mesh: DeviceMesh) -> int:
    return int(np.prod(list(mesh_shape(mesh).values())))


def shard_map(f: Callable, *, mesh: DeviceMesh,
              in_placements: Sequence[Optional[Sequence[Placement]]],
              out_placements: Sequence[Optional[Sequence[Placement]]],
              in_grad_placements: Optional[Sequence] = None) -> Callable:
    """``f`` over local shards: each DTensor input is redistributed to its
    ``in_placements`` entry and passed as its local tensor (plain inputs,
    and inputs whose entry is None, pass as they are); each output with a
    placements entry is wrapped as a DTensor of the local result.

    ``in_grad_placements`` gives, per input, the placements of its local
    gradient where they differ from the forward ones: a replicated input
    whose local copy is used differently on each rank (a column-parallel
    matmul's input, a weight used on a rank's own batch) takes ``Partial``
    there, so its gradient is summed over those ranks.
    """
    grads = in_grad_placements or [None] * len(in_placements)

    def run(*args):
        local = []
        for a, pl, gp in zip(args, in_placements, grads):
            if isinstance(a, DTensor):
                if pl is not None and tuple(a.placements) != tuple(pl):
                    a = a.redistribute(mesh, list(pl))
                a = a.to_local(grad_placements=gp)
            local.append(a)
        outs = f(*local)
        single = not isinstance(outs, tuple)
        outs = (outs,) if single else outs
        wrapped = tuple(
            o if pl is None else DTensor.from_local(o, mesh, list(pl),
                                                    run_check=False)
            for o, pl in zip(outs, out_placements))
        return wrapped[0] if single else wrapped
    return run

