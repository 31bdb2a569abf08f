"""Logical-axis -> mesh-axis sharding rules (MaxText-style), plus helpers.

The port of the reference's ``repro/models/sharding.py``. ``logical_rules``
is the reference's table, dict for dict; ``spec_for`` its
prefix-that-divides rule, returning the parts of the reference's
``PartitionSpec`` as a tuple (a mesh axis name, a tuple of names for a dim
sharded over several axes, or None; trailing Nones dropped). The rest
turns a spec into DTensor placements on a ``DeviceMesh``: weights are held
as DTensors placed by the rules, activations are redistributed by
``constrain`` at the points where the reference puts its sharding
constraints.

A mesh here is a ``DeviceMesh``; the rule and spec functions also take a
``{axis: size}`` dict or an object with such a ``.shape`` (the reference's
``AbstractMesh``), so they can be compared with the reference's without a
process group.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch.distributed.tensor import (DTensor, Partial, Placement,
                                      Replicate, Shard)

from repro_torch.config.base import ParallelConfig
from repro_torch.launch.mesh import DATA_AXIS, MODEL_AXIS, POD_AXIS


def mesh_sizes(mesh) -> dict[str, int]:
    """{axis: size} of a DeviceMesh, a dict, or an object with ``.shape``."""
    if isinstance(mesh, dict):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def logical_rules(mesh, parallel: ParallelConfig,
                  seq_sharded_cache: bool = False) -> dict[str, object]:
    names = set(mesh_sizes(mesh))
    fsdp = DATA_AXIS if (parallel.fsdp and DATA_AXIS in names) else None
    batch_axes = tuple(a for a in (POD_AXIS, DATA_AXIS) if a in names)
    ep_axes = tuple(a for a in (DATA_AXIS, MODEL_AXIS) if a in names)
    # KV caches are sharded along the *sequence* dim (flash-decoding
    # style): GQA kv-head counts (4-16) can't split a 16-way model axis,
    # the sequence always can. long_500k (batch=1) also spreads over 'data'.
    cache_seq = (ep_axes if seq_sharded_cache
                 else ((MODEL_AXIS,) if MODEL_AXIS in names else ()))
    if parallel.serve_2d_weights:
        # Weight-stationary decode: every weight 2D-sharded, its embed dim
        # on 'model' and its hidden dim on 'data'; the residual stream
        # d-sharded over 'model'.
        return {
            "embed": MODEL_AXIS,
            "mlp": DATA_AXIS,
            "heads": DATA_AXIS,
            "kv_heads": None,
            "vocab": DATA_AXIS,
            "experts": ep_axes,
            "layers": None,
            "act_batch": batch_axes,
            "act_seq": None,
            "act_cache_seq": cache_seq,
            "act_heads": None,
            "act_mlp": DATA_AXIS,
            "act_embed": MODEL_AXIS,
            "act_vocab": DATA_AXIS,
        }
    return {
        # weights
        "embed": fsdp,
        "mlp": MODEL_AXIS,
        "heads": MODEL_AXIS,
        "kv_heads": MODEL_AXIS,
        "vocab": MODEL_AXIS,
        "experts": ep_axes,          # EP over (data, model) jointly
        "layers": None,
        # activations
        "act_batch": batch_axes,
        # Sequence parallelism: the residual stream between blocks is
        # seq-sharded over 'model'; block entry gathers it, block exit
        # reduce-scatters into it.
        "act_seq": (MODEL_AXIS if (parallel.seq_parallel
                                   and MODEL_AXIS in names) else None),
        "act_cache_seq": cache_seq,
        "act_heads": MODEL_AXIS,
        "act_mlp": MODEL_AXIS,
        "act_embed": None,
        "act_vocab": MODEL_AXIS,
    }


def spec_for(axes: tuple[Optional[str], ...], rules: dict[str, object],
             shape: Optional[tuple[int, ...]] = None,
             mesh=None) -> tuple:
    """The reference's PartitionSpec parts for logical axes: each mesh
    axis at most once, and with a shape and mesh only a prefix of a dim's
    axes whose product divides the dim."""
    sizes = mesh_sizes(mesh) if mesh is not None else None
    parts: list = []
    used: set[str] = set()
    for i, a in enumerate(axes):
        m = rules.get(a) if a is not None else None
        if m is not None and not isinstance(m, tuple):
            m = (m,)
        if m is not None:
            m = tuple(x for x in m if x is not None and x not in used)
            if shape is not None and sizes is not None and m:
                keep, sz = [], 1
                for x in m:
                    nx = sz * sizes[x]
                    if shape[i] % nx == 0:
                        keep.append(x)
                        sz = nx
                    else:
                        break
                m = tuple(keep)
            used.update(m)
            parts.append(m if len(m) > 1 else (m[0] if m else None))
        else:
            parts.append(None)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def spec_axes(part) -> tuple[str, ...]:
    """A spec part as a tuple of mesh axes (() for None)."""
    if part is None:
        return ()
    return part if isinstance(part, tuple) else (part,)


def placements_of(spec: tuple, mesh, partial: tuple[str, ...] = ()
                  ) -> list[Placement]:
    """DTensor placements for a spec on ``mesh``: ``Shard(i)`` on every
    mesh dim that shards tensor dim ``i``, ``Partial`` on the axes in
    ``partial``, ``Replicate`` elsewhere. A dim sharded over several axes
    takes them major to minor in mesh order, as the reference's spec does."""
    names = list(mesh_sizes(mesh))
    out: list[Placement] = [Replicate()] * len(names)
    for i, part in enumerate(spec):
        axes = spec_axes(part)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} of dim {i} are not "
                             f"in mesh order {names}")
        for j in idx:
            out[j] = Shard(i)
    for a in partial:
        out[names.index(a)] = Partial()
    return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, its DTensor placements, and the memory kind the
    reference would give the array (recorded only: a fake or DTensor
    cannot be pinned)."""
    mesh: Any
    spec: tuple
    placements: tuple
    memory_kind: Optional[str] = None


def named_sharding(mesh, rules: dict[str, object],
                   axes: tuple[Optional[str], ...],
                   shape: Optional[tuple[int, ...]] = None,
                   memory_kind: Optional[str] = None) -> NamedSharding:
    spec = spec_for(axes, rules, shape, mesh)
    return NamedSharding(mesh, spec, tuple(placements_of(spec, mesh)),
                         memory_kind)


def constrain(x, mesh, rules: dict[str, object],
              axes: tuple[Optional[str], ...]):
    """Redistribute a DTensor to the placements of its logical activation
    axes (the reference's ``with_sharding_constraint``); a plain tensor is
    returned as it is."""
    if not isinstance(x, DTensor):
        return x
    pl = placements_of(spec_for(axes, rules, tuple(x.shape), mesh), mesh)
    if tuple(pl) == tuple(x.placements):
        return x
    return x.redistribute(mesh, pl)


def param_shardings(mesh, rules: dict[str, object], axes_tree,
                    shape_tree=None, memory_kind_tree=None):
    """Tree of ``NamedSharding``s from a tree of logical-axes tuples."""
    if isinstance(axes_tree, dict):
        return {k: param_shardings(
                    mesh, rules, v,
                    None if shape_tree is None else shape_tree[k],
                    None if memory_kind_tree is None else memory_kind_tree[k])
                for k, v in axes_tree.items()}
    return named_sharding(mesh, rules, axes_tree, shape_tree,
                          memory_kind_tree)


# --------------------------------------------------------------------------
# DTensors
# --------------------------------------------------------------------------


def local_shape(shape: tuple[int, ...], placements, mesh) -> tuple:
    """The shape of one rank's shard (even shards, as ``spec_for`` makes
    them)."""
    out = list(shape)
    for size, pl in zip(mesh_sizes(mesh).values(), placements):
        if isinstance(pl, Shard):
            if out[pl.dim] % size:
                raise ValueError(f"dim {pl.dim} of {tuple(shape)} does not "
                                 f"split {size} ways")
            out[pl.dim] //= size
    return tuple(out)


def local_shard(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's shard of a tensor every rank holds whole: a view, no
    communication and no copy."""
    coord = mesh.get_coordinate()
    out = full
    for m, pl in enumerate(placements):
        if isinstance(pl, Shard):
            n = mesh.size(m)
            step = out.shape[pl.dim] // n
            out = out.narrow(pl.dim, coord[m] * step, step)
    return out


def distribute(t: torch.Tensor, mesh, placements) -> DTensor:
    """``t`` as a DTensor with ``placements``: a DTensor is redistributed;
    a plain tensor is taken as the whole value, which every rank holds, and
    wrapped around this rank's shard of it (on a one-rank mesh, ``t``
    itself, with no copy)."""
    placements = list(placements)
    if isinstance(t, DTensor):
        return t.redistribute(mesh, placements)
    return DTensor.from_local(local_shard(t, mesh, placements), mesh,
                              placements, run_check=False,
                              shape=t.shape, stride=t.stride())
