"""Parameter-spec machinery.

A model is described by a nested dict of ``ParamSpec``s (shape + logical axis
names + init), as in the reference. From one spec tree the port derives
initialized parameter trees (``init_params``), parameter counts and bytes,
the logical-axes tree the sharding rules read (``param_axes``) and, for the
dry-run, fake tensors carrying their placements (``abstract_params``). Stacked
layers keep the reference's ``[L, ...]`` leading dim, so the port's tree and
the reference's match key for key and ``params_from_jax`` can carry weights
across.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]
    init: str = "normal"         # normal | zeros | ones | small_normal
    scale: Optional[float] = None  # stddev override; default 1/sqrt(fan_in)
    dtype: str = "float32"

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def map_specs(fn, tree):
    """Apply ``fn`` to every ``ParamSpec`` leaf of a nested dict."""
    if isinstance(tree, ParamSpec):
        return fn(tree)
    return {k: map_specs(fn, v) for k, v in tree.items()}


def tree_map(fn, *trees):
    """Apply ``fn`` leaf by leaf to nested dicts of one structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_flatten(tree, prefix=()) -> list:
    """[(path, leaf)] of a nested dict in sorted-key order, the order of
    ``jax.tree.leaves`` on the reference's trees."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    return [item for k in sorted(tree)
            for item in tree_flatten(tree[k], prefix + (k,))]


def tree_unflatten(paths, leaves) -> dict:
    """The nested dict with ``leaves`` at ``paths`` (``tree_flatten``'s
    inverse)."""
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def stack_spec(spec: ParamSpec, n: int) -> ParamSpec:
    """Prepend a stacked 'layers' dim."""
    return dataclasses.replace(
        spec, shape=(n, *spec.shape), axes=("layers", *spec.axes))


def stack_specs(tree, n: int):
    return map_specs(lambda s: stack_spec(s, n), tree)


def _fan_in(shape: tuple[int, ...]) -> int:
    if len(shape) == 0:
        return 1
    if len(shape) == 1:
        return shape[0]
    return int(np.prod(shape[:-1]))


def torch_dtype(name: str) -> torch.dtype:
    """'float32' / 'bfloat16' / ... -> the torch dtype of that name."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def _init_one(spec: ParamSpec, generator: torch.Generator,
              device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    scale = spec.scale
    if scale is None:
        scale = 1.0 / np.sqrt(max(1, _fan_in(spec.shape)))
    if spec.init == "small_normal":
        scale = 0.02
    x = torch.randn(spec.shape, generator=generator, dtype=dtype,
                    device=device)
    return x.mul_(float(scale))


def _flatten_with_path(tree, prefix=()):
    if isinstance(tree, ParamSpec):
        yield prefix, tree
        return
    for k in sorted(tree.keys()):
        yield from _flatten_with_path(tree[k], prefix + (k,))


def init_params(specs, generator: torch.Generator, device,
                dtype: Optional[torch.dtype] = None) -> dict:
    """Initialize a parameter tree from a spec tree.

    Every leaf is drawn on ``device`` in ``dtype`` (default: the spec's
    dtype) from ``generator``, which must live on that device, in sorted
    path order, so the draw is deterministic for a seed. Drawing in the
    serving dtype on the device means no fp32 copy of a large stacked leaf
    is ever built on the host. (The reference folds ``hash(path)`` into its
    key, which varies between processes; the two packages' initial weights
    are never compared, weights are carried with ``params_from_jax``.)
    """
    device = torch.device(device)
    out: dict = {}
    for path, spec in _flatten_with_path(specs):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = _init_one(spec, generator, device,
                                   dtype or torch_dtype(spec.dtype))
    return out


def params_from_jax(tree, device, dtype: Optional[torch.dtype] = None):
    """The reference's parameter tree, as nested dicts of numpy arrays
    (``jax.tree.map(np.asarray, params)``), as the port's tree of tensors.

    bfloat16 leaves (numpy's ``ml_dtypes`` bfloat16, which
    ``torch.from_numpy`` refuses) are carried bit for bit: viewed as int16
    on the numpy side and as bfloat16 on the torch side.
    """
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    arr = np.array(tree)             # a writable copy torch may own
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype or t.dtype)


def count_params(specs) -> int:
    return sum(int(np.prod(s.shape)) for _, s in _flatten_with_path(specs))


def param_axes(specs):
    """Same-structure tree of logical-axes tuples."""
    return map_specs(lambda s: s.axes, specs)


def param_bytes(specs) -> int:
    return sum(int(np.prod(s.shape)) * torch_dtype(s.dtype).itemsize
               for _, s in _flatten_with_path(specs))


_FAKE: Optional[FakeTensorMode] = None


def fake_mode() -> FakeTensorMode:
    """The active ``FakeTensorMode``, or one this module keeps, so that
    abstract trees made by separate calls can meet in one computation."""
    global _FAKE
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, FakeTensorMode):
            return mode
    if _FAKE is None:
        _FAKE = FakeTensorMode(allow_non_fake_inputs=True)
    return _FAKE


def abstract_leaf(shape, dtype: torch.dtype, sharding=None,
                  device="cuda"):
    """A fake tensor of ``shape`` (no memory behind it); with a
    ``sharding`` (``models.sharding.NamedSharding``) a DTensor around this
    rank's fake shard, placed as the sharding says, with its memory kind
    recorded as ``memory_kind`` (a fake tensor cannot be pinned)."""
    from repro_torch.models.sharding import local_shape
    shape = tuple(shape)
    with fake_mode():
        if sharding is None:
            return torch.empty(shape, dtype=dtype, device=device)
        mesh = sharding.mesh
        local = torch.empty(local_shape(shape, sharding.placements, mesh),
                            dtype=dtype, device=mesh.device_type)
        stride = torch.empty(shape, dtype=dtype, device="meta").stride()
        t = DTensor.from_local(local, mesh, list(sharding.placements),
                               run_check=False, shape=shape, stride=stride)
    t.memory_kind = sharding.memory_kind or "device"
    return t


def abstract_params(specs, sharding_fn=None, dtype=None):
    """Fake tensors for a spec tree, placed by ``sharding_fn(axes, shape)``
    where it is given (the reference's ShapeDtypeStructs with shardings)."""
    def mk(s: ParamSpec):
        dt = dtype or torch_dtype(s.dtype)
        if sharding_fn is None:
            return abstract_leaf(s.shape, dt)
        return abstract_leaf(s.shape, dt, sharding_fn(s.axes, s.shape))
    return map_specs(mk, specs)
