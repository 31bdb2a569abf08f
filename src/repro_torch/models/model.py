"""Model facade: ties configs, specs, parameters and step functions together.

``Model`` is an ``nn.Module``: ``init`` draws the parameter tree and holds
it as frozen ``nn.Parameter``s in nested submodules named by the tree's
keys, so ``model.parameters()`` and ``model.to()`` see every leaf;
``model.params`` reads it back as the nested dict the step functions take.
The step functions take the tree explicitly, as the reference's do, so
weights carried over from the reference (``params_from_jax``) can be
passed in.

With a mesh (``Model.create(..., mesh=...)``) every leaf is a DTensor
placed by the sharding rules (``param_sharding``): ``init`` draws each
leaf whole and keeps this rank's shard, ``set_params`` wraps a plain leaf
around this rank's shard of it (on a one-rank mesh the tensor itself, no
copy), and caches are DTensors too. ``prefill`` and ``decode``, the
serving roles, run under ``serve_mctx``: off a mesh their MoE layers are
dropless (``models/moe.py``); ``loss`` keeps the capacity body.
``abstract_params`` and ``abstract_cache`` are the dry-run's fake trees.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from repro_torch.config.base import ModelConfig, ParallelConfig
from repro_torch.models import params as pm
from repro_torch.models.context import MCtx, resolve_device
from repro_torch.models.decode import (cache_specs, decode_step, prefill,
                                      zeros_cache)
from repro_torch.models.sharding import distribute, named_sharding
from repro_torch.models.transformer import loss_fn, model_specs


class Model(nn.Module):

    def __init__(self, cfg: ModelConfig, mctx: MCtx):
        super().__init__()
        self.cfg = cfg
        self.mctx = mctx
        self.tree = nn.Module()

    @classmethod
    def create(cls, cfg: ModelConfig,
               parallel: ParallelConfig = ParallelConfig(),
               device=None, pod_group=None, mesh=None,
               seq_sharded_cache: bool = False) -> "Model":
        """A model on ``device`` (default ``cuda``; raises without one);
        ``pod_group`` is the process group of the training step's
        cross-pod gradient mean, or None. With a ``DeviceMesh`` the model
        runs the mesh path on the mesh's device type."""
        if mesh is not None:
            if device is None and mesh.device_type == "cuda":
                dev = torch.device("cuda")     # a fake mesh needs no card
            else:
                dev = resolve_device(device or mesh.device_type)
            if dev.type != mesh.device_type:
                raise ValueError(f"device {dev} is not on the "
                                 f"{mesh.device_type} mesh")
        else:
            dev = resolve_device(device)
        return cls(cfg, MCtx(parallel, dev, pod_group, mesh=mesh,
                             seq_sharded_cache=seq_sharded_cache))

    # -- specs ------------------------------------------------------------
    @property
    def specs(self) -> dict:
        return model_specs(self.cfg, self.mctx.mesh)

    def param_sharding(self, spec: pm.ParamSpec, memory_kind=None):
        return named_sharding(self.mctx.mesh, self.mctx.rules, spec.axes,
                              spec.shape, memory_kind=memory_kind)

    def abstract_params(self, memory_kinds: Optional[dict] = None,
                        dtype: Optional[torch.dtype] = None) -> dict:
        """Fake DTensors with the rules' placements (dry-run inputs).

        ``memory_kinds``: optional {top-level group: kind}, recorded on
        each leaf; ``dtype`` overrides the specs' (e.g. bf16 serving)."""
        def mk(path, s: pm.ParamSpec):
            kind = (memory_kinds or {}).get(path[0])
            kind = None if kind == "device" else kind
            return pm.abstract_leaf(s.shape, dtype or pm.torch_dtype(s.dtype),
                                    self.param_sharding(s, kind))
        return _tree_map_with_path(mk, self.specs)

    def abstract_cache(self, B: int, S: int) -> dict:
        cspecs = cache_specs(self.cfg, self.mctx, B, S)
        return _tree_map_with_path(
            lambda path, s: pm.abstract_leaf(
                s.shape, pm.torch_dtype(s.dtype), self.param_sharding(s)),
            cspecs)

    @property
    def device(self) -> torch.device:
        return self.mctx.device

    # -- init ---------------------------------------------------------------
    def init(self, generator: torch.Generator,
             dtype: torch.dtype | None = None) -> dict:
        """Draw the parameter tree on the model's device from ``generator``
        (a generator on that device), keep it on the module, return it."""
        self.set_params(pm.init_params(self.specs, generator, self.device,
                                       dtype))
        return self.params

    def set_params(self, params: dict) -> None:
        """Hold ``params`` (a nested dict of tensors) as the module's tree;
        on a mesh each leaf as a DTensor placed by the rules."""
        if self.mctx.mesh is not None:
            params = self._placed(params)
        self.tree = _as_module(params)

    def _placed(self, params: dict) -> dict:
        def put(path, s: pm.ParamSpec):
            leaf = params
            for k in path:
                leaf = leaf[k]
            return distribute(leaf, self.mctx.mesh,
                              self.param_sharding(s).placements)
        return _tree_map_with_path(put, self.specs)

    @property
    def params(self) -> dict:
        return _as_dict(self.tree)

    def init_cache(self, B: int, S: int) -> dict:
        return pm.map_specs(lambda s: zeros_cache(s, self.mctx, self.device),
                            cache_specs(self.cfg, self.mctx, B, S))

    # -- steps ----------------------------------------------------------------
    def loss(self, params, batch):
        return loss_fn(params, self.cfg, self.mctx, batch)

    @property
    def serve_mctx(self) -> MCtx:
        """The serving roles' context: the model's, with dropless MoE
        layers (the same ``stats`` dict)."""
        return dataclasses.replace(self.mctx, dropless=True)

    def prefill(self, params, batch, max_len: int = 0):
        return prefill(params, self.cfg, self.serve_mctx, batch,
                       max_len=max_len)

    def decode(self, params, cache, tokens, pos):
        return decode_step(params, self.cfg, self.serve_mctx, cache, tokens,
                           pos)

    @property
    def num_params(self) -> int:
        return pm.count_params(self.specs)


def _as_module(tree: dict) -> nn.Module:
    m = nn.Module()
    for k, v in tree.items():
        if isinstance(v, dict):
            m.add_module(k, _as_module(v))
        else:
            m.register_parameter(k, nn.Parameter(v, requires_grad=False))
    return m


def _as_dict(m: nn.Module) -> dict:
    out: dict = {k: p for k, p in m.named_parameters(recurse=False)}
    out.update({k: _as_dict(c) for k, c in m.named_children()})
    return out


def _tree_map_with_path(fn, tree, path=()):
    if isinstance(tree, pm.ParamSpec):
        return fn(path, tree)
    return {k: _tree_map_with_path(fn, v, path + (k,))
            for k, v in tree.items()}
