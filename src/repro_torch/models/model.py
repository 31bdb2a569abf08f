"""Model facade: ties configs, specs, parameters and step functions together.

``Model`` is an ``nn.Module``: ``init`` draws the parameter tree and holds
it as frozen ``nn.Parameter``s in nested submodules named by the tree's
keys, so ``model.parameters()`` and ``model.to()`` see every leaf;
``model.params`` reads it back as the nested dict the step functions take.
The step functions take the tree explicitly, as the reference's do, so
weights carried over from the reference (``params_from_jax``) can be
passed in.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.config.base import ModelConfig, ParallelConfig
from repro_torch.models import params as pm
from repro_torch.models.context import MCtx, resolve_device
from repro_torch.models.decode import cache_specs, decode_step, prefill
from repro_torch.models.transformer import model_specs


class Model(nn.Module):

    def __init__(self, cfg: ModelConfig, mctx: MCtx):
        super().__init__()
        self.cfg = cfg
        self.mctx = mctx
        self.tree = nn.Module()

    @classmethod
    def create(cls, cfg: ModelConfig,
               parallel: ParallelConfig = ParallelConfig(),
               device=None, pod_group=None) -> "Model":
        """A model on ``device`` (default ``cuda``; raises without one);
        ``pod_group`` is the process group of the training step's
        cross-pod gradient mean, or None."""
        return cls(cfg, MCtx(parallel, resolve_device(device), pod_group))

    # -- specs ------------------------------------------------------------
    @property
    def specs(self) -> dict:
        return model_specs(self.cfg)

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
        """Hold ``params`` (a nested dict of tensors) as the module's tree."""
        self.tree = _as_module(params)

    @property
    def params(self) -> dict:
        return _as_dict(self.tree)

    def init_cache(self, B: int, S: int) -> dict:
        return pm.map_specs(
            lambda s: torch.zeros(s.shape, dtype=pm.torch_dtype(s.dtype),
                                  device=self.device),
            cache_specs(self.cfg, self.mctx, B, S))

    # -- steps ----------------------------------------------------------------
    def prefill(self, params, batch, max_len: int = 0):
        return prefill(params, self.cfg, self.mctx, batch, max_len=max_len)

    def decode(self, params, cache, tokens, pos):
        return decode_step(params, self.cfg, self.mctx, cache, tokens, pos)

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
