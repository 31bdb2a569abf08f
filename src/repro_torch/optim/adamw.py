"""AdamW with fp32 master weights and tier-aware state.

The port of the reference's ``repro/optim/adamw.py``, leaf for leaf the same
math. State layout (each a tree like params):

  params_c : bf16 compute copy (on the device, consumed by fwd/bwd)
  master   : fp32 master weights   } a placement plan may put these in
  mu, nu   : fp32 Adam moments     } pinned host memory (paper §6.1.5)

Where the reference returns new trees, the port updates ``master``, ``mu``,
``nu`` and ``params_c`` in place (``update_leaf_``): the training step feeds
it one layer slice of an offloaded leaf at a time (``training/step.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.models.params import (params_from_jax, tree_flatten,
                                       tree_map)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


class OptState(NamedTuple):
    mu: Any
    nu: Any
    count: torch.Tensor          # 0-dim int32 on the CPU


def init(master) -> OptState:
    return OptState(mu=tree_map(torch.zeros_like, master),
                    nu=tree_map(torch.zeros_like, master),
                    count=torch.zeros((), dtype=torch.int32))


def opt_state_from_jax(state, device) -> OptState:
    """The reference's ``OptState`` with numpy leaves
    (``jax.tree.map(np.asarray, opt_state)``) as the port's, mu and nu on
    ``device``."""
    return OptState(mu=params_from_jax(state.mu, device),
                    nu=params_from_jax(state.nu, device),
                    count=torch.tensor(int(state.count), dtype=torch.int32))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for _, x in tree_flatten(tree)))


@dataclasses.dataclass(frozen=True)
class StepScalars:
    """What every leaf's update shares: the step's count, clip scale and
    bias corrections, and the gradient norm they came from."""
    count: torch.Tensor
    gnorm: torch.Tensor
    scale: torch.Tensor
    b1c: torch.Tensor
    b2c: torch.Tensor


def step_scalars(grads, count: torch.Tensor, cfg: AdamWConfig
                 ) -> StepScalars:
    """The global norm over all gradients first, then the per-step
    scalars, as the reference's ``update`` computes them."""
    count = count + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9),
                        max=1.0)
    cf = count.float()
    return StepScalars(count=count, gnorm=gnorm, scale=scale,
                       b1c=1.0 - cfg.b1 ** cf, b2c=1.0 - cfg.b2 ** cf)


def update_leaf_(g, m, v, p, lr, sc: StepScalars, cfg: AdamWConfig) -> None:
    """One leaf's (or one slice's) update, in place on m, v and p."""
    g = g.float() * sc.scale
    m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
    v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
    mh = m / sc.b1c
    vh = v / sc.b2c
    step = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p
    p.sub_(lr * step)


def update(grads, state: OptState, master, lr, cfg: AdamWConfig):
    """Returns (master, params_c bf16, new state, grad_norm); ``master``,
    ``state.mu`` and ``state.nu`` are updated in place, every leaf on one
    device."""
    sc = step_scalars(grads, state.count, cfg)
    mu, nu, pm = (dict(tree_flatten(t)) for t in (state.mu, state.nu,
                                                   master))
    for path, g in tree_flatten(grads):
        update_leaf_(g, mu[path], nu[path], pm[path], lr, sc, cfg)
    params_c = tree_map(lambda p: p.to(torch.bfloat16), master)
    return master, params_c, OptState(mu=state.mu, nu=state.nu,
                                      count=sc.count), sc.gnorm
