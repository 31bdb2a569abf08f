"""The train step: grads -> (optionally compressed) reduction -> AdamW.

The port of the reference's ``repro/training/step.py``. Where the reference
expresses tier placement through the shardings of a jitted step, the port
moves the bytes itself: with an offload plan, the update streams each
offloaded state group (``master``, ``mu``, ``nu`` in ``pinned_host``, the
paper's §6.1.5 mode) from pinned host memory one layer slice of a stacked
leaf at a time: the slice is copied to the device (``non_blocking``),
updated, and copied back, so no whole offloaded leaf (8.7 GB of fp32 for a
yi-9b MLP weight) is ever on the device. The AdamW math is elementwise, so
slicing does not change it.

``compress_pod_grads`` with a pod group (``MCtx.pod_group``, the
counterpart of a ``pod`` mesh axis) replaces the cross-pod gradient
all-reduce with an int8 all-gather and a local mean
(``core.compression.compressed_pod_mean``), leaf by leaf, each bf16
gradient freed as soon as its fp32 mean exists; loss and parts are averaged
over the group.

With a mesh the state is DTensors placed by the sharding rules; each
gradient comes back summed over the ranks that share it and is
redistributed to its parameter's placements (the data-parallel reduction:
a reduce-scatter under FSDP) before the update. ``abstract_train_state``
gives the dry-run's fake state.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.core.compression import compressed_pod_mean
from repro_torch.core.offload import OffloadStats, host_zeros, put_tree
from repro_torch.models import params as pm
from repro_torch.models.model import Model
from repro_torch.models.transformer import loss_fn
from repro_torch.optim import adamw


def _pmean(x: torch.Tensor, group) -> torch.Tensor:
    y = x.clone()
    dist.all_reduce(y, group=group)
    return y / dist.get_world_size(group)


def compute_grads(model: Model, params_c, batch,
                  compress_pod_grads: bool = False):
    """Returns ((loss, parts), grads); grads are bf16 like ``params_c``, or
    fp32 cross-pod means under ``compress_pod_grads`` with a pod group."""
    cfg, mctx = model.cfg, model.mctx
    flat = pm.tree_flatten(params_c)
    paths = [path for path, _ in flat]
    leaves = [p.detach().requires_grad_() for _, p in flat]
    loss, parts = loss_fn(pm.tree_unflatten(paths, leaves), cfg, mctx, batch)
    # a leaf the loss does not read (a segment of no layers, as reduced
    # gemma3's) gets a zero gradient, as under jax.grad
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(
        leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
    if model.mctx.mesh is not None:
        grads = [g.redistribute(x.device_mesh, x.placements)
                 if isinstance(g, DTensor) else g
                 for x, g in zip(leaves, grads)]
    del leaves
    loss, parts = loss.detach(), {k: v.detach() for k, v in parts.items()}
    group = mctx.pod_group
    if compress_pod_grads and group is not None:
        for i in range(len(grads)):
            grads[i] = compressed_pod_mean(grads[i], group)
        loss = _pmean(loss, group)
        parts = {k: _pmean(v, group) for k, v in parts.items()}
    return (loss, parts), pm.tree_unflatten(paths, grads)


def _split_microbatches(batch: dict, n: int) -> dict:
    """Reshape every batch leaf to (n, B/n, ...) on its batch dim. A
    DTensor leaf splits each rank's own rows (microbatch j is every rank's
    j-th slice), so no rows move between ranks."""
    out = {}
    for k, v in batch.items():
        B = v.shape[0]
        if B % n:
            raise ValueError(f"{k}: batch {B} % microbatches {n} != 0")
        if isinstance(v, DTensor):
            loc = v.to_local()
            if loc.shape[0] % n:
                raise ValueError(f"{k}: local batch {loc.shape[0]} % "
                                 f"microbatches {n} != 0")
            loc = loc.reshape(n, loc.shape[0] // n, *loc.shape[1:])
            out[k] = [DTensor.from_local(m, v.device_mesh, v.placements,
                                         run_check=False)
                      for m in torch.unbind(loc)]
            continue
        out[k] = v.reshape(n, B // n, *v.shape[1:])
    return out


def make_train_step(model: Model, hyper: adamw.AdamWConfig,
                    lr_fn: Callable, compress_pod_grads: bool = False,
                    offload_plan=None,
                    offload_stats: Optional[OffloadStats] = None):
    """step(params_c, master, opt_state, batch) ->
    (params_c, master, opt_state, metrics), updating the state in place.

    With parallel.microbatches > 1, gradients accumulate in fp32 over the
    microbatches (live activations shrink by the same factor).

    With an offload placement plan, each host-resident group is streamed
    through the device one layer slice at a time; ``offload_stats`` (when
    given) counts the bytes each way.
    """
    n_micro = model.mctx.parallel.microbatches
    kinds = offload_plan.memory_kinds() if offload_plan else {}
    dev = model.device
    stacked = {path: spec.axes[0] == "layers"
               for path, spec in pm.tree_flatten(model.specs)}

    def offloaded(group: str) -> bool:
        return kinds.get(group, "device") != "device"

    def to_device(x: torch.Tensor, group: str) -> torch.Tensor:
        if not offloaded(group):
            return x
        if offload_stats is not None:
            offload_stats.record(x, "to_device")
        return x.to(dev, non_blocking=True)

    def to_home(home: torch.Tensor, x: torch.Tensor, group: str) -> None:
        if not offloaded(group):
            return
        if offload_stats is not None:
            offload_stats.record(x, "to_host")
        home.copy_(x, non_blocking=True)

    def grads_of(params_c, batch):
        return compute_grads(model, params_c, batch,
                             compress_pod_grads=compress_pod_grads)

    def step(params_c, master, opt_state: adamw.OptState, batch):
        if n_micro > 1:
            mbs = _split_microbatches(batch, n_micro)
            zero = torch.zeros((), dtype=torch.float32, device=dev)
            acc, loss, ce, aux = None, zero, zero, zero
            for j in range(n_micro):
                (l, parts), g = grads_of(params_c,
                                         {k: v[j] for k, v in mbs.items()})
                if acc is None:
                    acc = pm.tree_map(lambda g: torch.zeros_like(
                        g, dtype=torch.float32), g)
                acc = pm.tree_map(lambda a, g: a + g.float(), acc, g)
                loss, ce, aux = (loss + l, ce + parts["ce"],
                                 aux + parts["aux"])
            grads = pm.tree_map(lambda g: g / n_micro, acc)
            loss, ce, aux = loss / n_micro, ce / n_micro, aux / n_micro
            parts = {"ce": ce, "aux": aux}
        else:
            (loss, parts), grads = grads_of(params_c, batch)
        lr = lr_fn(opt_state.count)
        sc = adamw.step_scalars(grads, opt_state.count, hyper)
        homes = {name: dict(pm.tree_flatten(t)) for name, t in
                 (("master", master), ("mu", opt_state.mu),
                  ("nu", opt_state.nu), ("params", params_c))}
        for path, g in pm.tree_flatten(grads):
            for i in range(g.shape[0]) if stacked[path] else (None,):
                part = {name: h[path] if i is None else h[path][i]
                        for name, h in homes.items()}
                m = to_device(part["mu"], "mu")
                v = to_device(part["nu"], "nu")
                p = to_device(part["master"], "master")
                adamw.update_leaf_(g if i is None else g[i], m, v, p, lr,
                                   sc, hyper)
                part["params"].copy_(p)
                to_home(part["mu"], m, "mu")
                to_home(part["nu"], v, "nu")
                to_home(part["master"], p, "master")
        del grads
        metrics = {"loss": loss, "ce": parts["ce"], "aux": parts["aux"],
                   "grad_norm": sc.gnorm, "lr": lr}
        return params_c, master, adamw.OptState(
            mu=opt_state.mu, nu=opt_state.nu, count=sc.count), metrics

    return step


def init_train_state(model: Model, generator: torch.Generator,
                     plan=None):
    """(params_c bf16, master fp32, opt_state), drawn on the model's device
    from ``generator``; with a placement plan, ``master``, ``mu`` and
    ``nu`` are put in their planned memory kinds (``pinned_host`` is
    page-locked CPU memory for a CUDA model)."""
    kinds = plan.memory_kinds() if plan else {}
    dev = model.device
    master = pm.init_params(model.specs, generator, dev, torch.float32)
    params_c = pm.tree_map(lambda p: p.to(torch.bfloat16), master)
    master = put_tree(master, kinds.get("master", "device"), dev)

    def zeros(kind: str):
        if kind == "device":
            return pm.tree_map(lambda p: torch.zeros(p.shape, dtype=p.dtype,
                                                     device=dev), master)
        return pm.tree_map(lambda p: host_zeros(p.shape, p.dtype, dev),
                           master)
    opt_state = adamw.OptState(mu=zeros(kinds.get("mu", "device")),
                               nu=zeros(kinds.get("nu", "device")),
                               count=torch.zeros((), dtype=torch.int32))
    return params_c, master, opt_state


def abstract_train_state(model: Model, plan):
    """Fake (params_c bf16, master fp32, opt_state) trees placed by the
    sharding rules, each leaf recording the placement plan's memory kind
    (``memory_kind``; a fake tensor cannot be pinned) — dry-run inputs."""
    kinds = plan.memory_kinds()

    def tree(dtype, kind):
        mk = None if kind == "device" else kind
        return pm.map_specs(lambda s: pm.abstract_leaf(
            s.shape, dtype, model.param_sharding(s, mk)), model.specs)

    params_c = tree(torch.bfloat16, kinds["params"])
    master = tree(torch.float32, kinds["master"])
    mu = tree(torch.float32, kinds["mu"])
    nu = tree(torch.float32, kinds["nu"])
    count = pm.abstract_leaf((), torch.int32,
                             device=model.mctx.mesh.device_type)
    return params_c, master, adamw.OptState(mu=mu, nu=nu, count=count)
