"""End-to-end training entry point.

The port of the reference's ``repro/launch/train.py``. Wires together: the
config registry, the placement plan (tier offload: for yi-9b on one card
the reference's default topology puts ``master``, ``mu`` and ``nu`` in
pinned host memory, the paper's §6.1.5 mode), the synthetic data pipeline
with prefetch, AdamW with fp32 master, the checkpoint manager (async,
retained), fault supervision (watchdog + straggler stats) and metrics
logging. Runs on ``cuda`` by default and raises without a card; pass
``--device cpu`` (or ``device="cpu"``) for the plain PyTorch versions on
the CPU:

  python -m repro_torch.launch.train --arch yi-9b --steps 4 --batch 8 \\
      --seq 128                                   # full width, on cuda
  python -m repro_torch.launch.train --reduced --steps 10 --device cpu

``ParallelConfig.gradient_compression`` turns on the int8 cross-pod
gradient mean over ``pod_group`` (a ``torch.distributed`` process group),
when one is given.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
from functools import partial

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.config.base import (ParallelConfig, RunConfig, ShapeConfig,
                                     get_config)
from repro_torch.core.offload import OffloadStats
from repro_torch.core.placement import plan_training_placement
from repro_torch.data.synthetic import PrefetchLoader
from repro_torch.models.context import resolve_device
from repro_torch.models.model import Model
from repro_torch.optim import adamw, schedule
from repro_torch.runtime.fault import (StepSupervisor, StepTimeout,
                                       StragglerStats)
from repro_torch.training.step import init_train_state, make_train_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_step_fn(model: Model, run: RunConfig, plan=None,
                  compress: bool = False, stats: OffloadStats | None = None):
    """``train()``'s step: AdamW with ``run``'s weight decay under its
    warmup-cosine schedule, the state offloaded per ``plan``, the gradients
    int8-compressed over the model's pod group when ``compress``."""
    lr_fn = partial(schedule.warmup_cosine, peak_lr=run.learning_rate,
                    warmup_steps=run.warmup_steps, total_steps=run.steps)
    return make_train_step(
        model, adamw.AdamWConfig(weight_decay=run.weight_decay), lr_fn,
        compress_pod_grads=compress, offload_plan=plan, offload_stats=stats)


def train(cfg, shape: ShapeConfig, run: RunConfig,
          parallel: ParallelConfig = ParallelConfig(), device=None,
          pod_group=None, log=print, around_step=None) -> dict:
    """Train ``cfg`` for ``run.steps`` steps (resuming from the latest
    checkpoint in ``run.checkpoint_dir``) on ``device`` (default ``cuda``).

    ``around_step(step_idx)``, when given, returns a context manager that
    each step runs inside (a profiler for one step, say).

    Returns the loss history, the final loss and the straggler summary, as
    the reference does, plus each step's wall time (``step_s``, ending in a
    device sync), the time to draw, place and fill (or restore) the state
    (``init_s``), the optimizer stream's byte counts (``offload``) and the
    trained ``state`` (params_c, master, opt_state).
    """
    device = resolve_device(device)
    model = Model.create(cfg, parallel, device, pod_group=pod_group)
    plan = plan_training_placement(cfg, 1)
    log(f"[train] {cfg.name}: {model.num_params/1e6:.1f}M params, "
        f"placement={plan.kinds}")

    stats = OffloadStats()
    step_fn = train_step_fn(model, run, plan,
                            parallel.gradient_compression, stats)

    def synced_step(*args):
        # the supervisor's thread shares the default stream: sync inside
        # it, so the step's dt covers its device work
        out = step_fn(*args)
        _sync(device)
        return out

    mgr = CheckpointManager(run.checkpoint_dir)

    def init():
        gen = torch.Generator(device=device).manual_seed(run.seed)
        return init_train_state(model, gen, plan)
    t0 = time.perf_counter()
    (params_c, master, opt_state), start = mgr.restore_or_init(init)
    _sync(device)
    init_s = time.perf_counter() - t0
    if start:
        log(f"[train] resumed from step {start}")

    loader = PrefetchLoader(cfg, shape, start_step=start, seed=run.seed,
                            device=device)
    # the step updates the state in place: a step that timed out is waited
    # for, so that nothing writes the state while it is restored
    supervisor = StepSupervisor(min_timeout=300.0, cancel_grace=None)
    stats_s = StragglerStats()
    history, step_s = [], []
    try:
        for step_idx, batch in loader:
            if step_idx >= run.steps:
                break
            if params_c is None:
                # drawn only once the old state is released: two copies of
                # an offloaded state may not fit in pinned host memory
                params_c, master, opt_state = init()
            try:
                with (around_step(step_idx) if around_step
                      else contextlib.nullcontext()):
                    (params_c, master, opt_state, metrics), dt = \
                        supervisor.run(synced_step, params_c, master,
                                       opt_state, batch)
            except StepTimeout:
                log(f"[train] step {step_idx} timed out; restoring")
                mgr.wait()
                last = ckpt.latest_step(run.checkpoint_dir)
                if last is None:
                    params_c = master = opt_state = None
                else:           # into the state's own tensors
                    ckpt.restore(run.checkpoint_dir, last,
                                 (params_c, master, opt_state))
                continue
            if step_idx > start:        # skip the first-step outlier
                stats_s.record(dt)
            step_s.append(dt)
            loss = float(metrics["loss"])
            history.append(loss)
            if step_idx % run.log_every == 0:
                log(f"[train] step={step_idx} loss={loss:.4f} "
                    f"gnorm={float(metrics['grad_norm']):.3f} "
                    f"lr={float(metrics['lr']):.2e} dt={dt*1e3:.0f}ms")
            if run.checkpoint_every and step_idx and \
                    step_idx % run.checkpoint_every == 0:
                mgr.save(step_idx, (params_c, master, opt_state))
            if stats_s.inflated:
                log(f"[train] straggler warning: {stats_s.summary()}")
    finally:
        loader.close()
        mgr.wait()
    return {"history": history,
            "final_loss": history[-1] if history else None,
            "straggler": stats_s.summary(), "step_s": step_s,
            "init_s": init_s,
            "offload": {"bytes_to_device": stats.bytes_to_device,
                        "bytes_to_host": stats.bytes_to_host,
                        "transfers": stats.transfers},
            "state": (params_c, master, opt_state)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=RunConfig().checkpoint_dir)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = ShapeConfig("custom", args.seq, args.batch, "train")
    run = RunConfig(steps=args.steps, learning_rate=args.lr,
                    checkpoint_dir=args.ckpt_dir,
                    checkpoint_every=max(10, args.steps // 4))
    parallel = ParallelConfig(microbatches=args.microbatches)
    out = train(cfg, shape, run, parallel, device=args.device)
    print(json.dumps({"final_loss": out["final_loss"],
                      "straggler": out["straggler"]}))


if __name__ == "__main__":
    main()
