"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on a fake mesh.

The port of the reference's ``repro/launch/dryrun.py``. For each cell it
builds the cell's model on the production mesh (16x16, or 2x16x16 with
``--multi-pod``), makes fake stand-ins for every input (no memory behind
them: ``input_specs``, ``abstract_params``/``abstract_cache``,
``abstract_train_state``), runs the cell's train, prefill or decode step
over them under ``FakeTensorMode`` with the roofline walker
(``roofline/hlo_walk.py``) counting one rank's FLOPs, bytes, collective
bytes and peak of live bytes, and writes a JSON record with the
reference's keys.

The 256 or 512 ranks exist only in this process: ``main`` sets up a fake
process group (``torch.distributed``'s ``fake`` backend, no traffic)
before any model module is imported, as the reference sets its 512
placeholder devices before its first import of jax. The mesh's device
type is ``cuda`` by default: the card's program, traced with fake CUDA
tensors, which needs no card for prefill and decode. A train cell runs
autograd over those tensors, which needs a CUDA build of PyTorch; on a
CPU-only build give ``--device cpu``.

Records go to ``build/dryrun/`` (not the reference's
``experiments/dryrun/``); ``--save-hlo`` also saves the walker's op record
beside each one in place of HLO text. ``--mesh-shape``, ``--batch``,
``--seq`` and ``--attention-kernel`` trace one cell on another mesh and
shape (the one-chip prediction that ``chip_smoke.py`` holds against the
card).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k
  python -m repro_torch.launch.dryrun --arch qwen2-72b --shape decode_32k \\
      --multi-pod
  python -m repro_torch.launch.dryrun --all            # every cell, 1 pod
  python -m repro_torch.launch.dryrun --all --arch zamba2-7b --multi-pod \
      --microbatches 1                                   # one arch's cells
  python -m repro_torch.launch.dryrun --arch yi-9b --shape prefill_32k \\
      --mesh-shape 1x1 --batch 4 --seq 1024 --attention-kernel kernel
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
from functools import partial
from pathlib import Path

import numpy as np

OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"


def fake_world(world_size: int) -> None:
    """A fake default process group of ``world_size`` ranks (this process
    is rank 0; collectives move nothing)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(f"a process group of {dist.get_world_size()} "
                               f"ranks exists; the dry-run needs "
                               f"{world_size}")
        return
    dist.init_process_group("fake", rank=0, world_size=world_size,
                            store=FakeStore())


def _mesh_label(multi_pod: bool, mesh_shape=None) -> str:
    if mesh_shape:
        return "x".join(str(n) for n in mesh_shape)
    return "2x16x16" if multi_pod else "16x16"


def _tree_bytes(tree) -> int:
    from repro_torch.roofline.hlo_walk import _nbytes, _tensors
    return sum(_nbytes(t) for t in _tensors(tree))


def default_parallel(cfg, shape, multi_pod: bool, serve_2d: bool = False,
                     microbatches: int = 0, compress_pod: bool = False):
    """The reference's plan: serving uses pure TP unless the TP-sharded
    weights exceed a quarter of the reference chip's HBM (then FSDP over
    'data'); training uses FSDP with microbatches of ~8k tokens per data
    shard."""
    from repro_torch.config.base import ParallelConfig
    from repro_torch.roofline import hw
    n_micro = 1
    if shape.kind == "train":
        dp = 16 * (2 if multi_pod else 1)
        tokens_per_shard = shape.global_batch // dp * shape.seq_len
        n_micro = microbatches or max(1, tokens_per_shard // 8192)
        while shape.global_batch % (n_micro * dp) and n_micro > 1:
            n_micro //= 2
        fsdp = True
    else:
        tp_bytes = 2 * cfg.num_params / 16
        fsdp = tp_bytes > hw.HBM_CAPACITY / 4
    return ParallelConfig(fsdp=fsdp, microbatches=n_micro,
                          serve_2d_weights=serve_2d,
                          gradient_compression=compress_pod)


def _cost_dict(walk: dict) -> dict:
    """The walk's counts under the names of XLA's ``cost_analysis``."""
    return {"flops": walk["flops"], "bytes accessed": walk["bytes"]}


def _memory_dict(arg_bytes: int, peak: int) -> dict:
    """The walk's memory under the names of XLA's ``memory_analysis``: the
    inputs, the temporaries above them at the peak, and the peak."""
    return {"argument_size_in_bytes": arg_bytes,
            "temp_size_in_bytes": peak - arg_bytes,
            "peak_size_in_bytes": peak}


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               parallel=None, q_chunk: int = 512, save_hlo: bool = False,
               serve_2d: bool = False, microbatches: int = 0,
               compress_pod: bool = False, device_type: str = "cuda",
               mesh_shape=None, batch: int = 0, seq: int = 0,
               attention_kernel: str = "eager", cfg=None):
    """Trace one cell; returns its record. ``mesh_shape`` (data, model)
    replaces the production mesh, ``batch``/``seq`` the shape's sizes,
    ``cfg`` the registered config (a reduced one)."""
    import dataclasses

    import torch

    from repro_torch.config.base import get_config, get_shape
    from repro_torch.core.placement import plan_training_placement
    from repro_torch.launch.inputs import input_specs
    from repro_torch.launch.mesh import (make_mesh, make_production_mesh,
                                         num_chips)
    from repro_torch.models import moe
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw, schedule
    from repro_torch.roofline.analysis import (Roofline, collective_stats,
                                               model_flops_per_step)
    from repro_torch.roofline.hlo_walk import analyze
    from repro_torch.training.step import (abstract_train_state,
                                           make_train_step)

    cfg = cfg or get_config(arch)
    shape = get_shape(shape_name)
    if batch or seq:
        shape = dataclasses.replace(shape, global_batch=batch or
                                    shape.global_batch,
                                    seq_len=seq or shape.seq_len)
    label = _mesh_label(multi_pod, mesh_shape)
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return {"arch": arch, "shape": shape_name, "mesh": label,
                "status": "skip(full-attn)",
                "note": "long_500k needs sub-quadratic attention"}
    if mesh_shape:
        mesh = make_mesh(tuple(mesh_shape), ("data", "model"), device_type)
    else:
        mesh = make_production_mesh(multi_pod=multi_pod,
                                    device_type=device_type)
    chips = num_chips(mesh)
    if parallel is None:
        parallel = default_parallel(cfg, shape, multi_pod, serve_2d,
                                    microbatches, compress_pod)
    parallel = dataclasses.replace(parallel,
                                   attention_kernel=attention_kernel)
    seq_sharded = shape_name == "long_500k"
    model = Model.create(cfg, parallel, mesh=mesh,
                         seq_sharded_cache=seq_sharded)
    mctx = model.mctx
    batch_t = input_specs(cfg, shape, mctx)

    if shape.kind == "train":
        plan = plan_training_placement(cfg, chips)
        params_c, master, opt_state = abstract_train_state(model, plan)
        lr_fn = partial(schedule.warmup_cosine, peak_lr=3e-4,
                        warmup_steps=100, total_steps=10000)
        step = make_train_step(model, adamw.AdamWConfig(), lr_fn,
                               compress_pod_grads=(
                                   parallel.gradient_compression),
                               offload_plan=plan)
        fn, args = step, (params_c, master, opt_state, batch_t)
        placement = {"kinds": plan.kinds,
                     "hbm_used_gib": round(plan.hbm_used / 2**30, 2),
                     "host_used_gib": round(plan.host_used / 2**30, 2),
                     "notes": plan.notes}
    elif shape.kind == "prefill":
        params = model.abstract_params(dtype=torch.bfloat16)
        fn, args = (lambda p, b: model.prefill(p, b)), (
            params, batch_t)
        placement = {"kinds": {"params": "device"}}
    else:  # decode
        params = model.abstract_params(dtype=torch.bfloat16)
        cache = model.abstract_cache(shape.global_batch, shape.seq_len)
        pos = shape.seq_len - 1
        fn, args = (lambda p, c, t: model.decode(p, c, t, pos)), (
            params, cache, batch_t["tokens"])
        placement = {"kinds": {"params": "device", "cache": "device"},
                     "seq_sharded_cache": seq_sharded}

    arg_bytes = _tree_bytes(args)
    moe.BODY_CALLS.update(ep=0, tp=0)
    t0 = time.time()
    walk = analyze(fn, *args, record=True)
    t_trace = time.time() - t0
    ops = walk.pop("op_record")
    peak = walk.pop("peak_bytes")
    memory = _memory_dict(arg_bytes, peak)
    mf = model_flops_per_step(cfg, shape, chips,
                              backward=(shape.kind == "train"))
    roof = Roofline.build(
        arch=arch, shape=shape_name, mesh=label, flops=walk["flops"],
        hbm_bytes=walk["bytes"], collective_bytes=walk["collective_bytes"],
        model_flops=mf, peak_memory=memory["temp_size_in_bytes"],
        collective_detail=walk["collectives_by_kind"])
    rec = {"arch": arch, "shape": shape_name, "mesh": label,
           "status": "ok", "chips": chips,
           "batch": shape.global_batch, "seq_len": shape.seq_len,
           "parallel": dataclasses.asdict(parallel),
           "lower_s": round(t_trace, 1), "compile_s": 0.0,
           "cost_analysis": _cost_dict(walk),
           "memory_analysis": memory,
           "hlo_walk": {k: v for k, v in walk.items() if k != "warnings"},
           "hlo_walk_warnings": walk["warnings"],
           "collective_stats": collective_stats(ops),
           "param_bytes_per_chip": _tree_bytes(args[0]),
           "moe_bodies": dict(moe.BODY_CALLS),
           "placement": placement,
           "roofline": roof.to_json()}
    if save_hlo:
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        rec["hlo_path"] = str(OUT_DIR / f"{arch}_{shape_name}_{label}.ops")
        Path(rec["hlo_path"]).write_text(
            "\n".join(f"{op}\t{what}\t{nb}" for op, what, nb in ops))
    return rec


def run_and_save(arch, shape_name, multi_pod, tag="", **kw):
    label = _mesh_label(multi_pod, kw.get("mesh_shape"))
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    suffix = f"_{tag}" if tag else ""
    out = OUT_DIR / f"{arch}_{shape_name}_{label}{suffix}.json"
    try:
        rec = lower_cell(arch, shape_name, multi_pod, **kw)
    except Exception as e:      # noqa: BLE001
        rec = {"arch": arch, "shape": shape_name, "mesh": label,
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
    out.write_text(json.dumps(rec, indent=2, default=str))
    status = rec["status"]
    extra = ""
    if status == "ok":
        r = rec["roofline"]
        extra = (f" bottleneck={r['bottleneck']}"
                 f" frac={r['roofline_fraction']:.3f}"
                 f" trace={rec['lower_s']}s")
        print(json.dumps(rec["memory_analysis"]))
        print(json.dumps(rec["cost_analysis"]))
    print(f"[dryrun] {arch} {shape_name} {label}: {status}{extra}",
          flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--save-hlo", action="store_true",
                    help="save the walker's op record beside each record")
    ap.add_argument("--q-chunk", type=int, default=512)
    ap.add_argument("--serve-2d", action="store_true")
    ap.add_argument("--compress-pod-grads", action="store_true")
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--tag", default="", help="suffix for the output json")
    ap.add_argument("--device", default="cuda",
                    help="the mesh's device type (cuda, or cpu)")
    ap.add_argument("--mesh-shape", default=None,
                    help="DATAxMODEL in place of the production mesh")
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--attention-kernel", default="eager",
                    choices=("eager", "kernel"))
    args = ap.parse_args(argv)

    mesh_shape = (tuple(int(n) for n in args.mesh_shape.split("x"))
                  if args.mesh_shape else None)
    world = (int(np.prod(mesh_shape)) if mesh_shape
             else (512 if args.multi_pod else 256))
    fake_world(world)           # before any model module is imported

    from repro_torch.config.base import SHAPES, list_archs
    kw = dict(q_chunk=args.q_chunk, save_hlo=args.save_hlo,
              device_type=args.device, mesh_shape=mesh_shape,
              batch=args.batch, seq=args.seq,
              attention_kernel=args.attention_kernel,
              microbatches=args.microbatches)
    if args.all:
        for arch in ([args.arch] if args.arch else list_archs()):
            for shape_name in SHAPES:
                run_and_save(arch, shape_name, args.multi_pod, **kw)
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        rec = run_and_save(args.arch, args.shape, args.multi_pod,
                           serve_2d=args.serve_2d,
                           compress_pod=args.compress_pod_grads,
                           tag=args.tag, **kw)
        if rec["status"] not in ("ok",) and not rec["status"].startswith(
                "skip"):
            raise SystemExit(1)


if __name__ == "__main__":
    main()
