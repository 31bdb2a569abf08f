"""End-to-end driver: train a ~100M-param LM on the synthetic stream.

The port of the reference's ``examples/train_tiny_lm.py``, on ``cuda``
unless given ``--device cpu``. Full deliverable invocation (a few hundred
steps):

    python -m repro_torch.examples.train_tiny_lm --steps 300

CPU smoke (CI-sized):

    python -m repro_torch.examples.train_tiny_lm --steps 20 --tiny \\
        --device cpu
"""

import argparse
import dataclasses
import json
import os
import tempfile

from repro_torch.config.base import (ModelConfig, ParallelConfig, RunConfig,
                                     ShapeConfig, get_config)
from repro_torch.launch.train import train
from repro_torch.models.context import resolve_device


def lm_100m() -> ModelConfig:
    """~100M llama-style config (yi-9b family, scaled down)."""
    return dataclasses.replace(
        get_config("yi-9b"), name="lm-100m", num_layers=10, d_model=640,
        num_heads=10, num_kv_heads=5, head_dim=64, d_ff=1792,
        vocab_size=32000)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--tiny", action="store_true",
                    help="shrink to CI size")
    # the reference's /tmp/lm100m_ckpt, under the directory TMPDIR names
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "lm100m_ckpt"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = lm_100m()
    if args.tiny:
        cfg = cfg.reduced()
        args.seq, args.batch = 64, 4
    print(f"{cfg.name}: ~{cfg.num_params/1e6:.0f}M params, "
          f"{args.steps} steps @ batch={args.batch} seq={args.seq}")

    out = train(cfg, ShapeConfig("lm", args.seq, args.batch, "train"),
                RunConfig(steps=args.steps, learning_rate=args.lr,
                          warmup_steps=max(10, args.steps // 20),
                          checkpoint_dir=args.ckpt_dir,
                          checkpoint_every=max(50, args.steps // 4),
                          log_every=10),
                ParallelConfig(remat="full", microbatches=1), device=device)
    h = out["history"]
    print(json.dumps({"first_loss": round(h[0], 4),
                      "final_loss": round(h[-1], 4),
                      "improved": h[-1] < h[0]}))
    return out


if __name__ == "__main__":
    main()
