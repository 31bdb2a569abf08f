"""Quickstart: build an assigned arch, plan tier placement, train a few
steps, then serve a few tokens — the whole public API in ~60 lines.

The port of the reference's ``examples/quickstart.py``, on ``cuda`` unless
given ``--device cpu``:

    python -m repro_torch.examples.quickstart [--device cpu]
"""

import argparse
import os
import tempfile

import numpy as np

from repro_torch.config.base import (ParallelConfig, RunConfig, ShapeConfig,
                                     get_config)
from repro_torch.core.costmodel import optimal_offload
from repro_torch.core.placement import plan_training_placement
from repro_torch.launch.serve import Request, ServeEngine
from repro_torch.launch.train import train
from repro_torch.models.context import resolve_device


def checkpoint_dir() -> str:
    """The reference's ``/tmp/quickstart_ckpt``, under the temporary
    directory that ``TMPDIR`` names. ``train`` resumes from the newest
    checkpoint there."""
    return os.path.join(tempfile.gettempdir(), "quickstart_ckpt")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    device = resolve_device(ap.parse_args(argv).device)

    # 1. pick an assigned architecture (any of the 10; reduced to train)
    cfg = get_config("yi-9b")
    print(f"arch={cfg.name}: {cfg.num_params/1e9:.1f}B params")

    # 2. the paper's technique: plan tier placement for a 256-chip pod.
    # The plan's topology and the cost model's constants below (12 GiB,
    # 8 GiB/s, 197 TFLOP/s, 819 GB/s) are the reference's TPU v5e numbers,
    # kept so that these lines can be held against the reference's; they
    # describe no property of the card this runs on.
    plan = plan_training_placement(cfg, 256)
    print(f"placement: {plan.kinds} "
          f"(HBM {plan.hbm_used/2**30:.1f}/{plan.hbm_capacity/2**30:.0f} GiB)")

    # ... and the offload split the cost model recommends for serving
    best = optimal_offload(model_bytes=2 * cfg.num_params,
                           hbm_capacity=12 << 30, link_bw=8 << 30,
                           kv_bytes_per_seq=100 << 20,
                           flops_per_token=2 * cfg.num_params,
                           peak_flops=197e12, hbm_bw=819e9)
    print(f"cost-model optimal offload: {best.offload_bytes/2**30:.1f} GiB "
          f"-> {best.tokens_per_s:.0f} tok/s ({best.bound}-bound)")

    # 3. train a reduced config for a few steps
    small = cfg.reduced()
    out = train(small, ShapeConfig("quick", 64, 4, "train"),
                RunConfig(steps=10, learning_rate=1e-3, warmup_steps=2,
                          checkpoint_dir=checkpoint_dir(), log_every=5),
                ParallelConfig(), device=device)
    print(f"train: loss {out['history'][0]:.3f} -> {out['history'][-1]:.3f}")

    # 4. serve a batch of requests (prefill through the attention kernel)
    engine = ServeEngine(small, device=device)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, small.vocab_size, 16)
                    .astype(np.int32), 8) for i in range(2)]
    results = engine.serve(reqs)
    print(f"serve: {results[0].decode_ms_per_tok:.1f} ms/tok, "
          f"sample tokens {results[0].tokens}")
    return {"config": cfg, "plan": plan, "best": best, "train": out,
            "engine": engine, "requests": reqs, "results": results}


if __name__ == "__main__":
    main()
