"""Batched serving with tiered weight placement (paper §6.1).

Compares HBM-resident weights vs paper-faithful host offload (sync
copy-on-demand) — Fig 21/23 at example scale. The port of the reference's
``examples/serve_batched.py``, on ``cuda`` unless given ``--device cpu``:

    python -m repro_torch.examples.serve_batched [--device cpu]
"""

import argparse
import json
import time

import numpy as np

from repro_torch.config.base import get_config
from repro_torch.launch.serve import Request, ServeEngine
from repro_torch.models.context import resolve_device


def bench(engine, reqs):
    t0 = time.perf_counter()
    results = engine.serve([Request(r.rid, r.prompt, r.max_new)
                            for r in reqs])
    wall = time.perf_counter() - t0
    total = sum(len(r.tokens) for r in results)
    return {"tok_s": round(total / wall, 1),
            "prefill_ms": round(results[0].prefill_ms, 1),
            "ms_per_tok": round(results[0].decode_ms_per_tok, 2)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    device = resolve_device(ap.parse_args(argv).device)

    cfg = get_config("yi-9b").reduced(num_layers=4, d_model=128,
                                      head_dim=32, d_ff=256)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size,
                                    48 - 4 * (i % 3)).astype(np.int32), 16)
            for i in range(4)]

    out = {}
    out["hbm"] = bench(ServeEngine(cfg, device=device), reqs)
    out["host_sync_offload"] = bench(
        ServeEngine(cfg, offload_weights=True, device=device), reqs)
    print(json.dumps(out, indent=1))
    print("paper Fig 21: DRAM-resident > CXL-resident tokens/s — the same "
          "ordering is expected above (on a CUDA card the offloaded "
          "engine fetches every weight over the pinned-host link on each "
          "call; on the CPU both tiers are the same RAM).")
    return out


if __name__ == "__main__":
    main()
