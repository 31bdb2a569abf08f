"""HEIMDALL application benchmarks (paper §6) — one per paper experiment.

The port of the reference's ``repro/heimdall/apps.py``, with its row names
and derived keys. These exercise the real framework stack: the
reduced-config LM decode loop under different tier placements (Fig 21/23),
the offload-split sweep (Table 5) beside the cost model, the vector-DB
top-k workload (Fig 25-27), and KV get/set workloads (Fig 28-30). The tiny
yi-9b is built with ``Model.create`` on one device (the reference's host
mesh comes with the mesh slice). Every function takes ``device`` (default
``cuda``; raises without one); a host tier is pinned host memory there and
plain RAM on ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.config.base import ParallelConfig, get_config
from repro_torch.heimdall.harness import Row, place, time_fn
from repro_torch.models.context import resolve_device
from repro_torch.models.model import Model
from repro_torch.models.params import (tree_flatten, tree_map,
                                       tree_unflatten)


def _tiny_model(device, arch: str = "yi-9b"):
    cfg = get_config(arch).reduced(num_layers=4, d_model=128, head_dim=32,
                                   d_ff=256)
    model = Model.create(cfg, ParallelConfig(remat="none"), device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init(gen, dtype=torch.bfloat16)
    return cfg, model, params


def _decode_run(model, params_of_step, cache0, batch: int, pos0: int,
                steps: int, device):
    """Greedy decode of ``steps`` tokens from a copy of ``cache0``;
    ``params_of_step()`` gives each step's weights on the device."""
    cache = tree_map(torch.clone, cache0)
    tok = torch.ones((batch, 1), dtype=torch.int32, device=device)
    for s in range(steps):
        logits, cache = model.decode(params_of_step(), cache, tok, pos0 + s)
        tok = torch.argmax(logits, -1).to(torch.int32)
    return tok


# -- Fig 21/23: decode tokens/s under tier placements ------------------------


def app_llm_inference(steps: int = 8, batch: int = 4,
                      prompt: int = 64, device=None) -> list:
    device = resolve_device(device)
    cfg, model, params = _tiny_model(device)
    rows = []
    tokens = torch.ones((batch, prompt), dtype=torch.int32, device=device)
    _, cache0 = model.prefill(params, {"tokens": tokens},
                              max_len=tokens.shape[1] + steps)

    for tier in ("hbm", "host"):
        p_tier = tree_map(lambda a: place(a, tier, device), params)

        def weights():
            if tier == "host":
                return tree_map(lambda a: place(a, "hbm", device), p_tier)
            return p_tier

        t = time_fn(lambda: _decode_run(model, weights, cache0, batch,
                                        prompt, steps, device),
                    warmup=1, iters=3)
        tps = steps * batch / t
        rows.append(Row(f"app_llm_inference/{tier}", t * 1e6,
                        f"tok_s={tps:.1f}"))
    return rows


# -- Table 5: offload-split sweep, validated against the cost model ------------


def app_offload_sweep(steps: int = 4, batch: int = 2, device=None) -> list:
    from repro_torch.core.costmodel import offload_sweep
    device = resolve_device(device)
    cfg, model, params = _tiny_model(device)
    rows = []
    flat = tree_flatten(params)
    sizes = [x.numel() * x.element_size() for _, x in flat]
    total = sum(sizes)
    tokens = torch.ones((batch, 32), dtype=torch.int32, device=device)
    _, cache0 = model.prefill(params, {"tokens": tokens},
                              max_len=tokens.shape[1] + steps)

    for frac in (0.0, 0.5, 1.0):
        budget = total * frac
        placed, acc = [], 0
        for (_, x), s in zip(flat, sizes):
            tier = "host" if acc < budget else "hbm"
            acc += s
            placed.append(place(x, tier, device))
        p_tier = tree_unflatten([p for p, _ in flat], placed)

        def weights():
            return tree_map(lambda a: place(a, "hbm", device), p_tier)

        t = time_fn(lambda: _decode_run(model, weights, cache0, batch, 32,
                                        steps, device),
                    warmup=1, iters=3)
        rows.append(Row(f"app_offload_sweep/frac={frac}", t * 1e6,
                        f"tok_s={steps*batch/t:.1f}"))
    # cost-model reference curve (the paper's Table 5 shape)
    pts = offload_sweep(model_bytes=130 << 30, hbm_capacity=72 << 30,
                        link_bw=25 << 30, kv_bytes_per_seq=200 << 20,
                        flops_per_token=2 * 70e9, peak_flops=900e12,
                        hbm_bw=3 << 40, max_concurrency=150, n_points=5)
    for p in pts:
        rows.append(Row(f"app_offload_model/offload={p.offload_bytes>>30}GiB",
                        0.0, f"model_tok_s={p.tokens_per_s:.1f};{p.bound}"))
    return rows


# -- Fig 25-27: vector DB top-k ------------------------------------------------


def app_vectordb(n_vecs: int = 4096, dim: int = 128, k: int = 10,
                 queries: int = 16, device=None) -> list:
    device = resolve_device(device)
    rows = []
    rng = np.random.default_rng(0)
    db = torch.from_numpy(rng.normal(size=(n_vecs, dim)).astype(np.float32))
    qs = torch.from_numpy(
        rng.normal(size=(queries, dim)).astype(np.float32)).to(device)

    def topk(db_, q_):
        return torch.topk(q_ @ db_.T, k)

    for tier in ("hbm", "host"):
        db_t = place(db, tier, device)

        def run(q_):
            db_dev = place(db_t, "hbm", device) if tier == "host" else db_t
            return tuple(topk(db_dev, q_))

        t = time_fn(run, qs)
        rows.append(Row(f"app_vectordb/{tier}", t * 1e6,
                        f"qps={queries/t:.0f}"))
    return rows


# -- Fig 28-30: KV workload ------------------------------------------------------


def app_kv_workload(n_keys: int = 1 << 14, dim: int = 64,
                    ops: int = 1 << 10, device=None) -> list:
    device = resolve_device(device)
    rows = []
    rng = np.random.default_rng(0)
    store = torch.from_numpy(
        rng.normal(size=(n_keys, dim)).astype(np.float32))
    get_idx = torch.from_numpy(
        rng.integers(0, n_keys, ops).astype(np.int64)).to(device)
    set_idx = torch.from_numpy(
        rng.integers(0, n_keys, ops).astype(np.int64)).to(device)
    vals = torch.from_numpy(
        rng.normal(size=(ops, dim)).astype(np.float32)).to(device)

    def get(s, i):
        return s[i].sum()

    def set_(s, i, v):
        return s.index_put((i,), v)

    for tier in ("hbm", "host"):
        s = place(store, tier, device)

        def get_t(s_, i):
            return get(place(s_, "hbm", device), i)      # tier fetch + op

        def set_t(s_, i, v):
            return place(set_(place(s_, "hbm", device), i, v), tier, device)

        tg = time_fn(get_t, s, get_idx)
        ts = time_fn(set_t, s, set_idx, vals)
        rows.append(Row(f"app_kv/{tier}/get", tg * 1e6,
                        f"ops_s={ops/tg:.0f}"))
        rows.append(Row(f"app_kv/{tier}/set", ts * 1e6,
                        f"ops_s={ops/ts:.0f}"))
    return rows


ALL_APPS = [app_llm_inference, app_offload_sweep, app_vectordb,
            app_kv_workload]
