#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, one JSON line each:

  device   the card (nvidia-smi name and power limit), torch and CUDA versions
  build    the flash attention kernel compiled by nvcc for sm_90a from
           src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu
  kernel   the kernel held against its plain PyTorch version at the
           kernel sweep shapes and the yi-9b prefill shape, fp32 and bf16;
           at the yi-9b shape in bf16 its time beside the plain version's,
           one scaled_dot_product_attention call (a yardstick only; the port
           never calls it) and the least time the card could take
  serve    ServeEngine for full-width yi-9b (bf16 weights from a seeded CUDA
           generator) answering 4 requests of 1024-(i % 4) prompt tokens and
           32 new tokens; the kernel must launch 48 times per prefill; the
           logits must be finite and the kernel path's last-token logits
           must agree with the eager path's on the same weights
  kernels  every ported kernel with its launches on the main path, its error
           against its plain version and its times

then the card's name and power limit as nvidia-smi gives them, and last
{"ok": true, "device": {...}}. Any failed check raises: the script exits
non-zero and prints no result line. Without a CUDA device it exits non-zero
at once; it has no CPU mode.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published H100 SXM peaks (NVIDIA data sheet, dense): the bound of a call is
# the larger of its bytes over the memory rate and its operations over the
# peak rate for its type (bf16 on the tensor cores, fp32 outside them).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# bf16 only: attention outputs at S=1024 are around 0.05, so 2e-2 absolute
# alone would pass a broken bf16 load or store. Both sides round the same
# fp32 result to bf16 and differ by at most one ulp (2**-8 relative) where
# the summation order tips the rounding, so their relative L2 stays far
# below 1e-2; a conversion fault gives O(1).
BF16_REL_L2 = 1e-2
# (B, Hq, Hkv, S, d, causal, window): tests/test_kernels.py's sweep, a
# ragged edge, and the yi-9b prefill shape of the serve phase
SWEEP = [(1, 2, 2, 128, 64, True, 0), (2, 4, 2, 128, 64, True, 0),
         (2, 8, 1, 128, 32, True, 0), (1, 2, 2, 128, 64, False, 0),
         (1, 2, 2, 256, 64, True, 64), (1, 2, 2, 128, 128, True, 0),
         (1, 4, 2, 100, 16, True, 0)]
YI_PREFILL = (4, 32, 4, 1024, 128, True, 0)
N_REQUESTS, PROMPT, GEN = 4, 1024, 32
# Kernel path vs eager path, last-token logits, bf16 through 48 layers: the
# two differ only in the fp32 summation order of attention before its bf16
# cast, i.e. by about one bf16 ulp in some attention outputs, which 48
# residual layers of random weights amplify. A 48-layer narrow model with
# 30% of its attention outputs moved by one ulp drifted by 1.3e-2 (relative
# L2); a wrong mask or head mapping gives O(1).
LOGITS_REL_L2 = 3e-2


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(shape, dtype: str) -> dict:
    """Least time for one flash attention call: q, k, v read once and o
    written once, against the products the mask leaves (4 * d FLOP per
    unmasked (query, key) pair per head)."""
    import numpy as np
    B, Hq, Hkv, S, d, causal, window = shape
    q_pos = np.arange(S)[:, None]
    k_pos = np.arange(S)[None, :]
    mask = np.ones((S, S), bool)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    flops = 4.0 * B * Hq * d * int(mask.sum())
    item = 2 if dtype == "bfloat16" else 4
    nbytes = float(item * (2 * B * Hq * S * d + 2 * B * Hkv * S * d))
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return {"flops": flops, "bytes": nbytes,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def profile_device(fn):
    """Run ``fn`` under torch.profiler; return (its result, the device time
    in ms summed over every kernel, the part spent in flash attention)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    total = flash = 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:    # CPU ops repeat their
            continue                            # kernels' device time
        t = e.self_device_time_total / 1e3
        total += t
        if "flash_fwd_kernel" in e.key:
            flash += t
    return out, total, flash


def phase_device(smi: str) -> dict:
    import torch
    out = {"phase": "device", "nvidia_smi": smi,
           "kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(),
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "python": sys.version.split()[0]}
    emit(out)
    return out


def phase_build() -> dict:
    from repro_torch.kernels import BUILD_INFO, build_library
    from repro_torch.kernels.flash_attention import ops
    build_library(ops.NAME, ops.SOURCES)
    info = BUILD_INFO[ops.NAME]
    ptxas = [ln.split("info    : ")[-1] for ln in info["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    out = {"phase": "build", "kernel": ops.NAME,
           "source": str(ops.SOURCES[0].relative_to(ROOT)),
           "seconds": info["seconds"], "ptxas": ptxas}
    emit(out)
    return out


def _qkv(shape, dtype, gen):
    """q, k, v as the model passes them: (B, S, H, d) tensors viewed as
    (B, H, S, d)."""
    import torch
    B, Hq, Hkv, S, d = shape[:5]
    dt = getattr(torch, dtype)

    def mk(H):
        return torch.randn(B, S, H, d, generator=gen, device="cuda",
                           dtype=torch.float32).to(dt).transpose(1, 2)
    return mk(Hq), mk(Hkv), mk(Hkv)


def phase_kernel() -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for dtype in ("float32", "bfloat16"):
        for shape in (*SWEEP, YI_PREFILL):
            causal, window = shape[5], shape[6]
            q, k, v = _qkv(shape, dtype, gen)
            out = flash_attention(q, k, v, causal=causal, window=window)
            ref = flash_attention_ref(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            o, r = out.float(), ref.float()
            err = (o - r).abs().max().item()
            rel_l2 = ((o - r).norm() / r.norm()).item()
            ok = torch.allclose(o, r, rtol=TOL[dtype], atol=TOL[dtype])
            if dtype == "bfloat16":
                ok = ok and rel_l2 <= BF16_REL_L2
            cases.append({"dtype": dtype, "shape": list(shape),
                          "max_abs_err": err, "rel_l2": rel_l2,
                          "ok": bool(ok)})
    bad = [c for c in cases if not c["ok"]]

    q, k, v = _qkv(YI_PREFILL, "bfloat16", gen)
    timing = {
        "kernel_ms": cuda_ms(lambda: flash_attention(q, k, v, causal=True)),
        "plain_ms": cuda_ms(lambda: flash_attention_ref(q, k, v,
                                                        causal=True)),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)),
    }
    bound = attention_bound(YI_PREFILL, "bfloat16")
    timing.update(bound_us=bound["bound_ms"] * 1e3,
                  bound_by=bound["bound_by"], flops=bound["flops"],
                  bytes=bound["bytes"],
                  tflops=bound["flops"] / timing["kernel_ms"] / 1e9,
                  roofline_share=bound["bound_ms"] / timing["kernel_ms"])
    yi_bf16 = next(c for c in cases if c["dtype"] == "bfloat16"
                   and c["shape"] == list(YI_PREFILL))
    out = {"phase": "kernel", "kernel": "flash_attention", "cases": cases,
           "yi_prefill_bf16": {**timing,
                               "max_abs_err": yi_bf16["max_abs_err"],
                               "rel_l2": yi_bf16["rel_l2"]}}
    emit(out)
    if bad:
        raise AssertionError(f"flash_attention disagrees with its plain "
                             f"version: {bad}")
    return out


def phase_serve() -> dict:
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.config.base import ParallelConfig, get_config
    from repro_torch.launch.serve import Request, ServeEngine, make_requests
    from repro_torch.models.model import Model

    cfg = get_config("yi-9b")                       # full width
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = ServeEngine(cfg)                       # cuda, attention kernel
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    reqs = make_requests(cfg, N_REQUESTS, PROMPT, GEN)
    # warm-up on a short request, outside the counted run
    engine.serve([Request(99, reqs[0].prompt[:64], 2)])

    kernels.reset_launches()
    results = engine.serve(reqs)
    launches = dict(kernels.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    n_layers = cfg.num_layers
    if launches["flash_attention"] != n_layers:
        raise AssertionError(f"flash_attention launched "
                             f"{launches['flash_attention']} times in one "
                             f"prefill; expected {n_layers}")
    toks = np.array([r.tokens for r in results])
    if toks.shape != (N_REQUESTS, GEN) or toks.min() < 0 or \
            toks.max() >= cfg.vocab_size:
        raise AssertionError(f"generated tokens out of range: {toks}")

    # The same batch once more through the kernel path (prefill and one
    # decode step, logits kept) and through the eager path, same weights.
    plen = max(len(r.prompt) for r in reqs)
    batch = np.zeros((N_REQUESTS, plen), np.int64)
    for i, r in enumerate(reqs):
        batch[i, plen - len(r.prompt):] = r.prompt
    batch = {"tokens": torch.from_numpy(batch).cuda()}
    params = engine.model.params
    eager = Model.create(cfg, ParallelConfig(attention_kernel="eager"))
    with torch.inference_mode():
        logits_k, cache = engine.model.prefill(params, batch, plen + 1)
        logits_d, _ = engine.model.decode(params, cache,
                                          logits_k.argmax(-1), plen)
        del cache
        logits_e, _ = eager.prefill(params, batch)
    for name, lg in (("prefill", logits_k), ("decode", logits_d),
                     ("eager prefill", logits_e)):
        if not torch.isfinite(lg).all():
            raise AssertionError(f"non-finite {name} logits")
    lk, le = logits_k.float(), logits_e.float()
    rel_l2 = ((lk - le).norm() / le.norm()).item()
    argmax_agree = (lk.argmax(-1) == le.argmax(-1)).float().mean().item()

    # Where the time goes: device time of one prefill and of 4 decode
    # steps of the same batch, against the counted run's wall times.
    n_prof = 4
    handoff, pre_dev, pre_flash = profile_device(
        lambda: engine.prefill(reqs))
    _, dec_dev, _ = profile_device(lambda: engine.decode(
        dataclasses.replace(handoff, max_new=n_prof)))
    dec_dev /= n_prof

    r0 = results[0]
    steps = sorted(engine.straggler.times[-GEN - n_prof:-n_prof])
    out = {"phase": "serve", "arch": cfg.name, "layers": n_layers,
           "requests": N_REQUESTS, "prompt_len": plen, "gen": GEN,
           "init_s": init_s, "prefill_ms": r0.prefill_ms,
           "decode_ms_per_tok": r0.decode_ms_per_tok,
           "tokens_per_s": N_REQUESTS * 1e3 / r0.decode_ms_per_tok,
           "decode_step_median_ms": steps[len(steps) // 2] * 1e3,
           "decode_step_max_ms": steps[-1] * 1e3,
           "prefill_device_ms": pre_dev, "prefill_flash_ms": pre_flash,
           "prefill_idle_share": 1 - pre_dev / r0.prefill_ms,
           "decode_device_ms_per_step": dec_dev,
           "decode_idle_share": 1 - dec_dev / r0.decode_ms_per_tok,
           "peak_allocated_gb": peak_gb, "launches": launches,
           "launches_per_prefill": launches["flash_attention"],
           "logits_rel_l2_kernel_vs_eager": rel_l2,
           "logits_rel_l2_bound": LOGITS_REL_L2,
           "argmax_agree_kernel_vs_eager": argmax_agree,
           "sample": r0.tokens[:8]}
    emit(out)
    if rel_l2 > LOGITS_REL_L2:
        raise AssertionError(f"kernel-path logits differ from the eager "
                             f"path's: relative L2 {rel_l2} > "
                             f"{LOGITS_REL_L2}")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; this script runs only "
              "on a card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi()
    dev = phase_device(smi)
    phase_build()
    kern = phase_kernel()
    serve = phase_serve()
    yi = kern["yi_prefill_bf16"]
    emit({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:26",
        "launches": serve["launches"]["flash_attention"],
        "matched": all(c["ok"] for c in kern["cases"]),
        "max_abs_err": yi["max_abs_err"],
        "ms": yi["kernel_ms"], "plain_ms": yi["plain_ms"],
        "bound_ms": yi["bound_us"] / 1e3, "bound_by": yi["bound_by"],
        "library_ms": yi["library_ms"]}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
