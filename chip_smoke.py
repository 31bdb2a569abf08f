#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py

Phases, one JSON line each:

  device         the card (nvidia-smi name and power limit), torch and CUDA
                 versions
  build          every kernel family's library (flash attention, paged
                 attention, page quant) compiled by nvcc for sm_90a from the
                 repo's .cu sources, all at once; seconds and ptxas
                 register/spill lines for each
  kernel         K1 (flash attention) held against its plain PyTorch version
                 at the kernel sweep shapes and the yi-9b prefill shape,
                 fp32 and bf16; at the yi-9b shape in bf16 its time beside
                 the plain version's, one scaled_dot_product_attention call
                 (a yardstick only; the port never calls it) and the least
                 time the card could take
  paged_kernels  K2 and K3 (paged attention, fp and int8) against their
                 plain versions over the test sweeps, a batch with a
                 zero-length row and the pager shape, fp32 and bf16; K4 and
                 K5 (page quantize, dequantize) bit for bit over the test
                 shapes and the pager's pool and host-page shapes; the four
                 kernels' times at the pager shape beside their plain
                 versions' and their bounds
  serve          ServeEngine for full-width yi-9b (bf16 weights from a
                 seeded CUDA generator) answering 4 requests of
                 1024-(i % 4) prompt tokens and 32 new tokens; K1 must
                 launch 48 times per prefill; the logits must be finite and
                 the kernel path's last-token logits must agree with the
                 eager path's on the same weights
  pager          PagedKVCache at yi-9b's KV geometry, 48 layers, a bf16 and
                 an int8-cold-tier cache per layer with identical placement
                 (weights 2:1): prefill 16 sequences of 2048 tokens, 32
                 decode steps (append, then attend / attend_quant), then
                 spill and fetch every layer; step, spill and fetch times,
                 host-link rates, bytes moved, peak memory; the launch
                 counts must be exact, K2/K3 must match their plain versions
                 at every layer's last step and each other within 2e-2, the
                 bf16 round trip must be exact and the int8 one must equal
                 plain quantize-then-dequantize on the host rows and move
                 nothing else
  paged_sim      simulate_paged_decode on the gh200 preset with its pools
                 on the card: a simulator output, labelled so
  kv_quant       the kv_quant family's kernel rows (K2 and K3 wall time at
                 the family's small shape) run on the card
  kernels       every ported kernel with its launches on the main path,
                 its error against its plain version and its times

then the card's name and power limit as nvidia-smi gives them, and last
{"ok": true, "device": {...}}. Any failed check raises: the script exits
non-zero and prints no result line. Without a CUDA device it exits non-zero
at once; it has no CPU mode.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import math
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
# (B, Hq, Hkv, d, page, pps): tests/test_kernels.py's paged sweep and
# tests/test_kv_quant.py's wide GQA case
PAGED_SWEEP = [(2, 4, 2, 64, 16, 4), (3, 4, 4, 32, 8, 8),
               (1, 8, 1, 128, 32, 2), (2, 16, 2, 128, 64, 3)]
# (n_pages, page, Hkv, d): tests/test_kv_quant.py's quantize_pages sweep
QUANT_SWEEP = [(12, 8, 2, 16), (7, 16, 4, 32), (32, 16, 1, 128)]
# The pager phase: yi-9b's KV geometry (32 query heads, 4 KV heads, head
# dim 128) in bf16 64-token pages, 16 sequences of 2048 prompt tokens and 32
# decode steps, 48 layers, pages interleaved 2:1 between HBM and host
PAGER = {"seqs": 16, "hq": 32, "hkv": 4, "d": 128, "page": 64,
         "prompt": 2048, "gen": 32, "layers": 48, "weights": (2, 1)}
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
    in ms summed over every kernel, {kernel name: its device ms})."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    by_kernel = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:    # CPU ops repeat their
            continue                            # kernels' device time
        by_kernel[e.key] = by_kernel.get(e.key, 0.0) + \
            e.self_device_time_total / 1e3
    return out, sum(by_kernel.values()), by_kernel


def device_ms(by_kernel: dict, name: str) -> float:
    """Device ms of the kernels whose name contains ``name``."""
    return sum(t for k, t in by_kernel.items() if name in k)


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
    """Every kernel family's library, built by nvcc from the repo's .cu
    sources, all families at once (always rebuilt, so the build is shown)."""
    from repro_torch.kernels import BUILD_INFO, FAMILIES, build_all
    t0 = time.perf_counter()
    build_all(force=True)
    libs = []
    for family in FAMILIES:
        ops = importlib.import_module(f"repro_torch.kernels.{family}.ops")
        info = BUILD_INFO[ops.LIBRARY]
        ptxas = [ln.split("info    : ")[-1]
                 for ln in info["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
        libs.append({"library": ops.LIBRARY,
                     "sources": [str(s.relative_to(ROOT))
                                 for s in ops.SOURCES],
                     "seconds": info["seconds"], "ptxas": ptxas})
    out = {"phase": "build", "wall_s": time.perf_counter() - t0,
           "libraries": libs}
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


def bound(nbytes: float, flops: float = 0.0,
          peak: float = PEAK_FLOPS["float32"]) -> dict:
    """Least time for a call that must move ``nbytes`` and do ``flops``
    (fp32 FMAs unless ``peak`` says otherwise)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return {"bytes": float(nbytes), "flops": float(flops),
            "bound_us": max(t_bytes, t_ops) * 1e6,
            "bound_by": "operations" if t_ops > t_bytes else "bytes"}


def paged_attention_bound(q, k_pages, block_table, seq_lens) -> dict:
    """K2/K3: the K and V rows of every valid position read once (with one
    scale per touched (page, head) for int8 pages), q, the table and the
    lengths read and the output written once, against 4*d FLOP per (query
    head, valid key)."""
    import torch
    B, Hq, d = q.shape
    _, page, Hkv, _ = k_pages.shape
    lens = seq_lens.long()
    kv = 2 * int(lens.sum()) * Hkv * d * k_pages.element_size()
    if k_pages.dtype == torch.int8:
        kv += 2 * int(((lens + page - 1) // page).sum()) * Hkv * 4
    io = 2 * q.numel() * q.element_size() + 4 * (block_table.numel() + B)
    return bound(kv + io, 4.0 * Hq * d * int(lens.sum()))


def quant_bound(x_shape, fp_bytes: int) -> dict:
    """K4/K5: the fp pool and its int8 image each moved once, plus the
    (n_pages, Hkv) f32 scales."""
    n_pages, page, hkv, d = x_shape
    elems = n_pages * page * hkv * d
    return bound(elems * (fp_bytes + 1) + n_pages * hkv * 4)


def _compare(out, ref, dtype: str) -> dict:
    import torch
    o, r = out.float(), ref.float()
    err = (o - r).abs().max().item()
    rel_l2 = ((o - r).norm() / r.norm().clamp_min(1e-30)).item()
    ok = bool(torch.allclose(o, r, rtol=TOL[dtype], atol=TOL[dtype]))
    if dtype == "bfloat16":
        ok = ok and rel_l2 <= BF16_REL_L2
    return {"max_abs_err": err, "rel_l2": rel_l2, "ok": ok}


def _paged_inputs(B, Hq, Hkv, d, page, pps, n_pages, lens, dtype, gen):
    import torch
    dt = getattr(torch, dtype)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dt)
    table = torch.randperm(n_pages, generator=gen, device="cuda")[:B * pps]
    return (randn(B, Hq, d), randn(n_pages, page, Hkv, d),
            randn(n_pages, page, Hkv, d),
            table.reshape(B, pps).to(torch.int32).contiguous(),
            torch.tensor(lens, dtype=torch.int32, device="cuda"))


def pager_shape() -> dict:
    """The pager phase's geometry as the kernels see it: its pool size is
    ``paired_kv_caches``'s, and ``host_pages`` of them lie on the host
    tier."""
    from repro_torch.core.placement import interleave_counts
    g = PAGER
    tokens = g["prompt"] + g["gen"]
    pps = -(-tokens // g["page"])
    n_pages = g["seqs"] * pps + 8
    return {"B": g["seqs"], "Hq": g["hq"], "Hkv": g["hkv"], "d": g["d"],
            "page": g["page"], "pps": pps, "tokens": tokens,
            "n_pages": n_pages,
            "host_pages": interleave_counts(n_pages, g["weights"])[1]}


def phase_paged_kernels() -> dict:
    """K2 and K3 against their plain versions over the test sweeps, a batch
    with a zero-length row and the pager shape, in fp32 and bf16; K4 and K5
    bit for bit over the test shapes and the pager's pool and host-page
    shapes; the four kernels' times at the pager shape."""
    import torch
    from repro_torch.kernels.paged_attention import (
        paged_attention, paged_attention_quant, paged_attention_quant_ref,
        paged_attention_ref)
    from repro_torch.kernels.quant import (dequantize_pages,
                                           dequantize_pages_ref,
                                           quantize_pages,
                                           quantize_pages_ref)
    gen = torch.Generator(device="cuda").manual_seed(1)
    ps = pager_shape()
    shapes = [(*s, s[0] * s[5] + 4, None) for s in PAGED_SWEEP]
    shapes.append((3, 8, 2, 64, 16, 4, 16, [37, 0, 64]))     # zero-length
    shapes.append((ps["B"], ps["Hq"], ps["Hkv"], ps["d"], ps["page"],
                   ps["pps"], ps["n_pages"], [ps["tokens"]] * ps["B"]))
    attn_cases, pager_inputs = [], None
    for dtype in ("float32", "bfloat16"):
        for B, Hq, Hkv, d, page, pps, n_pages, lens in shapes:
            if lens is None:
                lens = torch.randint(1, pps * page + 1, (B,), generator=gen,
                                     device="cuda").tolist()
            q, kp, vp, bt, sl = _paged_inputs(B, Hq, Hkv, d, page, pps,
                                              n_pages, lens, dtype, gen)
            kq, ks = quantize_pages_ref(kp)
            vq, vs = quantize_pages_ref(vp)
            runs = {
                "paged_attention": (
                    paged_attention(q, kp, vp, bt, sl),
                    paged_attention_ref(q, kp, vp, bt, sl)),
                "paged_attention_quant": (
                    paged_attention_quant(q, kq, vq, ks, vs, bt, sl),
                    paged_attention_quant_ref(q, kq, vq, ks, vs, bt, sl)),
            }
            torch.cuda.synchronize()
            for name, (out, ref) in runs.items():
                case = {"kernel": name, "dtype": dtype,
                        "shape": [B, Hq, Hkv, d, page, pps, n_pages],
                        **_compare(out, ref, dtype)}
                zero = [i for i, n in enumerate(lens) if n == 0]
                if zero:
                    case["zero_rows_exact"] = bool((out[zero] == 0).all())
                    case["ok"] = case["ok"] and case["zero_rows_exact"]
                attn_cases.append(case)
            if dtype == "bfloat16" and n_pages == ps["n_pages"]:
                pager_inputs = (q, kp, vp, bt, sl, kq, vq, ks, vs)

    quant_cases = []
    n_host = ps["host_pages"]
    for dtype in ("float32", "bfloat16"):
        for shape in (*QUANT_SWEEP, (ps["n_pages"], ps["page"], ps["Hkv"],
                                     ps["d"]),
                      (n_host, ps["page"], ps["Hkv"], ps["d"])):
            x = (torch.randn(*shape, generator=gen, device="cuda") * 3) \
                .to(getattr(torch, dtype))
            q, s = quantize_pages(x)
            qr, sr = quantize_pages_ref(x)
            xd = dequantize_pages(qr, sr, out_dtype=x.dtype)
            xr = dequantize_pages_ref(qr, sr, x.dtype)
            torch.cuda.synchronize()
            quant_cases.append({
                "dtype": dtype, "shape": list(shape),
                "quantize_bitwise": bool(torch.equal(q, qr)
                                         and torch.equal(s, sr)),
                "dequantize_bitwise": bool(torch.equal(xd, xr)),
                "q_max_diff": (q.int() - qr.int()).abs().max().item(),
                "deq_max_abs_err": (xd.float() - xr.float()).abs().max()
                .item()})

    # times at the pager shape, bf16
    q, kp, vp, bt, sl, kq, vq, ks, vs = pager_inputs
    hq, hs = quantize_pages_ref(kp[:n_host].contiguous())
    calls = {
        "paged_attention": (
            lambda: paged_attention(q, kp, vp, bt, sl),
            lambda: paged_attention_ref(q, kp, vp, bt, sl),
            paged_attention_bound(q, kp, bt, sl)),
        "paged_attention_quant": (
            lambda: paged_attention_quant(q, kq, vq, ks, vs, bt, sl),
            lambda: paged_attention_quant_ref(q, kq, vq, ks, vs, bt, sl),
            paged_attention_bound(q, kq, bt, sl)),
        "quantize_pages": (
            lambda: quantize_pages(kp), lambda: quantize_pages_ref(kp),
            quant_bound(kp.shape, kp.element_size())),
        "dequantize_pages": (
            lambda: dequantize_pages(hq, hs, out_dtype=kp.dtype),
            lambda: dequantize_pages_ref(hq, hs, kp.dtype),
            quant_bound(hq.shape, kp.element_size())),
    }
    timing = {}
    for name, (kern, plain, bnd) in calls.items():
        ms = cuda_ms(kern)
        timing[name] = {"kernel_ms": ms, "plain_ms": cuda_ms(plain),
                        **bnd, "bound_share": bnd["bound_us"] / 1e3 / ms}
    pager_err = {c["kernel"]: c["max_abs_err"] for c in attn_cases
                 if c["dtype"] == "bfloat16" and c["shape"][6] ==
                 ps["n_pages"]}
    for name in ("quantize_pages", "dequantize_pages"):
        pager_err[name] = max(
            c["q_max_diff" if name == "quantize_pages" else
              "deq_max_abs_err"] for c in quant_cases
            if c["dtype"] == "bfloat16" and c["shape"][1:] ==
            [ps["page"], ps["Hkv"], ps["d"]])
    out = {"phase": "paged_kernels", "pager_shape": ps,
           "attention_cases": attn_cases, "quant_cases": quant_cases,
           "pager_shape_bf16": timing, "pager_shape_max_abs_err": pager_err}
    emit(out)
    bad = [c for c in attn_cases if not c["ok"]] + \
        [c for c in quant_cases
         if not (c["quantize_bitwise"] and c["dequantize_bitwise"])]
    if bad:
        raise AssertionError(f"paged kernels disagree with their plain "
                             f"versions: {bad}")
    return out


def phase_pager() -> dict:
    """The pager's path at yi-9b's KV geometry: 48 layers, each with a bf16
    ``PagedKVCache`` and an int8-cold-tier one of identical placement on the
    card; prefill 16 sequences of 2048 tokens, decode 32 steps (append one
    token per sequence, then ``attend`` on the bf16 cache and
    ``attend_quant`` on the int8 one), then spill and fetch every layer's
    host-tier pages in both modes."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.paged_attention import (
        paged_attention_quant_ref, paged_attention_ref)
    from repro_torch.kernels.quant import (dequantize_pages_ref,
                                           quantize_pages_ref)
    from repro_torch.serving.pager import PagedKVCache, PagerConfig

    g, ps = PAGER, pager_shape()
    gen = torch.Generator(device="cuda").manual_seed(2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    layers = []
    for _ in range(g["layers"]):
        layers.append({mode: PagedKVCache(PagerConfig(
            page_size=g["page"], n_pages=ps["n_pages"], kv_heads=g["hkv"],
            head_dim=g["d"], weights=g["weights"], dtype="bfloat16",
            kv_dtype=kv_dtype), device="cuda")
            for mode, kv_dtype in (("fp", None), ("int8", "int8"))})
    seqs = list(range(g["seqs"]))
    for caches in layers:
        for c in caches.values():
            for sq in seqs:
                c.allocate(sq)
        for sq in seqs:
            kv = torch.randn(2, g["prompt"], g["hkv"], g["d"],
                             generator=gen, device="cuda",
                             dtype=torch.bfloat16)
            for c in caches.values():
                c.append(sq, kv[0], kv[1])
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0

    def step(mode: str, inputs: list, last: list | None):
        """One decode step of every layer in ``mode``: append each
        sequence's token, then attend with the layer's q."""
        for caches, (tok, q) in zip(layers, inputs):
            c = caches[mode]
            for sq in seqs:
                c.append(sq, tok[0, sq:sq + 1], tok[1, sq:sq + 1])
            out = c.attend(q, seqs) if mode == "fp" else \
                c.attend_quant(q, seqs)
            if last is not None:
                last.append(out)
        torch.cuda.synchronize()

    walls = {"fp": [], "int8": []}
    dev = {}
    last = {"fp": [], "int8": []}
    for k in range(g["gen"]):
        # one token per sequence and one q per layer, the same in both modes
        inputs = [(torch.randn(2, g["seqs"], g["hkv"], g["d"], generator=gen,
                               device="cuda", dtype=torch.bfloat16),
                   torch.randn(g["seqs"], g["hq"], g["d"], generator=gen,
                               device="cuda", dtype=torch.bfloat16))
                  for _ in layers]
        final = k == g["gen"] - 1
        for mode in ("fp", "int8"):
            if final:       # the last step runs under the profiler
                _, dev_ms, by_kernel = profile_device(
                    lambda: step(mode, inputs, last[mode]))
                dev[mode] = {"device_ms": dev_ms, "kernels_ms": {
                    name: device_ms(by_kernel, key) for name, key in
                    (("paged_attention", "paged_attention_kernel"),
                     ("quantize_pages", "quantize_pages_kernel"))}}
                continue
            t1 = time.perf_counter()
            step(mode, inputs, None)
            walls[mode].append(time.perf_counter() - t1)
    decode_launches = dict(kernels.LAUNCHES)

    # K2/K3 at the last step of every layer against their plain versions
    # on the same inputs, and K3 against K2
    worst = {"paged_attention": 0.0, "paged_attention_quant": 0.0,
             "int8_vs_fp": 0.0}
    bad = []
    for li, caches in enumerate(layers):
        fp, q8 = caches["fp"], caches["int8"]
        q = inputs[li][1]
        out_fp, out_q = last["fp"][li], last["int8"][li]
        bt, lens = fp.block_table(seqs)
        (kq, ks), (vq, vs) = q8._quant_pools
        checks = {
            "paged_attention": _compare(out_fp, paged_attention_ref(
                q, fp.k_pool, fp.v_pool, bt, lens), "bfloat16"),
            "paged_attention_quant": _compare(out_q, paged_attention_quant_ref(
                q, kq, vq, ks, vs, bt, lens), "bfloat16"),
        }
        # K3 against K2: the same q over the same pages, within the
        # reference's 2e-2 bound for int8 against fp attention (the
        # quantization error, so no relative-L2 bound here)
        diff = (out_q.float() - out_fp.float()).abs()
        checks["int8_vs_fp"] = {
            "max_abs_err": diff.max().item(),
            "ok": bool((diff <= 2e-2 + 2e-2 * out_fp.float().abs()).all())}
        for name, r in checks.items():
            worst[name] = max(worst[name], r["max_abs_err"])
            if not r["ok"]:
                bad.append((li, name, r))

    # tiers: spill and fetch every layer's host-tier pages, both modes
    host = torch.from_numpy(np.nonzero(layers[0]["fp"].tier_of_page == 1)[0]
                            ).cuda()
    keep = torch.ones(ps["n_pages"], dtype=torch.bool, device="cuda")
    keep[host] = False
    tiers = {m: {"spill_s": 0.0, "fetch_s": 0.0, "bytes": 0, "pages": 0}
             for m in ("fp", "int8")}
    for li, caches in enumerate(layers):
        for mode, c in caches.items():
            before = (c.k_pool.clone(), c.v_pool.clone())
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            n = c.spill_cold_pages()
            t2 = time.perf_counter()
            c.fetch_spilled()
            t3 = time.perf_counter()
            tr = tiers[mode]
            tr["spill_s"] += t2 - t1
            tr["fetch_s"] += t3 - t2
            tr["pages"] += n
            tr["bytes"] += n * c.host_page_bytes
            for b, a in zip(before, (c.k_pool, c.v_pool)):
                if mode == "fp":
                    ok = torch.equal(a, b)
                else:
                    want = dequantize_pages_ref(
                        *quantize_pages_ref(b[host]), b.dtype)
                    ok = torch.equal(a[host], want) and \
                        torch.equal(a[keep], b[keep])
                if not ok:
                    bad.append((li, f"{mode} round trip", None))
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    for tr in tiers.values():
        tr["spill_gb_per_s"] = tr["bytes"] / tr["spill_s"] / 1e9
        tr["fetch_gb_per_s"] = tr["bytes"] / tr["fetch_s"] / 1e9

    L, G = g["layers"], g["gen"]
    expect = {"flash_attention": 0, "paged_attention": L * G,
              "paged_attention_quant": L * G,
              "quantize_pages": 2 * L * G + 2 * L,
              "dequantize_pages": 2 * L}
    out = {"phase": "pager", "layers": L, "sequences": g["seqs"],
           "prompt": g["prompt"], "decode_steps": G,
           "n_pages_per_pool": ps["n_pages"],
           "host_pages_per_pool": int(host.numel()),
           "prefill_s": prefill_s,
           "step_ms": {m: {"mean": 1e3 * sum(w) / len(w),
                           "median": 1e3 * sorted(w)[len(w) // 2],
                           "max": 1e3 * max(w), "n": len(w)}
                       for m, w in walls.items()},
           "profiled_step": dev,
           "tiers": tiers,
           "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "max_abs_err_last_step": worst,
           "launches_decode": decode_launches, "launches": launches,
           "launches_expected": expect}
    emit(out)
    if launches != expect:
        raise AssertionError(f"pager launch counts {launches} != "
                             f"{expect}")
    if bad:
        raise AssertionError(f"pager checks failed: {bad}")
    return out


def phase_paged_sim() -> dict:
    """The fp16-vs-int8 decode schedule on the gh200 preset, the two pagers'
    pools on the card: a simulator output, not a measurement of the card."""
    from repro_torch.launch.serve import simulate_paged_decode
    report = simulate_paged_decode(system_name="gh200")
    out = {"phase": "paged_sim", "simulated": True, "preset": "gh200",
           "report": report}
    emit(out)
    if not report["bytes_reduction"] > 1.8:
        raise AssertionError(f"int8 pages should move ~2x fewer bytes: "
                             f"{report['bytes_reduction']}")
    return out


def phase_kv_quant() -> dict:
    """The kv_quant family's kernel rows on the card: wall time of K2 and
    K3 at the family's own small shape, each call ending in a CUDA
    synchronise."""
    from repro_torch.heimdall.kv_quant import kv_quant_kernel_wall
    rows = kv_quant_kernel_wall(device="cuda")
    out = {"phase": "kv_quant", "rows": [r.csv() for r in rows]}
    emit(out)
    if not all(math.isfinite(r.us_per_call) and r.us_per_call > 0
               for r in rows):
        raise AssertionError(f"kv_quant kernel rows: {out['rows']}")
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
    handoff, pre_dev, pre_kernels = profile_device(
        lambda: engine.prefill(reqs))
    pre_flash = device_ms(pre_kernels, "flash_fwd_kernel")
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


PAGED_SOURCES = {
    "paged_attention": ("src/repro_torch/kernels/paged_attention/csrc/"
                        "paged_attention.cu",
                        "src/repro/kernels/paged_attention/kernel.py:107"),
    "paged_attention_quant": ("src/repro_torch/kernels/paged_attention/csrc/"
                              "paged_attention.cu",
                              "src/repro/kernels/paged_attention/kernel.py:"
                              "155"),
    "quantize_pages": ("src/repro_torch/kernels/quant/csrc/quant_pages.cu",
                       "src/repro/kernels/quant/kernel.py:74"),
    "dequantize_pages": ("src/repro_torch/kernels/quant/csrc/quant_pages.cu",
                         "src/repro/kernels/quant/kernel.py:102"),
}


def kernels_line(kern: dict, serve: dict, paged: dict, pager: dict) -> dict:
    """Every ported kernel: launches on its main path, agreement with its
    plain version, and its times at the main path's shape."""
    yi = kern["yi_prefill_bf16"]
    rows = [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:26",
        "launches": serve["launches"]["flash_attention"],
        "matched": all(c["ok"] for c in kern["cases"]),
        "max_abs_err": yi["max_abs_err"],
        "ms": yi["kernel_ms"], "plain_ms": yi["plain_ms"],
        "bound_ms": yi["bound_us"] / 1e3, "bound_by": yi["bound_by"],
        "library_ms": yi["library_ms"]}]
    matched = {
        "paged_attention": all(c["ok"] for c in paged["attention_cases"]
                               if c["kernel"] == "paged_attention"),
        "paged_attention_quant": all(
            c["ok"] for c in paged["attention_cases"]
            if c["kernel"] == "paged_attention_quant"),
        "quantize_pages": all(c["quantize_bitwise"]
                              for c in paged["quant_cases"]),
        "dequantize_pages": all(c["dequantize_bitwise"]
                                for c in paged["quant_cases"]),
    }
    for name, (source, replaces) in PAGED_SOURCES.items():
        t = paged["pager_shape_bf16"][name]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": pager["launches"][name],
            "matched": matched[name],
            "max_abs_err": paged["pager_shape_max_abs_err"][name],
            "ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_us"] / 1e3, "bound_by": t["bound_by"],
            "library_ms": None})
    return {"kernels": rows}


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
    paged = phase_paged_kernels()
    serve = phase_serve()
    pager = phase_pager()
    phase_paged_sim()
    phase_kv_quant()
    emit(kernels_line(kern, serve, paged, pager))
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
