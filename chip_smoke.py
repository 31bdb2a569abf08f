#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py                       # every phase
    python3 chip_smoke.py --only serve,pager    # just those, after the build
    python3 chip_smoke.py --only paged_kernels  # K2-K5 alone, after the build

Phases, one JSON line each, in this order (the train phases come first,
while the host has the most memory to pin):

  device         the card (nvidia-smi name and power limit), torch and CUDA
                 versions
  build          every kernel family's library (flash attention, paged
                 attention, quant) compiled by nvcc for sm_90a from the
                 repo's .cu sources, all at once; seconds and ptxas
                 register/spill lines for each, and the tensor-core (HMMA)
                 instructions in each paged attention kernel's SASS
  train_kernels  K6 and K7 (flat blockwise int8 quantize, dequantize) bit for
                 bit against their plain versions over the reference's sweep
                 (N = 2048, 65536; fp32, bf16), one block, an odd block count
                 and yi-9b's largest gradient leaf (48 x 4096 x 11008 bf16);
                 their times there beside their plain versions' and bounds,
                 and K7's beside one torch.mul call that computes the same
                 function
  train          train() on full-width yi-9b (batch 8, seq 128, remat full)
                 for 4 steps with master, mu and nu in pinned host memory as
                 plan_training_placement(cfg, 1) puts them; all 48 layers
                 unless /proc/meminfo says the host cannot pin that much, then
                 the fewest layers cut (every width kept); step wall, the
                 last step under the profiler (its device time and idle
                 share), the optimizer stream's bytes and rates,
                 pin-and-fill time, peak memory, finite losses, moved state
  train_compressed  the same model and state over a one-rank NCCL pod group:
                 compressed gradients (K6 then K7 per leaf) against the
                 uncompressed ones from the same state (equal loss, within
                 0.51 x scale per block) and 2 steps of
                 make_train_step(compress_pod_grads=True) with exactly 12 K6
                 and 12 K7 launches per step
  train_resume   reduced yi-9b: train() for 6 steps with a checkpoint at step
                 3, then a second train() resumed from it; the resumed losses
                 must match the uninterrupted run's within 1e-5 relative
  kernel         K1 (flash attention) held against its plain PyTorch version
                 at the kernel sweep shapes and the yi-9b prefill shape,
                 fp32 and bf16; at the yi-9b shape in bf16 its time beside
                 the plain version's, one scaled_dot_product_attention call
                 (a yardstick only; the port never calls it) and the least
                 time the card could take
  paged_kernels  K2 and K3 (paged attention, fp and int8) against their
                 plain versions over the test sweeps, the split kernel's
                 edge cases (a zero-length row, rows shorter than one split,
                 a table width that is no multiple of the split count, one
                 long sequence) and the pager shape, fp32 and bf16; K4 and
                 K5 (page quantize, dequantize) bit for bit over the test
                 shapes, a head dim of no whole 16-byte chunks, the pager's
                 pool and host-page shapes and the pool one element off
                 16-byte alignment (K4's general path); the four kernels'
                 times at the pager shape beside their plain versions' and
                 their bounds, warm (20 calls on one input) and with a cold
                 L2 (a rotation of distinct inputs, twice the L2 together),
                 K4's vector and general paths in turns, and K5's beside
                 one torch.mul call that computes the same function
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
                 its error against its plain version and its times: CUDA
                 events over 20 back-to-back calls (ms, plain_ms,
                 library_ms) and the device time of the same calls from
                 torch.profiler (kernel_device_ms, library_device_ms), the
                 one to compare a call of a few microseconds by

then the card's name and power limit as nvidia-smi gives them, and last
{"ok": true, "device": {...}}. Any failed check raises: the script exits
non-zero and prints no result line. Without a CUDA device it exits non-zero
at once; it has no CPU mode.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import importlib
import itertools
import json
import math
import shutil
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
# alone would pass a broken bf16 load or store. The kernel rounds P to bf16
# (2**-9 relative) for its P.V product on the tensor cores, where the plain
# version keeps P in fp32, and both round the output to bf16: that moves the
# output by a relative L2 of a few 1e-3 at most, while a wrong tile, swizzle
# or conversion gives O(1).
BF16_REL_L2 = 1e-2
# (B, Hq, Hkv, S, d, causal, window): tests/test_kernels.py's sweep, a
# ragged edge, 8 q heads per KV head at a ragged S with a window that
# straddles the 128-key tiles, and the yi-9b prefill shape of the serve phase
SWEEP = [(1, 2, 2, 128, 64, True, 0), (2, 4, 2, 128, 64, True, 0),
         (2, 8, 1, 128, 32, True, 0), (1, 2, 2, 128, 64, False, 0),
         (1, 2, 2, 256, 64, True, 64), (1, 2, 2, 128, 128, True, 0),
         (1, 4, 2, 100, 16, True, 0), (2, 16, 2, 300, 128, True, 200)]
YI_PREFILL = (4, 32, 4, 1024, 128, True, 0)
N_REQUESTS, PROMPT, GEN = 4, 1024, 32
# (B, Hq, Hkv, d, page, pps): tests/test_kernels.py's paged sweep and
# tests/test_kv_quant.py's wide GQA case
PAGED_SWEEP = [(2, 4, 2, 64, 16, 4), (3, 4, 4, 32, 8, 8),
               (1, 8, 1, 128, 32, 2), (2, 16, 2, 128, 64, 3)]
# (B, Hq, Hkv, d, page, pps, lens): the split kernel's edge cases, as in
# tests/test_torch_paged_attention.py (a zero-length row, rows shorter than
# one split, a table width no multiple of the split count, one long sequence
# in many splits), then the pager's geometry with rows shorter than one
# split and yi-9b's KV heads over one sequence of 128 pages
PAGED_SPLIT_CASES = [
    (3, 8, 2, 64, 16, 4, [37, 0, 64]),
    (8, 8, 4, 32, 16, 9, [150, 1, 16, 17, 0, 144, 90, 33]),
    (4, 8, 8, 32, 8, 23, [184, 9, 100, 1]),
    (1, 8, 2, 32, 16, 40, [637]),
    (8, 16, 8, 64, 16, 23, None),
    (16, 32, 4, 128, 64, 33, [2080] * 12 + [200, 64, 65, 1]),
    (1, 32, 4, 128, 64, 128, [128 * 64 - 17]),
]
# (n_pages, page, Hkv, d): tests/test_kv_quant.py's quantize_pages sweep,
# then a head dim that is no whole number of 16-byte bf16 chunks (K4's
# general path in bf16)
QUANT_SWEEP = [(12, 8, 2, 16), (7, 16, 4, 32), (32, 16, 1, 128),
               (12, 8, 2, 12)]
# The pager phase: yi-9b's KV geometry (32 query heads, 4 KV heads, head
# dim 128) in bf16 64-token pages, 16 sequences of 2048 prompt tokens and 32
# decode steps, 48 layers, pages interleaved 2:1 between HBM and host
PAGER = {"seqs": 16, "hq": 32, "hkv": 4, "d": 128, "page": 64,
         "prompt": 2048, "gen": 32, "layers": 48, "weights": (2, 1)}
# Kernel path vs eager path, last-token logits, bf16 through 48 layers: the
# kernel takes P in bf16 for its tensor-core P.V (the eager path keeps P in
# fp32) and sums in another order, so a good share of its bf16 attention
# outputs sit one ulp from the eager path's, and 48 residual layers of
# random weights amplify that. A 48-layer narrow model with 30% of its
# attention outputs moved by one ulp drifted by 1.3e-2 (relative L2); a
# wrong mask or head mapping gives O(1).
LOGITS_REL_L2 = 3e-2
# the serve phase finds K1's device time by this part of its kernel's name
K1_KERNEL = "flash_fwd_kernel"
# K6/K7: tests/test_kernels.py's sweep, one block, an odd block count, and
# yi-9b's largest gradient leaf (the stacked w_gate / w_up / w_down)
FLAT_SWEEP = [2048, 65536, 256, 7 * 256]
YI_LEAF = 48 * 4096 * 11008
# The train phases: the reference CLI's batch and sequence, 4 steps; 2
# compressed steps; reduced resume run of 6 steps, checkpoint at step 3
TRAIN = {"batch": 8, "seq": 128, "steps": 4, "compressed_steps": 2,
         "resume_steps": 6, "resume_every": 3}
# host memory left unpinned beside the offloaded state (the process, NCCL,
# the profiler, the page cache)
PIN_HEADROOM = 8e9
YI_LEAVES = 12               # parameter leaves of a dense yi-9b tree


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cold_sets(set_bytes: int) -> int:
    """How many distinct input sets a cold-L2 rotation cycles through: at
    least three, holding together at least twice the card's L2 cache, so
    that no call finds its inputs there from an earlier call."""
    import torch
    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size", 0) \
        or 50 * 2 ** 20
    return max(3, -(-2 * l2 // set_bytes))


def rotation(calls: list):
    """One callable that runs ``calls`` in turn, one per call."""
    it = itertools.cycle(calls)
    return lambda: next(it)()


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


def device_ms_per_call(fn, iters: int = 20, warmup: int = 3,
                       kernels_per_call: int | None = 1) -> dict:
    """Device time of ``fn`` per call from torch.profiler over ``iters``
    back-to-back calls. Unlike ``cuda_ms`` it leaves out the host's time
    between launches, which a call of a few microseconds on the device can
    take longer than. The profiler's schedule runs one warm-up cycle of the
    same calls before the recorded one. Where a call is known to launch
    ``kernels_per_call`` kernels (a wrapper of the port launches one; K2
    and K3 two), the time is the recorded kernels' mean times that count, so
    a kernel the
    profiler misses does not lower it; with None (a library call, which may
    split its work over several kernels) it is the recorded total over
    ``iters``. ``kernels`` is how many it recorded, ``by_kernel`` each
    kernel's recorded device ms per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        for cycle in ("warm-up", "recorded"):
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            if cycle == "warm-up":
                prof.step()
    total, by_kernel = device_time(prof)
    n = sum(e.count for e in _device_events(prof))
    ms = total / iters if kernels_per_call is None or n == 0 else \
        total / n * kernels_per_call
    return {"ms": ms, "kernels": n, "calls": iters,
            "by_kernel": {k: t / iters for k, t in by_kernel.items()}}


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
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return (out, *device_time(prof))


def device_time(prof) -> tuple[float, dict]:
    """(ms summed over every kernel, {kernel name: its device ms}) of a
    finished torch.profiler run."""
    by_kernel = {}
    for e in _device_events(prof):
        by_kernel[e.key] = by_kernel.get(e.key, 0.0) + \
            e.self_device_time_total / 1e3
    return sum(by_kernel.values()), by_kernel


def _device_events(prof) -> list:
    """The device's kernels and copies among a finished torch.profiler
    run's key averages: not the CPU ops (they repeat their kernels' device
    time), nor the spans a profiler step or annotation draws on the device
    track (they cover kernels that are counted already)."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("ProfilerStep")]


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


def sass_hmma(lib: Path) -> dict | None:
    """{kernel: tensor-core (HMMA) instructions in its SASS} of a built
    library, by cuobjdump (names demangled by cu++filt); None where the
    toolkit has no cuobjdump."""
    bin_dir = Path("/usr/local/cuda/bin")
    tool = shutil.which("cuobjdump") or str(bin_dir / "cuobjdump")
    if not Path(tool).exists():
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for ln in sass.splitlines():
        if "Function : " in ln:
            name = ln.split("Function : ")[1].strip()
            counts[name] = 0
        elif name and "HMMA" in ln:
            counts[name] += 1
    filt = shutil.which("cu++filt") or str(bin_dir / "cu++filt")
    if counts and Path(filt).exists():
        names = subprocess.run([filt], input="\n".join(counts),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
        if len(names) == len(counts):
            counts = dict(zip(names, counts.values()))
    return counts


def phase_build() -> dict:
    """Every kernel family's library, built by nvcc from the repo's .cu
    sources, all families at once (always rebuilt, so the build is shown)."""
    from repro_torch.kernels import (BUILD_INFO, FAMILIES, build_all,
                                     library_path)
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
        if family == "paged_attention":
            libs[-1]["sass_hmma"] = sass_hmma(library_path(ops.LIBRARY))
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

    def kern():
        return flash_attention(q, k, v, causal=True)

    def library():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)
    timing = {
        "kernel_ms": cuda_ms(kern),
        "kernel_device": device_ms_per_call(kern),
        "plain_ms": cuda_ms(lambda: flash_attention_ref(q, k, v,
                                                        causal=True)),
        "library_ms": cuda_ms(library),
        "library_device": device_ms_per_call(library, kernels_per_call=None),
    }
    bound = attention_bound(YI_PREFILL, "bfloat16")
    timing.update(bound_us=bound["bound_ms"] * 1e3,
                  bound_by=bound["bound_by"], flops=bound["flops"],
                  bytes=bound["bytes"],
                  tflops=bound["flops"] / timing["kernel_ms"] / 1e9,
                  roofline_share=bound["bound_ms"] / timing["kernel_ms"],
                  roofline_share_device=bound["bound_ms"]
                  / timing["kernel_device"]["ms"])
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


def offset_copy(x, offset: int):
    """A contiguous copy of ``x`` that starts ``offset`` elements past the
    start of a fresh allocation (so off 16-byte alignment for offset 1)."""
    import torch
    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    out = buf[offset:].view(x.shape)
    out.copy_(x)
    return out


def phase_paged_kernels() -> dict:
    """K2 and K3 against their plain versions over the test sweeps, a batch
    with a zero-length row and the pager shape, in fp32 and bf16; K4 and K5
    bit for bit over the test shapes and the pager's pool and host-page
    shapes, K4 on both of its paths; the four kernels' times at the pager
    shape, warm and with a cold L2."""
    import torch
    from repro_torch.kernels.paged_attention import (
        paged_attention, paged_attention_quant, paged_attention_quant_ref,
        paged_attention_ref)
    from repro_torch.kernels.quant import (dequantize_pages,
                                           dequantize_pages_ref,
                                           quantize_pages,
                                           quantize_pages_ref)
    from repro_torch.kernels.paged_attention.ops import split_plan
    from repro_torch.kernels.quant.ops import quantize_pages_plan
    gen = torch.Generator(device="cuda").manual_seed(1)
    ps = pager_shape()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shapes = [(*s, s[0] * s[5] + 4, None) for s in PAGED_SWEEP]
    shapes += [(*s[:6], s[0] * s[5] + 4, s[6]) for s in PAGED_SPLIT_CASES]
    pager_case = len(shapes)
    shapes.append((ps["B"], ps["Hq"], ps["Hkv"], ps["d"], ps["page"],
                   ps["pps"], ps["n_pages"], [ps["tokens"]] * ps["B"]))
    attn_cases, pager_inputs = [], None
    for dtype in ("float32", "bfloat16"):
        for i, (B, Hq, Hkv, d, page, pps, n_pages, lens) in \
                enumerate(shapes):
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
                        "split_per": list(split_plan(B, Hkv, pps, sms)),
                        "pager_shape": i == pager_case,
                        **_compare(out, ref, dtype)}
                if i >= len(PAGED_SWEEP):
                    case["lens"] = lens
                zero = [i for i, n in enumerate(lens) if n == 0]
                if zero:
                    case["zero_rows_exact"] = bool((out[zero] == 0).all())
                    case["ok"] = case["ok"] and case["zero_rows_exact"]
                attn_cases.append(case)
            if dtype == "bfloat16" and i == pager_case:
                pager_inputs = (q, kp, vp, bt, sl, kq, vq, ks, vs)

    quant_cases = []
    n_host = ps["host_pages"]
    pool_shape = (ps["n_pages"], ps["page"], ps["Hkv"], ps["d"])
    # (shape, elements the pool starts past a 16-byte boundary): the last
    # case is the pager pool one element off, which K4 takes on its
    # general path
    for dtype in ("float32", "bfloat16"):
        for shape, offset in (*((s, 0) for s in QUANT_SWEEP),
                              (pool_shape, 0),
                              ((n_host, *pool_shape[1:]), 0),
                              (pool_shape, 1)):
            x = (torch.randn(*shape, generator=gen, device="cuda") * 3) \
                .to(getattr(torch, dtype))
            if offset:
                x = offset_copy(x, offset)
            q, s = quantize_pages(x)
            qr, sr = quantize_pages_ref(x)
            xd = dequantize_pages(qr, sr, out_dtype=x.dtype)
            xr = dequantize_pages_ref(qr, sr, x.dtype)
            torch.cuda.synchronize()
            quant_cases.append({
                "dtype": dtype, "shape": list(shape), "offset": offset,
                "k4_path": quantize_pages_plan(x.shape, x.dtype,
                                               x.data_ptr()).path,
                "quantize_bitwise": bool(torch.equal(q, qr)
                                         and torch.equal(s, sr)),
                "dequantize_bitwise": bool(torch.equal(xd, xr)),
                "q_max_diff": (q.int() - qr.int()).abs().max().item(),
                "deq_max_abs_err": (xd.float() - xr.float()).abs().max()
                .item()})

    # times at the pager shape, bf16
    q, kp, vp, bt, sl, kq, vq, ks, vs = pager_inputs
    hq, hs = quantize_pages_ref(kp[:n_host].contiguous())
    hout = torch.empty(hq.shape, dtype=kp.dtype, device="cuda")
    kp_general = offset_copy(kp, 1)
    paths = {name: quantize_pages_plan(x.shape, x.dtype, x.data_ptr()).path
             for name, x in (("vector", kp), ("general", kp_general))}
    if paths != {"vector": "vector", "general": "general"}:
        raise AssertionError(f"K4 paths at the pager shape: {paths}")

    def deq_library():
        # one PyTorch call computes K5's function: int8 times fp32, cast to
        # the output dtype as it is stored
        return torch.mul(hq, hs[:, None, :, None], out=hout)
    # (kernel, plain version, bound, one library call or None, kernels a
    # call launches: K2 and K3 a split and a combine kernel)
    calls = {
        "paged_attention": (
            lambda: paged_attention(q, kp, vp, bt, sl),
            lambda: paged_attention_ref(q, kp, vp, bt, sl),
            paged_attention_bound(q, kp, bt, sl), None, 2),
        "paged_attention_quant": (
            lambda: paged_attention_quant(q, kq, vq, ks, vs, bt, sl),
            lambda: paged_attention_quant_ref(q, kq, vq, ks, vs, bt, sl),
            paged_attention_bound(q, kq, bt, sl), None, 2),
        "quantize_pages": (
            lambda: quantize_pages(kp), lambda: quantize_pages_ref(kp),
            quant_bound(kp.shape, kp.element_size()), None, 1),
        "dequantize_pages": (
            lambda: dequantize_pages(hq, hs, out_dtype=kp.dtype),
            lambda: dequantize_pages_ref(hq, hs, kp.dtype),
            quant_bound(hq.shape, kp.element_size()), deq_library, 1),
    }
    timing = {}
    for name, (kern, plain, bnd, library, per_call) in calls.items():
        ms = cuda_ms(kern)
        dev = device_ms_per_call(kern, kernels_per_call=per_call)
        timing[name] = {
            "kernel_ms": ms, "kernel_device": dev,
            "plain_ms": cuda_ms(plain),
            "library_ms": cuda_ms(library) if library else None,
            "library_device": device_ms_per_call(
                library, kernels_per_call=None) if library else None,
            **bnd, "bound_share": bnd["bound_us"] / 1e3 / ms,
            "bound_share_device": bnd["bound_us"] / 1e3 / dev["ms"]}
    timing["dequantize_pages"]["library_bitwise"] = bool(torch.equal(
        deq_library(), dequantize_pages_ref(hq, hs, kp.dtype)))

    # cold L2: each call of a rotation reads its own inputs, which the
    # calls since it last ran have pushed out of the L2
    def randn_like(t):
        return torch.randn(t.shape, generator=gen, device="cuda").to(t.dtype)

    def int8_like(t):
        return torch.randint(-127, 128, t.shape, generator=gen,
                             device="cuda", dtype=torch.int8)

    def pools(n, make, *like):
        return [[make(t) for t in like] for _ in range(n)]
    kv_bytes = 2 * kp.numel() * kp.element_size()
    # name: (call, its input sets, kernels a call launches)
    cold_inputs = {
        "paged_attention": (
            lambda k_, v_: paged_attention(q, k_, v_, bt, sl),
            pools(cold_sets(kv_bytes), randn_like, kp, vp), 2),
        "paged_attention_quant": (
            lambda k_, v_: paged_attention_quant(q, k_, v_, ks, vs, bt, sl),
            pools(cold_sets(kv_bytes // 2), int8_like, kq, vq), 2),
        "quantize_pages": (
            quantize_pages,
            pools(cold_sets(kv_bytes // 2), randn_like, kp), 1),
        "dequantize_pages": (
            lambda h_: dequantize_pages(h_, hs, out_dtype=kp.dtype),
            pools(cold_sets(hq.numel()), int8_like, hq), 1),
    }
    cold = {}
    for name, (fn, sets, per_call) in cold_inputs.items():
        cold[name] = rotation([functools.partial(fn, *a) for a in sets])
        t = timing[name]
        t["cold_sets"] = len(sets)
        t["cold_set_bytes"] = sum(x.numel() * x.element_size()
                                  for x in sets[0])
        t["kernel_device_cold"] = device_ms_per_call(
            cold[name], kernels_per_call=per_call)
        t["bound_share_device_cold"] = \
            t["bound_us"] / 1e3 / t["kernel_device_cold"]["ms"]

    # K4's vector path and its general path (the first design) at the pager
    # shape, warm and cold, in turns on this card: vector, general,
    # general, vector; the general path's cold pools are the vector path's,
    # one element off alignment
    warm = {"vector": lambda: quantize_pages(kp),
            "general": lambda: quantize_pages(kp_general)}
    runs = {"vector": cold["quantize_pages"],
            "general": rotation([
                functools.partial(quantize_pages, offset_copy(x, 1))
                for x, in cold_inputs["quantize_pages"][1]])}
    turns = {"warm": {"vector": [], "general": []},
             "cold": {"vector": [], "general": []}}
    for path in ("vector", "general", "general", "vector"):
        turns["warm"][path].append(
            device_ms_per_call(warm[path])["ms"])
        turns["cold"][path].append(
            device_ms_per_call(runs[path])["ms"])
    k4 = timing["quantize_pages"]
    timing["quantize_pages_general"] = {
        "kernel_ms": cuda_ms(warm["general"]),
        **{k: k4[k] for k in ("bytes", "flops", "bound_us", "bound_by",
                              "cold_sets", "cold_set_bytes")},
        "turns_device_ms": turns,
        "vector_over_general": {
            w: sum(turns[w]["vector"]) / sum(turns[w]["general"])
            for w in turns},
        "bound_share_device_turns": {
            w: {p: k4["bound_us"] / 1e3 * len(v) / sum(v)
                for p, v in turns[w].items()} for w in turns}}
    pager_err = {c["kernel"]: c["max_abs_err"] for c in attn_cases
                 if c["dtype"] == "bfloat16" and c["pager_shape"]}
    for name in ("quantize_pages", "dequantize_pages"):
        pager_err[name] = max(
            c["q_max_diff" if name == "quantize_pages" else
              "deq_max_abs_err"] for c in quant_cases
            if c["dtype"] == "bfloat16" and c["shape"][1:] ==
            [ps["page"], ps["Hkv"], ps["d"]] and not c["offset"])
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
                # "quantize_pages_kernel" names both of K4's kernels; no
                # dequantize runs in a decode step
                dev[mode] = {"device_ms": dev_ms, "kernels_ms": {
                    name: device_ms(by_kernel, key) for name, key in
                    (("paged_attention", "paged_attention_kernel"),
                     ("quantize_pages", "quantize_pages_kernel"))}}
                dev[mode]["kernels_share"] = {
                    name: t / dev_ms
                    for name, t in dev[mode]["kernels_ms"].items()}
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
              "dequantize_pages": 2 * L, "quantize": 0, "dequantize": 0}
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
    pre_flash = device_ms(pre_kernels, K1_KERNEL)
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
    if pre_flash <= 0:
        raise AssertionError(f"no device time under a kernel named "
                             f"{K1_KERNEL!r} in the profiled prefill: "
                             f"{sorted(pre_kernels)}")
    if rel_l2 > LOGITS_REL_L2:
        raise AssertionError(f"kernel-path logits differ from the eager "
                             f"path's: relative L2 {rel_l2} > "
                             f"{LOGITS_REL_L2}")
    return out


def flat_quant_bound(n: int, in_bytes: int, out: str) -> dict:
    """K6 ('quantize'): n values read once, n int8 and n/256 scales written;
    K7 ('dequantize'): n int8 and n/256 scales read, n fp32 written."""
    scales = 4 * (n // 256)
    if out == "quantize":
        return bound(n * in_bytes + n + scales)
    return bound(n + scales + 4 * n)


def phase_train_kernels() -> dict:
    """K6 and K7 bit for bit against their plain versions, and their times
    at yi-9b's largest gradient leaf (bf16)."""
    import torch
    from repro_torch.kernels.quant import (dequantize, dequantize_ref,
                                           quantize, quantize_ref)
    gen = torch.Generator(device="cuda").manual_seed(3)
    cases, timing = [], {}
    for n, dtypes in [*((n, ("float32", "bfloat16")) for n in FLAT_SWEEP),
                      (YI_LEAF, ("bfloat16",))]:
        for dtype in dtypes:
            x = (torch.randn(n, generator=gen, device="cuda") * 10).to(
                getattr(torch, dtype))
            q, s = quantize(x)
            qr, sr = quantize_ref(x)
            out = dequantize(qr, sr)
            ref = dequantize_ref(qr, sr)
            torch.cuda.synchronize()
            cases.append({
                "n": n, "dtype": dtype,
                "quantize_bitwise": bool(torch.equal(q, qr)
                                         and torch.equal(s, sr)),
                "dequantize_bitwise": bool(torch.equal(out, ref)),
                "q_max_diff": (q.int() - qr.int()).abs().max().item(),
                "deq_max_abs_err": (out - ref).abs().max().item()})
            del q, s, out, ref
            if n == YI_LEAF:
                def deq_library():
                    # one PyTorch call computes K7's function: int8 times
                    # fp32 promotes to fp32; no single call quantizes
                    return torch.mul(qr.view(-1, 256), sr[:, None])
                timing = {
                    "quantize": {
                        "kernel_ms": cuda_ms(lambda: quantize(x)),
                        "kernel_device": device_ms_per_call(
                            lambda: quantize(x)),
                        "plain_ms": cuda_ms(lambda: quantize_ref(x),
                                            iters=5, warmup=1),
                        "library_ms": None, "library_device": None,
                        **flat_quant_bound(n, x.element_size(),
                                           "quantize")},
                    "dequantize": {
                        "kernel_ms": cuda_ms(lambda: dequantize(qr, sr)),
                        "kernel_device": device_ms_per_call(
                            lambda: dequantize(qr, sr)),
                        "plain_ms": cuda_ms(lambda: dequantize_ref(qr, sr),
                                            iters=5, warmup=1),
                        "library_ms": cuda_ms(deq_library),
                        "library_device": device_ms_per_call(
                            deq_library, kernels_per_call=None),
                        "library_bitwise": bool(torch.equal(
                            deq_library().view(-1), dequantize_ref(qr, sr))),
                        **flat_quant_bound(n, x.element_size(),
                                           "dequantize")}}
                for t in timing.values():
                    t["bound_share"] = t["bound_us"] / 1e3 / t["kernel_ms"]
            del x, qr, sr
    torch.cuda.empty_cache()
    out = {"phase": "train_kernels", "cases": cases,
           "yi_leaf_bf16": timing,
           "max_abs_err": {
               "quantize": max(c["q_max_diff"] for c in cases),
               "dequantize": max(c["deq_max_abs_err"] for c in cases)}}
    emit(out)
    bad = [c for c in cases
           if not (c["quantize_bitwise"] and c["dequantize_bitwise"])]
    if bad:
        raise AssertionError(f"flat quant kernels disagree with their plain "
                             f"versions: {bad}")
    return out


def mem_available() -> int:
    """MemAvailable of /proc/meminfo, in bytes."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def train_config(available: int):
    """Full-width yi-9b with as many of its 48 layers as the host can hold
    in pinned memory: master, mu and nu, 12 bytes per parameter, beside
    ``PIN_HEADROOM``."""
    from repro_torch.config.base import get_config
    from repro_torch.models.params import count_params
    from repro_torch.models.transformer import model_specs
    full = get_config("yi-9b")

    def pinned(layers):
        return 12 * count_params(model_specs(
            dataclasses.replace(full, num_layers=layers)))
    layers = full.num_layers
    while layers > 1 and pinned(layers) > available - PIN_HEADROOM:
        layers -= 1
    cut = layers < full.num_layers
    return (dataclasses.replace(full, num_layers=layers) if cut else full,
            {"layers": layers, "full_layers": full.num_layers,
             "pinned_bytes_needed": pinned(layers),
             "pinned_bytes_full": pinned(full.num_layers),
             "mem_available": available, "headroom": PIN_HEADROOM,
             "cut": cut})


def _every_layer(tree, pred) -> bool:
    """``pred`` holds somewhere in every layer slice of each stacked leaf
    (in a strided sample of it) and somewhere in each unstacked leaf."""
    from repro_torch.models.params import tree_flatten
    for path, x in tree_flatten(tree):
        rows = x.reshape(x.shape[0] if _stacked(path) else 1, -1)
        step = max(1, rows.shape[1] // 4096)
        if not bool(pred(rows[:, ::step]).any(dim=1).all()):
            return False
    return True


def _stacked(path) -> bool:
    """Leaves under the decoder segment carry a leading layer dim."""
    return path[0] == "decoder"


def phase_train() -> tuple[dict, dict]:
    """train() on full-width yi-9b with its optimizer state offloaded; its
    last step runs under the profiler."""
    import statistics
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import kernels
    from repro_torch.config.base import ParallelConfig, RunConfig, ShapeConfig
    from repro_torch.core.placement import plan_training_placement
    from repro_torch.launch.train import train
    from repro_torch.models.params import tree_flatten

    # before anything else: how much host memory there is to pin
    cfg, sizing = train_config(mem_available())
    plan = plan_training_placement(cfg, 1)
    if [plan.kinds[g] for g in ("master", "mu", "nu")] != ["pinned_host"] * 3:
        raise AssertionError(f"placement plan does not offload the optimizer "
                             f"state: {plan.kinds}")
    shape = ShapeConfig("smoke", TRAIN["seq"], TRAIN["batch"], "train")
    ckpt_dir = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    run = RunConfig(steps=TRAIN["steps"], checkpoint_every=0,
                    checkpoint_dir=str(ckpt_dir), log_every=1)
    parallel = ParallelConfig(remat="full")
    log, prof = [], profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])

    def around_step(i):
        return prof if i == TRAIN["steps"] - 1 else contextlib.nullcontext()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = train(cfg, shape, run, parallel, device="cuda", log=log.append,
                around_step=around_step)
    wall_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    params_c, master, opt = state = out["state"]
    # device time by kind in the profiled step, against that step's own
    # wall (which ends in a device sync and excludes the trace processing)
    dev_ms, by_kernel = device_time(prof)
    prof_wall_ms = out["step_s"][-1] * 1e3
    h2d_ms = device_ms(by_kernel, "HtoD")
    d2h_ms = device_ms(by_kernel, "DtoH")

    steps = out["step_s"]
    rest = steps[1:]
    per_step = {k: out["offload"][k] / len(steps)
                for k in ("bytes_to_device", "bytes_to_host")}
    med_ms = statistics.median(rest) * 1e3
    pinned = {g: all(t.device.type == "cpu" and t.is_pinned()
                     for _, t in tree_flatten(tree))
              for g, tree in (("master", master), ("mu", opt.mu),
                              ("nu", opt.nu))}
    norms = {"decoder": {k: master["decoder"][k] for k in ("ln1", "ln2")},
             "final_norm": master["final_norm"]}      # initialised to ones
    moved = {"master_norms_moved": _every_layer(norms, lambda r: r != 1),
             "mu_nonzero": _every_layer(opt.mu, lambda r: r != 0),
             "nu_nonzero": _every_layer(opt.nu, lambda r: r != 0)}
    losses = out["history"]
    result = {
        "phase": "train", "arch": cfg.name, **sizing,
        "d_model": cfg.d_model, "d_ff": cfg.d_ff,
        "params": sum(t.numel() for _, t in tree_flatten(master)),
        "batch": TRAIN["batch"],
        "seq": TRAIN["seq"], "remat": parallel.remat,
        "placement": plan.kinds, "state_pinned": pinned,
        "init_s": out["init_s"], "wall_s": wall_s,
        "step_s": steps, "first_step_s": steps[0],
        "step_median_ms": med_ms, "step_max_ms": max(rest) * 1e3,
        "losses": losses, "optimizer_stream_per_step": per_step,
        "profiled_step": {"step": TRAIN["steps"] - 1,
            "wall_ms": prof_wall_ms, "device_ms": dev_ms,
            "memcpy_htod_ms": h2d_ms, "memcpy_dtoh_ms": d2h_ms,
            "kernels_ms": dev_ms - h2d_ms - d2h_ms,
            "idle_share": 1 - dev_ms / prof_wall_ms,
            "idle_share_of_median_step": 1 - dev_ms / med_ms,
            "htod_gb_per_s": per_step["bytes_to_device"] / h2d_ms / 1e6,
            "dtoh_gb_per_s": per_step["bytes_to_host"] / d2h_ms / 1e6,
            "link_share_of_median_step": (h2d_ms + d2h_ms) / med_ms},
        "optimizer_link_gb_per_s_wall": (
            (per_step["bytes_to_device"] + per_step["bytes_to_host"])
            / (med_ms / 1e3) / 1e9),
        "peak_allocated_gb": peak_gb, "launches": launches, **moved,
        "count": int(opt.count), "log": log[-TRAIN["steps"]:]}
    emit(result)
    if len(losses) != TRAIN["steps"] or not all(math.isfinite(v)
                                                for v in losses):
        raise AssertionError(f"train losses: {losses}")
    if not all(pinned.values()) or not all(moved.values()):
        raise AssertionError(f"offloaded state not pinned or not updated: "
                             f"{pinned}, {moved}")
    if launches["quantize"] or launches["dequantize"]:
        raise AssertionError(f"uncompressed training launched K6/K7: "
                             f"{launches}")
    return result, {"cfg": cfg, "shape": shape, "run": run,
                    "parallel": parallel, "plan": plan, "state": state}


def phase_train_compressed(ctx: dict) -> dict:
    """The train phase's model and state over a one-rank NCCL pod group:
    compressed against uncompressed gradients from the same state, then 2
    compressed steps with exact K6/K7 launch counts."""
    import torch
    import torch.distributed as dist
    from repro_torch import kernels
    from repro_torch.data.synthetic import synthetic_batch
    from repro_torch.launch.train import train_step_fn
    from repro_torch.models.model import Model
    from repro_torch.models.params import tree_flatten
    from repro_torch.training.step import compute_grads

    cfg, shape, run, plan = ctx["cfg"], ctx["shape"], ctx["run"], ctx["plan"]
    state = ctx["state"]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        group = dist.group.WORLD
        model = Model.create(cfg, ctx["parallel"], device="cuda",
                             pod_group=group)
        batch = {k: v.cuda() for k, v in synthetic_batch(
            cfg, shape, 1000, run.seed).items()}
        (loss0, _), g0 = compute_grads(model, state[0], batch)
        kernels.reset_launches()
        (loss1, _), g1 = compute_grads(model, state[0], batch,
                                       compress_pod_grads=True)
        torch.cuda.synchronize()
        grad_launches = dict(kernels.LAUNCHES)
        worst, bad = 0.0, []
        for (path, a), (_, b) in zip(tree_flatten(g0), tree_flatten(g1)):
            # layer by layer where a layer is whole 256-element blocks
            by_layer = _stacked(path) and a[0].numel() % 256 == 0
            for i in range(a.shape[0]) if by_layer else (None,):
                x = (a if i is None else a[i]).reshape(-1)
                y = (b if i is None else b[i]).reshape(-1)
                pad = (-x.numel()) % 256
                xb = torch.nn.functional.pad(x.float(), (0, pad)).view(-1, 256)
                yb = torch.nn.functional.pad(y, (0, pad)).view(-1, 256)
                scale = xb.abs().amax(1).clamp_min(1e-12) / 127
                ratio = ((yb - xb).abs().amax(1) / scale).max().item()
                worst = max(worst, ratio)
                if ratio > 0.51:
                    bad.append(("/".join(path), i, ratio))
        del g0, g1
        torch.cuda.empty_cache()

        step_fn = train_step_fn(model, run, plan, compress=True)
        kernels.reset_launches()
        walls, losses = [], []
        for k in range(TRAIN["compressed_steps"]):
            b = {key: v.cuda() for key, v in synthetic_batch(
                cfg, shape, 1001 + k, run.seed).items()}
            t0 = time.perf_counter()
            *state, m = step_fn(*state, b)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
        launches = dict(kernels.LAUNCHES)
    finally:
        dist.destroy_process_group()
    n = TRAIN["compressed_steps"]
    out = {"phase": "train_compressed", "pod_group": "nccl, 1 rank",
           "layers": cfg.num_layers, "leaves": len(tree_flatten(state[0])),
           "loss_uncompressed": float(loss0),
           "loss_compressed": float(loss1),
           "loss_equal": bool(torch.equal(loss0, loss1)),
           "grad_err_over_scale_max": worst, "grad_bound": 0.51,
           "grad_launches": grad_launches, "step_s": walls,
           "losses": losses, "launches": launches,
           "launches_per_step": {k: launches[k] / n
                                 for k in ("quantize", "dequantize")}}
    emit(out)
    want = {"quantize": YI_LEAVES, "dequantize": YI_LEAVES}
    got = {k: grad_launches[k] for k in want}
    if got != want or out["launches_per_step"] != want:
        raise AssertionError(f"K6/K7 launches {got} per gradient pass and "
                             f"{out['launches_per_step']} per step; "
                             f"expected {want}")
    if not out["loss_equal"] or bad:
        raise AssertionError(f"compressed gradients: loss {float(loss1)} vs "
                             f"{float(loss0)}, blocks over the bound {bad}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"compressed-step losses: {losses}")
    return out


def phase_train_resume() -> dict:
    """Reduced yi-9b: an uninterrupted 6-step run that checkpoints at step
    3, then a second run that resumes from that checkpoint."""
    from repro_torch.config.base import (ParallelConfig, RunConfig,
                                         ShapeConfig, get_config)
    from repro_torch.launch.train import train
    cfg = get_config("yi-9b").reduced()
    shape = ShapeConfig("smoke", TRAIN["seq"], TRAIN["batch"], "train")
    ckpt_dir = ROOT / "build" / "train_resume_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    run = RunConfig(steps=TRAIN["resume_steps"], learning_rate=1e-3,
                    warmup_steps=2, checkpoint_every=TRAIN["resume_every"],
                    checkpoint_dir=str(ckpt_dir), log_every=100)
    quiet = dict(device="cuda", log=lambda *a: None)
    first = train(cfg, shape, run, ParallelConfig(remat="full"), **quiet)
    saved = sorted(p.name for p in ckpt_dir.iterdir())
    second = train(cfg, shape, run, ParallelConfig(remat="full"), **quiet)
    a, b = first["history"][TRAIN["resume_every"] + 1:], second["history"]
    rel = max(abs(x - y) / abs(y) for x, y in zip(b, a)) if b else math.inf
    out = {"phase": "train_resume", "arch": cfg.name, "layers":
           cfg.num_layers, "checkpoints": saved, "uninterrupted": a,
           "resumed": b, "max_rel_diff": rel, "bound": 1e-5}
    emit(out)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    if len(b) != len(a) or len(b) == 0 or rel > 1e-5:
        raise AssertionError(f"resumed losses {b} vs uninterrupted {a}")
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


def _device_cols(t: dict) -> dict:
    """A kernel's and its library call's device ms per call, and how many
    kernels the profiler recorded over how many calls."""
    lib = t["library_device"]
    return {"kernel_device_ms": t["kernel_device"]["ms"],
            "library_device_ms": lib["ms"] if lib else None,
            "device_kernels_recorded": {
                "kernel": [t["kernel_device"]["kernels"],
                           t["kernel_device"]["calls"]],
                "library": [lib["kernels"], lib["calls"]] if lib else None}}


def kernels_line(kern: dict, serve: dict, paged: dict, pager: dict,
                 flat: dict, compressed: dict) -> dict:
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
        "ms": yi["kernel_ms"], **_device_cols(yi),
        "plain_ms": yi["plain_ms"],
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
    timing = paged["pager_shape_bf16"]
    for name, (source, replaces) in PAGED_SOURCES.items():
        t = timing[name]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": pager["launches"][name],
            "matched": matched[name],
            "max_abs_err": paged["pager_shape_max_abs_err"][name],
            "ms": t["kernel_ms"], **_device_cols(t),
            "kernel_device_cold_ms": t["kernel_device_cold"]["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_us"] / 1e3, "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
        if name == "quantize_pages":
            turns = timing["quantize_pages_general"]["turns_device_ms"]
            rows[-1]["device_ms_in_turns"] = {
                w: {p: sum(v) / len(v) for p, v in by_path.items()}
                for w, by_path in turns.items()}
    for name, line in (("quantize", 42), ("dequantize", 127)):
        t = flat["yi_leaf_bf16"][name]
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/quant/csrc/quant_pages.cu",
            "replaces": f"src/repro/kernels/quant/kernel.py:{line}",
            "launches": compressed["launches"][name],
            "matched": all(c[f"{name}_bitwise"] for c in flat["cases"]),
            "max_abs_err": flat["max_abs_err"][name],
            "ms": t["kernel_ms"], **_device_cols(t),
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_us"] / 1e3, "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    return {"kernels": rows}


def phase_all() -> None:
    """Every phase after the build, then the kernels line."""
    with expandable_segments():
        flat = phase_train_kernels()
        _, train_ctx = phase_train()
        compressed = phase_train_compressed(train_ctx)
        del train_ctx
        phase_train_resume()
    kern = phase_kernel()
    paged = phase_paged_kernels()
    serve = phase_serve()
    pager = phase_pager()
    phase_paged_sim()
    phase_kv_quant()
    emit(kernels_line(kern, serve, paged, pager, flat, compressed))


@contextlib.contextmanager
def expandable_segments():
    """Training holds most of the card: inside, the allocator grows its
    segments instead of fragmenting fixed ones. The phases after it run
    with the default allocator, as they do alone."""
    import torch
    settings = getattr(torch._C, "_accelerator_setAllocatorSettings", None) \
        or torch.cuda.memory._set_allocator_settings
    settings("expandable_segments:True")
    try:
        yield
    finally:
        gc.collect()            # the pinned training state, unregistered
        torch.cuda.empty_cache()
        settings("expandable_segments:False")


ONLY = {"serve": phase_serve, "pager": phase_pager,
        "paged_kernels": phase_paged_kernels}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", help="comma-separated phases of "
                    f"{sorted(ONLY)}: run just those (after device and "
                    "build), print no kernels line")
    args = ap.parse_args(argv)
    only = args.only.split(",") if args.only else []
    if set(only) - set(ONLY):
        ap.error(f"--only takes phases of {sorted(ONLY)}")
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
    if only:
        for name in only:
            ONLY[name]()
    else:
        phase_all()
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
