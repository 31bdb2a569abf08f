#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py                       # every phase
    python3 chip_smoke.py --only serve,pager    # just those, after the build
    python3 chip_smoke.py --only paged_kernels  # K2-K5 alone, after the build
    python3 chip_smoke.py --only serve,serve_offload  # HBM, then offloaded
    python3 chip_smoke.py --only degrade,disagg # the pager's consumers
    python3 chip_smoke.py --only heimdall       # probes, micro, apps, fit

Phases, one JSON line each, in this order (the train phases come first,
while the host has the most memory to pin):

  device         the card (nvidia-smi name and power limit), torch and CUDA
                 versions
  build          every kernel family's library (flash attention, paged
                 attention, quant, probes) compiled by nvcc for sm_90a from
                 the repo's .cu sources, all at once; seconds and ptxas
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
  serve_offload  the same engine, requests and seed with
                 offload_weights=True: the 17.66 GB of bf16 weights pinned
                 on the host (the phase refuses to start if MemAvailable
                 cannot hold them beside 8 GB; it never shrinks the model)
                 and the whole tree fetched to the card on every prefill and
                 decode call; the tokens must equal the serve phase's
                 exactly, K1 must launch 48 times in the prefill, every home
                 leaf must be pinned host memory with no weights on the card
                 between calls; the run is traced (Tracer, SLOMonitor,
                 FlightRecorder) and must give a valid Chrome trace with 1
                 prefill and 32 decode-step spans, 4 SLO observations and an
                 OpenMetrics text with the serve counters, served once over
                 HTTP on localhost; then one bare whole-tree fetch (GB/s)
                 and StreamingParamServer over the 48 stacked layer slices
                 (ms per layer, GB/s, each layer equal to a device copy, at
                 most two layers buffered, and the copies overlapping each
                 layer's MLP products by at least half of the shorter of
                 the two); prefill, decode step and tokens/s, one
                 profiled decode step's copy and kernel time, pin time and
                 peak memory
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
  degrade        the degradation loop with its pagers on the card: the
                 resilience family's summary (three scenarios, react and
                 baseline) equal to the CPU's but for the detector's
                 wall-clock overhead, within the family's thresholds; the
                 headline (host link x0.5 at round 4) at yi-9b's KV
                 geometry (16 x 2048 + 32 tokens), react and baseline,
                 reports equal to the CPU's, each arm's wall on the card;
                 then the evacuation measured at the pager phase's geometry
                 over 48 layers, a bf16 and an int8 cache per layer,
                 spilled (host rows then zeroed on the card):
                 retier((1, 0)) (the hot-removal evacuation) and
                 retier((2, 1)) + spill_cold_pages() (the re-spill), bytes,
                 seconds and GB/s, beside the migration time the recovery
                 controller would charge on the tpu_v5e and gh200 presets
                 (simulated); the bf16 pools must come back bit for bit,
                 the int8 host rows equal plain quantize-then-dequantize
                 of the pre-spill rows, the re-spilled host rows equal the
                 pools' rows (bf16) or their plain quantization (int8),
                 exactly 2 K5 launches per layer on the int8 evacuation
                 and 2 K4 on its re-spill, and every new pinned tensor one
                 the caches hold
  disagg         disaggregated prefill/decode with the decode node's pager
                 on the card: the disagg family's summary (overlap speedup
                 at least 1.2, no deadline violation), run_disagg_serve at
                 yi-9b's KV geometry on cxl_pool, fp and int8, traced, and
                 the qos family's decode admission, each equal to the
                 CPU's; the qos summary and interference rows; every time
                 simulated
  heimdall       the probe kernels P1-P4 (pointer chase, tier sum, atomic
                 scatter-add, SM copy; hbm and pinned host memory read
                 through its mapped device pointer) against their plain
                 versions; HEIMDALL's micro family at the reference's
                 default sizes (every row; each probe must launch) and its
                 app family; P1's ns per access per tier and P2's host GB/s
                 beside the copy engine's for the same 32 MiB;
                 CalibrationRunner("tpu_v5e", source="torch") fitted from
                 copies timed on the card (profile written to
                 build/heimdall_profile.json; the host link's fit in
                 (0, 64] GB/s, printed beside serve_offload's fetch rate);
                 that profile through simulate_paged_decode,
                 run_disagg_serve and the recalibrating run_degraded_serve
                 with their pagers on the card, each report equal to the
                 CPU's
  paged_sim      simulate_paged_decode on the gh200 preset with its pools
                 on the card: a simulator output, labelled so
  kv_quant       the kv_quant family's kernel rows (K2 and K3 wall time at
                 the family's small shape) run on the card
  kernels       every ported kernel (K1-K7, then the probes P1-P4) with its
                 launches on the main paths, its error against its plain
                 version and its times: CUDA events over 20 back-to-back
                 calls (ms, plain_ms, library_ms) and the device time of
                 the same calls from torch.profiler (kernel_device_ms,
                 library_device_ms), the one to compare a call of a few
                 microseconds by; bound_share is bound_ms over that device
                 time

then the card's name and power limit as nvidia-smi gives them, and last
{"ok": true, "device": {...}}. Any failed check raises: the script exits
non-zero and prints no result line. Without a CUDA device it exits non-zero
at once; it has no CPU mode.

Device times come from torch.profiler, which now and then records no device
event in a window: such a window is recorded again where running it again
changes nothing that is checked (up to three times, said on stderr), and a
device time it never recorded is null (not measured), never zero.
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
# the serve_offload phase: decode steps profiled for the copy's share, and
# the rows of the MLP products run after each streamed layer to see the
# copies overlap compute (about the copy's time per layer: 3 x 2 x 16384 x
# 4096 x 11008 FLOP)
OFFLOAD_PROFILED_STEPS = 2
OVERLAP_ROWS = 16384


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
                       kernels_per_call: int | None = 1,
                       attempts: int = 3) -> dict:
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
    kernel's recorded device ms per call. A recording that holds no device
    event is made again, up to ``attempts`` times; after that ``ms`` is None
    (not measured)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            for cycle in ("warm-up", "recorded"):
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                if cycle == "warm-up":
                    prof.step()
        total, by_kernel = device_time(prof)
        if total is not None:
            break
        _no_device_events(prof, attempt, attempts)
    n = sum(e.count for e in _device_events(prof))
    if total is None:
        ms = None
    elif kernels_per_call is None:
        ms = total / iters
    else:
        ms = total / n * kernels_per_call
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


def profile_device(fn, attempts: int = 1):
    """Run ``fn`` under torch.profiler; return (its result, the device time
    in ms summed over every kernel, {kernel name: its device ms}). A
    recording that holds no device event is made again, up to ``attempts``
    times (give more than one only where running ``fn`` again changes
    nothing that is checked); after that the device time is None (not
    measured)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        total, by_kernel = device_time(prof)
        if total is not None:
            break
        _no_device_events(prof, attempt, attempts)
    return out, total, by_kernel


def device_time(prof) -> tuple[float | None, dict]:
    """(ms summed over every kernel, {kernel name: its device ms}) of a
    finished torch.profiler run; (None, {}) where it recorded no device
    event at all, so that nothing reads a missed recording as zero time."""
    by_kernel = {}
    for e in _device_events(prof):
        by_kernel[e.key] = by_kernel.get(e.key, 0.0) + \
            e.self_device_time_total / 1e3
    if not by_kernel:
        return None, {}
    return sum(by_kernel.values()), by_kernel


def _no_device_events(prof, attempt: int, attempts: int) -> None:
    """Say on stderr that a profiler run recorded no device event, where
    (the line that asked for it), with what it did record, and whether it
    is made again."""
    from collections import Counter
    caller = sys._getframe(2)
    kinds = Counter(str(e.device_type) for e in prof.key_averages())
    then = "again" if attempt + 1 < attempts else "device time not measured"
    print(f"chip_smoke: torch.profiler recorded no device event at "
          f"{caller.f_code.co_name}:{caller.f_lineno} (attempt "
          f"{attempt + 1} of {attempts}; its events by device: "
          f"{dict(kinds)}); {then}", file=sys.stderr, flush=True)


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


def device_ms(by_kernel: dict, name: str) -> float | None:
    """Device ms of the kernels whose name contains ``name``; None where
    the profiler recorded nothing."""
    if not by_kernel:
        return None
    return sum(t for k, t in by_kernel.items() if name in k)


def ratio(a, b):
    """a / b, or None where either was not measured."""
    return None if a is None or b is None else a / b


def less(a, b):
    """a - b, or None where either was not measured."""
    return None if a is None or b is None else a - b


def _total(times: list):
    """The sum of ``times``, or None where one was not measured."""
    return None if None in times else sum(times)


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
                  roofline_share_device=ratio(
                      bound["bound_ms"], timing["kernel_device"]["ms"]))
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
            "bound_share_device": ratio(bnd["bound_us"] / 1e3, dev["ms"])}
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
        t["bound_share_device_cold"] = ratio(
            t["bound_us"] / 1e3, t["kernel_device_cold"]["ms"])

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
            w: ratio(_total(turns[w]["vector"]),
                     _total(turns[w]["general"])) for w in turns},
        "bound_share_device_turns": {
            w: {p: ratio(k4["bound_us"] / 1e3 * len(v), _total(v))
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
                    name: ratio(t, dev_ms)
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
    expect = {name: 0 for name in launches}     # every other kernel: none
    expect.update({"paged_attention": L * G, "paged_attention_quant": L * G,
                   "quantize_pages": 2 * L * G + 2 * L,
                   "dequantize_pages": 2 * L})
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
    # (a prefill changes nothing, and these decode steps write the same
    # cache positions when made again)
    handoff, pre_dev, pre_kernels = profile_device(
        lambda: engine.prefill(reqs), attempts=3)
    pre_flash = device_ms(pre_kernels, K1_KERNEL)
    _, dec_dev, _ = profile_device(lambda: engine.decode(
        dataclasses.replace(handoff, max_new=n_prof)), attempts=3)
    dec_dev = ratio(dec_dev, n_prof)

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
           "prefill_idle_share": less(1, ratio(pre_dev, r0.prefill_ms)),
           "decode_device_ms_per_step": dec_dev,
           "decode_idle_share":
               less(1, ratio(dec_dev, r0.decode_ms_per_tok)),
           "peak_allocated_gb": peak_gb, "launches": launches,
           "launches_per_prefill": launches["flash_attention"],
           "logits_rel_l2_kernel_vs_eager": rel_l2,
           "logits_rel_l2_bound": LOGITS_REL_L2,
           "argmax_agree_kernel_vs_eager": argmax_agree,
           "sample": r0.tokens[:8]}
    emit(out)
    out["tokens"] = toks                 # the serve_offload phase's reference
    if not pre_flash:           # None: the profiler recorded nothing
        raise AssertionError(f"no device time under a kernel named "
                             f"{K1_KERNEL!r} in the profiled prefill: "
                             f"{sorted(pre_kernels)}")
    if rel_l2 > LOGITS_REL_L2:
        raise AssertionError(f"kernel-path logits differ from the eager "
                             f"path's: relative L2 {rel_l2} > "
                             f"{LOGITS_REL_L2}")
    return out


def hbm_tokens(cfg) -> "np.ndarray":
    """The serve phase's tokens, for a serve_offload phase run without
    it: the HBM engine on the same seed and requests."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import ServeEngine, make_requests
    engine = ServeEngine(cfg)
    results = engine.serve(make_requests(cfg, N_REQUESTS, PROMPT, GEN))
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return np.array([r.tokens for r in results])


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _layer_stream(get, n_layers: int, x=None):
    """``get(i)`` for every layer in order, each layer's MLP products on
    the rows ``x`` after it when ``x`` is given: the host's seconds to
    issue it all, and the seconds until the card is done."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_layers):
        layer = get(i)
        if x is not None:
            mlp = layer["mlp"]
            ((x @ mlp["w_gate"]) * (x @ mlp["w_up"])) @ mlp["w_down"]
    issued = time.perf_counter() - t0
    torch.cuda.synchronize()
    return issued, time.perf_counter() - t0


def phase_serve_offload(serve_tokens=None) -> dict:
    """Weight-offloaded yi-9b serving: pinned host weights fetched whole on
    every call, traced; then the bare fetch and the layer stream."""
    import statistics
    import tempfile
    import urllib.request
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.config.base import get_config
    from repro_torch.core.offload import StreamingParamServer, fetch_to_device
    from repro_torch.launch.serve import Request, ServeEngine, make_requests
    from repro_torch.models.params import count_params, tree_flatten, tree_map
    from repro_torch.models.transformer import model_specs
    from repro_torch.obs import (NULL_TRACER, BandwidthLedger, FlightRecorder,
                                 SLOMonitor, Tracer, openmetrics_text,
                                 serve_openmetrics, validate_chrome_trace,
                                 write_chrome_trace)

    cfg = get_config("yi-9b")                       # full width, not cut
    if serve_tokens is None:
        serve_tokens = hbm_tokens(cfg)
    gc.collect()                    # the HBM engine and any pinned state
    torch.cuda.empty_cache()
    weight_bytes = 2 * count_params(model_specs(cfg))
    available = mem_available()
    if available < weight_bytes + PIN_HEADROOM:
        raise RuntimeError(
            f"MemAvailable {available / 1e9:.2f} GB cannot hold yi-9b's "
            f"{weight_bytes / 1e9:.2f} GB of pinned bf16 weights beside "
            f"{PIN_HEADROOM / 1e9:.0f} GB of headroom; the phase serves the "
            f"full model or nothing")

    t0 = time.perf_counter()
    engine = ServeEngine(cfg, offload_weights=True)  # draw on cuda, pin
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    home = engine.params_home
    leaves = [x for _, x in tree_flatten(home)]
    pinned_bytes = sum(x.numel() * x.element_size() for x in leaves)
    home_pinned = all(x.device.type == "cpu" and x.is_pinned()
                      for x in leaves)
    reqs = make_requests(cfg, N_REQUESTS, PROMPT, GEN)
    # warm-up on a short request, outside the count and the trace
    engine.serve([Request(99, reqs[0].prompt[:64], 2)])

    tracer = Tracer()
    recorder = FlightRecorder(forward=tracer)
    slo = SLOMonitor()
    engine.tracer, engine.slo = recorder, slo
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    results = engine.serve(reqs)
    launches = dict(kernels.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    between_calls_gb = torch.cuda.memory_allocated() / 1e9
    engine.tracer, engine.slo = NULL_TRACER, None
    toks = np.array([r.tokens for r in results])

    # what the run observed, exported and checked as the CLI writes it
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "serve_offload_trace.json"
        write_chrome_trace(tracer, str(path))
        trace = json.loads(path.read_text())
    validate_chrome_trace(trace)
    validate_chrome_trace(recorder.snapshot(reason="serve_offload"))
    spans = [e["name"] for e in trace["traceEvents"] if e["ph"] == "B"]
    slo_report = slo.report()["serve"]
    om = openmetrics_text(metrics=tracer.metrics,
                          ledger=BandwidthLedger.from_tracer(tracer))
    server = serve_openmetrics(lambda: om, port=0)
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.server_port}/metrics",
                timeout=30) as resp:
            scraped = resp.read().decode("utf-8")
    finally:
        server.shutdown()
        server.server_close()

    # one profiled decode-step window: the copy's share of the device time
    handoff = engine.prefill(reqs)
    # (made again, these steps write the same cache positions)
    _, dec_dev, dec_by = profile_device(lambda: engine.decode(
        dataclasses.replace(handoff, max_new=OFFLOAD_PROFILED_STEPS)),
        attempts=3)
    del handoff
    copy_ms = device_ms(dec_by, "Memcpy")
    per = OFFLOAD_PROFILED_STEPS

    # the bare whole-tree fetch, synced, three times
    fetch_s = []
    dev = None
    for _ in range(3):
        dev = None
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dev = fetch_to_device(home, "cuda")
        torch.cuda.synchronize()
        fetch_s.append(time.perf_counter() - t1)

    # StreamingParamServer over the 48 stacked layer slices
    layers = cfg.num_layers
    stacked = home["decoder"]

    def layer(tree, i):
        return tree_map(lambda x: x[i], tree)
    layer_bytes = sum(x[0].numel() * x.element_size()
                      for _, x in tree_flatten(stacked))
    slices_pinned = all(x[i].is_pinned() for _, x in tree_flatten(stacked)
                        for i in range(layers))
    # one server (one copy stream) for every timed pass, as a serving loop
    # keeps one: the caching allocator pools blocks per stream, so a server
    # per pass would allocate its layer buffers anew inside the timing
    server = StreamingParamServer(stacked, layers, layer)
    streams = [_layer_stream(server.get, layers) for _ in range(3)]
    # do the copies overlap compute? the stream with each layer's MLP
    # products after its get, against the products alone (on a device
    # copy) and the stream alone
    rows = torch.randn(OVERLAP_ROWS, cfg.d_model, dtype=torch.bfloat16,
                       device="cuda")
    compute_s = statistics.median(_layer_stream(
        lambda i: layer(dev["decoder"], i), layers, rows)[1]
        for _ in range(3))
    both_s = statistics.median(_layer_stream(server.get, layers, rows)[1]
                               for _ in range(3))
    del server
    del rows
    check = StreamingParamServer(stacked, layers, layer)
    equal, most_buffered = True, 0
    for i in range(layers):
        got = check.get(i)
        most_buffered = max(most_buffered, len(check._buf) + 1)
        equal &= all(torch.equal(x, _at(dev["decoder"], path)[i])
                     for path, x in tree_flatten(got))
    del dev, got, check

    r0 = results[0]
    steps = sorted(engine.straggler.times[-GEN - per:-per])
    stream_s = statistics.median(s for _, s in streams)
    overlap = (stream_s + compute_s - both_s) / min(stream_s, compute_s)
    fetch_med = statistics.median(fetch_s)
    out = {"phase": "serve_offload", "arch": cfg.name,
           "layers": cfg.num_layers, "requests": N_REQUESTS,
           "prompt_len": max(len(r.prompt) for r in reqs), "gen": GEN,
           "weights_gb": weight_bytes / 1e9, "pinned_gb": pinned_bytes / 1e9,
           "mem_available_before_gb": available / 1e9,
           "init_s": init_s, "home_pinned": home_pinned,
           "prefill_ms": r0.prefill_ms,
           "decode_ms_per_tok": r0.decode_ms_per_tok,
           "tokens_per_s": N_REQUESTS * 1e3 / r0.decode_ms_per_tok,
           "decode_step_median_ms": steps[len(steps) // 2] * 1e3,
           "decode_step_max_ms": steps[-1] * 1e3,
           "decode_device_ms_per_step": ratio(dec_dev, per),
           "decode_copy_device_ms_per_step": ratio(copy_ms, per),
           "decode_copy_share_of_device": ratio(copy_ms, dec_dev),
           "fetch_s": fetch_s,
           "fetch_gb_per_s": weight_bytes / fetch_med / 1e9,
           "fetch_share_of_decode_step":
               fetch_med * 1e3 / r0.decode_ms_per_tok,
           "stream_layer_mb": layer_bytes / 1e6,
           "stream_s": [s for _, s in streams],
           "stream_host_issue_s": [h for h, _ in streams],
           "stream_ms_per_layer": stream_s * 1e3 / layers,
           "stream_gb_per_s": layer_bytes * layers / stream_s / 1e9,
           "stream_slices_pinned": slices_pinned,
           "stream_compute_rows": OVERLAP_ROWS,
           "mlp_compute_only_s": compute_s, "stream_with_mlp_s": both_s,
           "stream_compute_overlap": overlap,
           "stream_equal": bool(equal), "stream_most_buffered": most_buffered,
           "peak_allocated_gb": peak_gb,
           "allocated_between_calls_gb": between_calls_gb,
           "launches": launches,
           "launches_per_prefill": launches.get("flash_attention", 0),
           "tokens_equal_serve": bool(np.array_equal(toks, serve_tokens)),
           "prefill_spans": spans.count("serve.prefill"),
           "decode_step_spans": spans.count("serve.decode_step"),
           "slo_observations": slo_report["count"],
           "openmetrics_scraped_equal": scraped == om,
           "sample": r0.tokens[:8]}
    emit(out)
    del engine, home, leaves, stacked
    gc.collect()                    # the pinned weights, unregistered
    torch.cuda.empty_cache()
    failed = []
    if not out["tokens_equal_serve"]:
        failed.append(f"tokens differ from the serve phase's: {toks} vs "
                      f"{serve_tokens}")
    if out["launches_per_prefill"] != cfg.num_layers:
        failed.append(f"flash_attention launched "
                      f"{out['launches_per_prefill']} times in the "
                      f"offloaded prefill; expected {cfg.num_layers}")
    if not (home_pinned and slices_pinned):
        failed.append("weights not in pinned host memory")
    if between_calls_gb > 0.05 * weight_bytes / 1e9:
        failed.append(f"{between_calls_gb:.2f} GB left on the card between "
                      f"calls")
    if not equal or most_buffered > 2:
        failed.append(f"streamed layers: equal={equal}, up to "
                      f"{most_buffered} buffered")
    if overlap < 0.5:
        failed.append(f"the layer copies do not overlap compute: stream "
                      f"{stream_s} s, compute {compute_s} s, both {both_s} "
                      f"s (overlap {overlap})")
    if (out["prefill_spans"], out["decode_step_spans"],
            out["slo_observations"]) != (1, GEN, N_REQUESTS):
        failed.append(f"trace/SLO counts {out['prefill_spans']}, "
                      f"{out['decode_step_spans']}, "
                      f"{out['slo_observations']}")
    if f"serve_requests_total {N_REQUESTS}" not in om or \
            f"serve_decode_steps_total {GEN}" not in om or \
            not out["openmetrics_scraped_equal"]:
        failed.append("OpenMetrics text lacks the serve counters or the "
                      "scrape differs from it")
    if failed:
        raise AssertionError("; ".join(failed))
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
            "kernels_ms": less(less(dev_ms, h2d_ms), d2h_ms),
            "idle_share": less(1, ratio(dev_ms, prof_wall_ms)),
            "idle_share_of_median_step": less(1, ratio(dev_ms, med_ms)),
            "htod_gb_per_s": ratio(per_step["bytes_to_device"] / 1e6,
                                   h2d_ms),
            "dtoh_gb_per_s": ratio(per_step["bytes_to_host"] / 1e6, d2h_ms),
            "link_share_of_median_step": ratio(_total([h2d_ms, d2h_ms]),
                                               med_ms)},
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


def _json_text(x) -> str:
    return json.dumps(x, sort_keys=True, default=str)


def _same_reports(what: str, card, cpu) -> None:
    """A simulated report from the card's run must equal the CPU run's as
    JSON text (its values depend on the fabric and the page counts, not on
    where the pages live)."""
    if _json_text(card) != _json_text(cpu):
        raise AssertionError(f"{what}: the card's report differs from the "
                             f"CPU's:\n{_json_text(card)}\n"
                             f"{_json_text(cpu)}")


def _pinned_storages() -> set:
    """Data pointers of every pinned CPU tensor alive in the process."""
    import warnings

    import torch
    out = set()
    with warnings.catch_warnings():
        # isinstance on some of torch's module proxies warns of deprecation
        warnings.simplefilter("ignore", FutureWarning)
        for obj in gc.get_objects():
            try:
                if isinstance(obj, torch.Tensor) \
                        and obj.device.type == "cpu" and obj.is_pinned():
                    out.add(obj.untyped_storage().data_ptr())
            except (RuntimeError, ReferenceError):
                continue
    return out


def phase_degrade() -> dict:
    """The degradation loop on the card: (a) the resilience family's
    summary, its pagers' pools on the card, equal to the CPU's but for the
    detector's wall-clock overhead and within the family's thresholds;
    (b) the headline scenario (host link x0.5 at round 4) at yi-9b's KV
    geometry, react and baseline, reports equal to the CPU's, with each
    arm's wall on the card; (c) the evacuation a hot removal triggers,
    measured at the pager phase's geometry over 48 layers: ``retier((1,
    0))`` of spilled bf16 and int8 caches (the fetch through pinned
    staging, K5 on the int8 pages), then ``retier((2, 1))`` and
    ``spill_cold_pages()`` (K4 on the int8 pages), its host rows held
    against the plain result."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.fabric.systems import get_system
    from repro_torch.heimdall import resilience
    from repro_torch.kernels.quant import (dequantize_pages_ref,
                                           quantize_pages_ref)
    from repro_torch.runtime.degrade import (DegradedServeConfig,
                                             host_link_degraded,
                                             run_degraded_serve)
    from repro_torch.serving.pager import PagedKVCache, PagerConfig
    from repro_torch.transport import PageTransfer, Route, plan_transfers

    def simulated_migration_s(name: str, nbytes: int) -> float:
        """What the recovery controller charges for moving ``nbytes`` from
        the spill tier to the compute tier on preset ``name``: one bulk
        transfer planned over that route."""
        system = get_system(name)
        route = Route.try_resolve(system, system.kv_tiers[1],
                                  system.compute)
        return plan_transfers(route, (PageTransfer("retier", nbytes),),
                              flow_prefix="migrate_").total_time

    out = {"phase": "degrade", "simulated_reports": True}
    # (a) the family at its own config
    t0 = time.perf_counter()
    fam = resilience.resilience_summary(device="cuda")
    fam_s = time.perf_counter() - t0
    fam_cpu = resilience.resilience_summary(device="cpu")
    overhead = fam.pop("detector_overhead_us")
    fam_cpu.pop("detector_overhead_us")
    _same_reports("resilience_summary", fam, fam_cpu)
    th = fam["thresholds"]
    out["family"] = {"summary": fam, "card_s": fam_s,
                     "detector_overhead_us": overhead}
    if not (fam["recovery"]["frac"] >= th["min_recovery_frac"]
            and fam["detect"]["latency_rounds"] <= th["max_detect_rounds"]
            and fam["slo"]["violations_react"]
            < fam["slo"]["violations_baseline"]):
        raise AssertionError(f"resilience thresholds missed: {fam}")

    # (b) the headline at yi-9b's KV geometry
    cfg = DegradedServeConfig(kv_heads=PAGER["hkv"], head_dim=PAGER["d"],
                              page_size=PAGER["page"],
                              requests=PAGER["seqs"],
                              prompt=PAGER["prompt"], gen=PAGER["gen"],
                              rounds=12)
    sched = host_link_degraded(system=cfg.system, at_round=4, factor=0.5)
    head = {}
    for arm, react in (("react", True), ("baseline", False)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = run_degraded_serve(sched, cfg=cfg, react=react,
                                  device="cuda").to_json()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        cpu = run_degraded_serve(sched, cfg=cfg, react=react,
                                 device="cpu").to_json()
        _same_reports(f"degraded serve ({arm})", card, cpu)
        head[arm] = {"wall_s": wall,
                     "wall_ms_per_round": 1e3 * wall / cfg.rounds,
                     "detect_round": card["detect_round"],
                     "recovery_frac": card["recovery_frac"],
                     "violations_total": card["violations_total"],
                     "pre_tput_tok_s": card["pre_tput_tok_s"],
                     "post_tput_tok_s": card["post_tput_tok_s"],
                     "action": next((r["action"] for r in card["rounds"]
                                     if r["action"]), None)}
    out["headline_yi9b_kv"] = {"config": dataclasses.asdict(cfg),
                               "arms": head}
    react = head["react"]
    if not (react["violations_total"]
            < head["baseline"]["violations_total"]
            and react["recovery_frac"] >= th["min_recovery_frac"]
            and react["detect_round"] is not None
            and react["detect_round"] - 4 <= th["max_detect_rounds"]):
        raise AssertionError(f"headline at yi-9b's KV geometry: {head}")

    # (c) the evacuation, measured
    g, ps = PAGER, pager_shape()
    gen = torch.Generator(device="cuda").manual_seed(3)
    pinned_before = _pinned_storages()
    layers = []
    for _ in range(g["layers"]):
        caches = {mode: PagedKVCache(PagerConfig(
            page_size=g["page"], n_pages=ps["n_pages"], kv_heads=g["hkv"],
            head_dim=g["d"], weights=g["weights"], dtype="bfloat16",
            kv_dtype=kv_dtype), device="cuda")
            for mode, kv_dtype in (("fp", None), ("int8", "int8"))}
        for sq in range(g["seqs"]):
            kv = torch.randn(2, g["prompt"], g["hkv"], g["d"],
                             generator=gen, device="cuda",
                             dtype=torch.bfloat16)
            for c in caches.values():
                c.allocate(sq)
                c.append(sq, kv[0], kv[1])
        layers.append(caches)
    host = torch.from_numpy(np.nonzero(
        layers[0]["fp"].tier_of_page == 1)[0]).cuda()
    keep = torch.ones(ps["n_pages"], dtype=torch.bool, device="cuda")
    keep[host] = False
    pre = []
    for caches in layers:
        pre.append({m: (c.k_pool.clone(), c.v_pool.clone())
                    for m, c in caches.items()})
        for c in caches.values():
            c.spill_cold_pages()
            # the pages now live only on the host tier, as on a removed
            # expander: the fetch must bring every value back
            c.k_pool[host] = 0
            c.v_pool[host] = 0
    torch.cuda.synchronize()
    evac = {}
    bad = []
    for mode in ("fp", "int8"):
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        infos = [caches[mode].retier((1, 0)) for caches in layers]
        torch.cuda.synchronize()
        ev_s = time.perf_counter() - t0
        ev_launch = dict(kernels.LAUNCHES)
        ev_bytes = sum(i["to_fast"] for i in infos) \
            * layers[0][mode].host_page_bytes
        for li, caches in enumerate(layers):
            c = caches[mode]
            for b, a in zip(pre[li][mode], (c.k_pool, c.v_pool)):
                if mode == "fp":
                    ok = torch.equal(a, b)
                else:
                    want = dequantize_pages_ref(
                        *quantize_pages_ref(b[host]), b.dtype)
                    ok = torch.equal(a[host], want) and bool(
                        (a[host] != 0).any()) and torch.equal(a[keep],
                                                              b[keep])
                if not ok:
                    bad.append((li, f"{mode} evacuation"))
            if c.host_pages(list(range(g["seqs"]))):
                bad.append((li, f"{mode} pages left on the host tier"))
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        moved = 0
        for caches in layers:
            c = caches[mode]
            c.retier(g["weights"])
            moved += c.spill_cold_pages()
        torch.cuda.synchronize()
        rs_s = time.perf_counter() - t0
        rs_launch = dict(kernels.LAUNCHES)
        rs_bytes = moved * layers[0][mode].host_page_bytes
        # the re-spill's host rows against the plain result: bf16 rows are
        # the pools' new host rows, int8 rows and scales their plain
        # quantization
        for li, caches in enumerate(layers):
            c = caches[mode]
            rows = torch.from_numpy(np.nonzero(c.tier_of_page == 1)[0])
            for pool, side in ((c.k_pool, "k"), (c.v_pool, "v")):
                cold = pool[rows.cuda()]
                got = getattr(c, f"{side}_pool_host")[rows]
                if mode == "fp":
                    ok = torch.equal(got, cold.cpu())
                else:
                    wq, ws = quantize_pages_ref(cold)
                    ok = torch.equal(got, wq.cpu()) and torch.equal(
                        getattr(c, f"{side}_scales_host")[rows], ws.cpu())
                if not (ok and rows.numel()):
                    bad.append((li, f"{mode} re-spill host rows ({side})"))
        evac[mode] = {
            "pages_evacuated": sum(i["to_fast"] for i in infos),
            "evacuation_bytes": ev_bytes, "evacuation_s": ev_s,
            "evacuation_gb_per_s": ev_bytes / ev_s / 1e9,
            "respill_pages": moved, "respill_bytes": rs_bytes,
            "respill_s": rs_s, "respill_gb_per_s": rs_bytes / rs_s / 1e9,
            "launches_evacuation": ev_launch, "launches_respill": rs_launch,
            "simulated_migration_s": {
                name: simulated_migration_s(name, ev_bytes)
                for name in ("tpu_v5e", "gh200")}}
        L = g["layers"]
        want_ev = 2 * L if mode == "int8" else 0
        if ev_launch["dequantize_pages"] != want_ev \
                or ev_launch["quantize_pages"] != 0:
            bad.append(("launches", f"{mode} evacuation {ev_launch}"))
        if rs_launch["quantize_pages"] != want_ev \
                or rs_launch["dequantize_pages"] != 0:
            bad.append(("launches", f"{mode} re-spill {rs_launch}"))
    held = set()
    for caches in layers:
        for c in caches.values():
            for name in ("k_pool_host", "v_pool_host", "k_scales_host",
                         "v_scales_host"):
                t = getattr(c, name, None)
                if t is not None:
                    if not t.is_pinned():
                        bad.append(("pinned", name))
                    held.add(t.untyped_storage().data_ptr())
    stray = (_pinned_storages() - pinned_before) - held
    out["evacuation"] = {"layers": g["layers"], "n_pages": ps["n_pages"],
                         "host_pages_per_pool": int(host.numel()),
                         "modes": evac,
                         "pinned_tensors_held": len(held),
                         "pinned_stray": len(stray)}
    if stray:
        bad.append(("pinned", f"{len(stray)} pinned tensors the caches do "
                              "not hold"))
    emit(out)
    if bad:
        raise AssertionError(f"degrade checks failed: {bad}")
    return out


def phase_disagg() -> dict:
    """Disaggregated prefill/decode with the decode node's pager on the
    card: the disagg family's summary (overlap speedup at least
    ``MIN_OVERLAP_SPEEDUP``), ``run_disagg_serve`` at yi-9b's KV geometry
    on ``cxl_pool``, fp and int8, traced, and the qos and interference
    families' rows, each equal to the CPU's. Every time here is
    simulated."""
    from repro_torch.heimdall import disagg, interference, qos
    from repro_torch.obs import Tracer
    from repro_torch.serving.disagg import DisaggConfig, run_disagg_serve

    out = {"phase": "disagg", "simulated": True}
    fam = disagg.disagg_summary(device="cuda")
    _same_reports("disagg_summary", fam, disagg.disagg_summary(device="cpu"))
    out["family"] = fam
    if not (fam["overlap_speedup"] >= disagg.MIN_OVERLAP_SPEEDUP
            and fam["deadline_violations"] == 0):
        raise AssertionError(f"disagg thresholds missed: {fam}")
    runs = {}
    for mode, kv_dtype in (("fp", None), ("int8", "int8")):
        cfg = DisaggConfig(system="cxl_pool", kv_heads=PAGER["hkv"],
                           head_dim=PAGER["d"], requests=PAGER["seqs"],
                           prompt=PAGER["prompt"], kv_dtype=kv_dtype)
        reps = {dev: run_disagg_serve(cfg, tracer=Tracer(clock=lambda: 0.0),
                                      device=dev).to_json()
                for dev in ("cuda", "cpu")}
        _same_reports(f"run_disagg_serve ({mode})", reps["cuda"],
                      reps["cpu"])
        r = reps["cuda"]
        runs[mode] = {k: r[k] for k in (
            "route", "shipped_wire_bytes", "overlap_speedup",
            "mean_completion_s", "makespan_s", "sync_makespan_s")}
        runs[mode]["violations"] = len(r["deadline_violations"])
    runs["wire_bytes_ratio"] = (runs["fp"]["shipped_wire_bytes"]
                                / runs["int8"]["shipped_wire_bytes"])
    out["yi9b_kv_cxl_pool"] = runs
    q_card = [r.csv() for r in qos.qos_decode_admission(device="cuda")]
    q_cpu = [r.csv() for r in qos.qos_decode_admission(device="cpu")]
    _same_reports("qos_decode_admission", q_card, q_cpu)
    out["qos"] = {"summary": qos.qos_summary(), "decode_admission": q_card}
    rows = [r.csv() for fn in interference.ALL_INTERFERENCE for r in fn()]
    out["interference"] = rows
    emit(out)
    if not out["qos"]["summary"]["eta_improvement"] >= 1.3:
        raise AssertionError(f"qos threshold missed: {out['qos']}")
    return out


PROBES = ("pointer_chase", "tier_sum", "tier_scatter_add", "tier_copy")
PROBE_SOURCE = "src/repro_torch/kernels/probes/csrc/probes.cu"
PROBE_REPLACES = {"pointer_chase": "src/repro/heimdall/micro.py:34",
                  "tier_sum": "src/repro/heimdall/micro.py:47",
                  "tier_scatter_add": "src/repro/heimdall/micro.py:136",
                  "tier_copy": "src/repro/heimdall/micro.py:217"}
PCIE5_X16_BYTES_PER_S = 64e9     # PCIe Gen5 x16, each way
SUM_RTOL = 1e-5                  # P2 against a float64 sum, relative
MiB = 1 << 20


def probe_checks(dev) -> dict:
    """P1-P4 against their plain versions at the micro family's shapes, on
    both tiers: P1's final index (every chase and sweep of micro_latency,
    micro_loaded_latency and micro_cache_heatmap; the 16 MiB sweep wraps
    int32), P3's counts and P4's copy exactly, P2 within ``SUM_RTOL`` of a
    float64 sum. The plain P1 runs on a CPU copy of the same values."""
    import numpy as np
    import torch
    from repro_torch.heimdall import micro
    from repro_torch.heimdall.harness import TIERS, place
    from repro_torch.kernels.probes import (pointer_chase, pointer_chase_ref,
                                            tier_copy, tier_scatter_add,
                                            tier_scatter_add_ref, tier_sum)
    out = {"pointer_chase": [], "tier_sum": [], "tier_scatter_add": [],
           "tier_copy": []}
    perm = micro._perm(1 << 16, 0)
    for tier in TIERS:
        p = place(perm, tier, dev)
        for steps in (2048, 1024):
            got = int(pointer_chase(p, steps, device=dev))
            want = pointer_chase_ref(perm, steps)
            out["pointer_chase"].append({"tier": tier, "mode": "chase",
                                         "n": perm.numel(), "steps": steps,
                                         "abs_err": abs(got - want),
                                         "ok": got == want})
    for ws_kb in micro.HEATMAP_WS_KB:
        pc = micro._perm(ws_kb * 256, 1)
        got = int(pointer_chase(pc.to(dev), micro.HEATMAP_STEPS, "sweep"))
        want = pointer_chase_ref(pc, micro.HEATMAP_STEPS, "sweep")
        out["pointer_chase"].append({"tier": "hbm", "mode": "sweep",
                                     "n": pc.numel(),
                                     "steps": micro.HEATMAP_STEPS,
                                     "abs_err": abs(got - want),
                                     "ok": got == want})
    for tier in TIERS:
        for nbytes in (32 * MiB, 16 * MiB, 4 * MiB, 256 << 10):
            x = place(torch.arange(nbytes // 4, dtype=torch.float32), tier,
                      dev)
            got = float(tier_sum(x, device=dev))
            want = float(x.double().sum())
            rel = abs(got - want) / abs(want)
            out["tier_sum"].append({"tier": tier, "bytes": nbytes,
                                    "abs_err": abs(got - want),
                                    "rel_err": rel, "ok": rel <= SUM_RTOL})
    for tier, collide, idx in micro.atomics_inputs():
        n = idx.size
        t = place(torch.zeros(n, dtype=torch.float32), tier, dev)
        ii = torch.from_numpy(idx).to(dev)
        u = torch.ones(n, dtype=torch.float32, device=dev)
        tier_scatter_add(t, ii, u)
        torch.cuda.synchronize()
        want = tier_scatter_add_ref(torch.zeros(n), ii.cpu(), u.cpu())
        out["tier_scatter_add"].append({
            "tier": tier, "collide": collide,
            "abs_err": float((t.cpu() - want).abs().max()),
            "ok": bool(torch.equal(t.cpu(), want)),
            "max_count": float(t.max())})
    for tier in TIERS:
        for kb in (64, 1024, 8192):
            x = place(torch.arange(kb * 256, dtype=torch.float32), tier, dev)
            o = tier_copy(x, torch.empty(x.numel(), dtype=torch.float32,
                                         device=dev))
            out["tier_copy"].append({
                "tier": tier, "kb": kb,
                "abs_err": float((o.cpu() - x.cpu()).abs().max()),
                "ok": bool(torch.equal(o.cpu(), x.cpu()))})
    torch.cuda.synchronize()
    return out


def probe_timings(dev) -> dict:
    """Each probe's time at the micro family's shape beside its plain
    version's, one library call's where one computes the same function,
    and its bound: P1 a 2048-step chase of the 256 KiB working set (hbm,
    and host for the contrast); P2 a 32 MiB sum (hbm with a cold L2; host
    beside the copy engine's bulk copy of the same bytes); P3 16384 spread
    updates into hbm; P4 an 8 MiB copy from host memory, beside the copy
    engine's."""
    import torch
    from repro_torch.heimdall import micro
    from repro_torch.heimdall.harness import place
    from repro_torch.kernels.probes import (pointer_chase, pointer_chase_ref,
                                            tier_copy, tier_copy_ref,
                                            tier_scatter_add,
                                            tier_scatter_add_ref, tier_sum,
                                            tier_sum_ref)
    out = {}
    perm = micro._perm(1 << 16, 0)
    p = {tier: place(perm, tier, dev) for tier in ("hbm", "host")}
    steps = 2048
    chase = {tier: cuda_ms(lambda t=tier: pointer_chase(p[t], steps,
                                                        device=dev))
             for tier in ("hbm", "host")}
    out["pointer_chase"] = {
        "kernel_ms": chase["hbm"], "host_ms": chase["host"],
        "ns_per_access": {t: ms * 1e6 / steps for t, ms in chase.items()},
        "kernel_device": device_ms_per_call(
            lambda: pointer_chase(p["hbm"], steps, device=dev)),
        "library_device": None,
        "plain_ms": cuda_ms(lambda: pointer_chase_ref(p["hbm"], steps),
                            iters=2, warmup=1),
        "library_ms": None, **bound(steps * 4 + 4)}

    n = 32 * MiB // 4
    sets = [place(torch.arange(n, dtype=torch.float32), "hbm", dev)
            for _ in range(cold_sets(32 * MiB))]
    x_host = place(torch.arange(n, dtype=torch.float32), "host", dev)
    run = rotation([lambda a=a: tier_sum(a, device=dev) for a in sets])
    lib = rotation([lambda a=a: torch.sum(a) for a in sets])
    host_ms = cuda_ms(lambda: tier_sum(x_host, device=dev))
    dst = torch.empty(n, dtype=torch.float32, device=dev)
    bulk_ms = cuda_ms(lambda: dst.copy_(x_host, non_blocking=True))
    # a call is a memset of its scratch and the kernel: two device events
    out["tier_sum"] = {
        "kernel_ms": cuda_ms(run),
        "kernel_device": device_ms_per_call(run, kernels_per_call=2),
        "plain_ms": cuda_ms(rotation([lambda a=a: tier_sum_ref(a, dev)
                                      for a in sets])),
        "library_ms": cuda_ms(lib),
        "library_device": device_ms_per_call(lib, kernels_per_call=None),
        "host_ms": host_ms, "host_gb_per_s": 32 * MiB / host_ms / 1e6,
        "bulk_copy_ms": bulk_ms,
        "bulk_copy_gb_per_s": 32 * MiB / bulk_ms / 1e6,
        **bound(32 * MiB + 4)}

    m = 1 << 14
    idx = torch.from_numpy(micro.atomics_inputs(m)[0][2]).to(dev)
    u = torch.ones(m, dtype=torch.float32, device=dev)
    t = torch.zeros(m, dtype=torch.float32, device=dev)
    out["tier_scatter_add"] = {
        "kernel_ms": cuda_ms(lambda: tier_scatter_add(t, idx, u)),
        "kernel_device": device_ms_per_call(
            lambda: tier_scatter_add(t, idx, u)),
        "plain_ms": cuda_ms(lambda: tier_scatter_add_ref(t, idx, u)),
        "library_ms": cuda_ms(lambda: t.index_add_(0, idx, u)),
        "library_device": device_ms_per_call(
            lambda: t.index_add_(0, idx, u), kernels_per_call=None),
        **bound(2 * m * 4 + 2 * m * 4)}

    nb = 8 * MiB
    xh = place(torch.arange(nb // 4, dtype=torch.float32), "host", dev)
    o = torch.empty(nb // 4, dtype=torch.float32, device=dev)
    out["tier_copy"] = {
        "kernel_ms": cuda_ms(lambda: tier_copy(xh, o)),
        "kernel_device": device_ms_per_call(lambda: tier_copy(xh, o)),
        "plain_ms": cuda_ms(lambda: tier_copy_ref(xh, o)),
        "library_ms": cuda_ms(lambda: o.copy_(xh, non_blocking=True)),
        "library_device": device_ms_per_call(
            lambda: o.copy_(xh, non_blocking=True), kernels_per_call=None),
        "link_bound_ms": nb / PCIE5_X16_BYTES_PER_S * 1e3,
        **bound(2 * nb)}
    return out


def _fit_json(profile) -> dict:
    return {f"{e.src}->{e.dst}": {
        "source": sorted({s.source for s in profile.samples
                          if (s.src, s.dst) == (e.src, e.dst)}),
        "bandwidth_gb_per_s": e.bandwidth / 1e9,
        "latency_us": e.latency * 1e6, "rel_residual": e.rel_residual,
        "efficiency": e.efficiency, "downweighted": e.n_downweighted,
        "samples": e.n_samples} for e in profile.links}


def phase_heimdall(fetch_gb_per_s=None) -> dict:
    """HEIMDALL on the card: (a) P1-P4 held against their plain versions;
    (b) the micro family at the reference's default sizes on hbm and host,
    every row, counted: each probe must launch; P1's ns per access per
    tier and P2's host GB/s beside the copy engine's for the same bytes;
    (c) the app family, every row; (d) CalibrationRunner("tpu_v5e",
    source="torch"): the fit per route from copies timed on the card, the
    profile written to build/, the host link's fitted bandwidth above
    0 and at most PCIe Gen5 x16's 64 GB/s, beside serve_offload's fetch
    rate where that phase ran; (e) the profile through the three calibrated
    paths with their pagers on the card, each report equal to the CPU's."""
    import torch
    from repro_torch import kernels
    from repro_torch.calibrate import CalibrationProfile, CalibrationRunner
    from repro_torch.heimdall import apps, micro
    from repro_torch.launch.serve import simulate_paged_decode
    from repro_torch.obs import DriftSentinel, Tracer
    from repro_torch.runtime.degrade import (host_link_degraded,
                                             run_degraded_serve)
    from repro_torch.serving.disagg import DisaggConfig, run_disagg_serve

    dev = torch.device("cuda", 0)
    out = {"phase": "heimdall", "checks": probe_checks(dev)}
    failed = [f"{name} {c}" for name, cases in out["checks"].items()
              if isinstance(cases, list) for c in cases if not c["ok"]]

    kernels.reset_launches()
    t0 = time.perf_counter()
    rows = [r.csv() for fn in micro.ALL_MICRO for r in fn(device=dev)]
    out["micro_s"] = time.perf_counter() - t0
    out["launches"] = {k: kernels.LAUNCHES[k] for k in PROBES}
    out["micro"] = rows
    failed += [f"{k} never launched on the micro family's path"
               for k, v in out["launches"].items() if v == 0]
    derived = {r.split(",")[0]: r.split(",", 2)[2] for r in rows}
    out["ns_per_access"] = {t: derived[f"micro_latency/{t}"]
                            for t in ("hbm", "host")}
    t0 = time.perf_counter()
    out["apps"] = [r.csv() for fn in apps.ALL_APPS for r in fn(device=dev)]
    out["apps_s"] = time.perf_counter() - t0
    out["timing"] = probe_timings(dev)
    ts = out["timing"]["tier_sum"]
    out["host_loads_vs_copy_engine"] = {
        "bytes": 32 * MiB, "p2_host_gb_per_s": ts["host_gb_per_s"],
        "bulk_copy_gb_per_s": ts["bulk_copy_gb_per_s"]}

    t0 = time.perf_counter()
    profile = CalibrationRunner("tpu_v5e", source="torch",
                                device=dev).calibrate()
    out["calibrate_s"] = time.perf_counter() - t0
    dest = ROOT / "build"
    dest.mkdir(exist_ok=True)
    profile.save(str(dest / "heimdall_profile.json"))
    if CalibrationProfile.load(str(dest / "heimdall_profile.json")) \
            .to_json() != profile.to_json():
        failed.append("the saved profile does not load back equal")
    out["profile"] = {"source": profile.source, "machine": profile.machine,
                      "fit": _fit_json(profile)}
    host = profile.estimate("host_dram", "chip0")
    out["host_link"] = {"fitted_gb_per_s": host.bandwidth / 1e9,
                        "fitted_latency_us": host.latency * 1e6,
                        "serve_offload_fetch_gb_per_s": fetch_gb_per_s}
    if not 0 < host.bandwidth <= PCIE5_X16_BYTES_PER_S:
        failed.append(f"fitted host bandwidth {host.bandwidth / 1e9} GB/s "
                      f"is outside (0, 64]")

    reps = {}
    for where in ("cuda", "cpu"):
        sent = DriftSentinel(profile, preset="tpu_v5e")
        reps[where] = {
            "paged_decode": simulate_paged_decode(
                calibration_profile=profile, device=where),
            "disagg": run_disagg_serve(
                DisaggConfig(system="tpu_v5e"), calibration_profile=profile,
                tracer=Tracer(clock=lambda: 0.0), device=where).to_json(),
            "degraded": run_degraded_serve(
                host_link_degraded(), calibration_profile=profile,
                sentinel=sent, recalibrate=True, device=where).to_json()}
    for what in reps["cuda"]:
        _same_reports(f"calibrated {what}", reps["cuda"][what],
                      reps["cpu"][what])
    deg = reps["cuda"]["degraded"]
    out["calibrated"] = {
        "paged_decode": {k: reps["cuda"]["paged_decode"][k]
                         for k in ("calibrated", "bytes_reduction",
                                   "prefetch_speedup")},
        "disagg_route": reps["cuda"]["disagg"]["route"],
        "degraded": {"detect_round": deg["detect_round"],
                     "recovery_frac": deg["recovery_frac"],
                     "recals": len(deg.get("recal") or ())}}
    if not deg.get("recal"):
        failed.append("the recalibrating degraded serve never recalibrated")
    emit(out)
    if failed:
        raise AssertionError("; ".join(failed))
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


def kernels_line(kern: dict, serve: dict, offload: dict, paged: dict,
                 pager: dict, flat: dict, compressed: dict,
                 heimdall: dict) -> dict:
    """Every ported kernel: launches on its main paths (K1: the HBM and the
    offloaded engines' counted runs; P1-P4: the micro family's), agreement
    with its plain version, its times at the main path's shape, and its
    share of its bound (bound over device time, or over event time where
    the profiler recorded none)."""
    yi = kern["yi_prefill_bf16"]
    rows = [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:26",
        "launches": serve["launches"]["flash_attention"]
        + offload["launches"]["flash_attention"],
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
    checks = heimdall["checks"]
    for name in PROBES:
        t = heimdall["timing"][name]
        cases = checks[name]
        row = {
            "name": name, "route": "cuda", "source": PROBE_SOURCE,
            "replaces": PROBE_REPLACES[name],
            "launches": heimdall["launches"][name],
            "matched": all(c["ok"] for c in cases),
            "max_abs_err": max(c["abs_err"] for c in cases),
            "ms": t["kernel_ms"], **_device_cols(t),
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_us"] / 1e3, "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]}
        if name == "tier_sum":
            row["max_rel_err"] = max(c["rel_err"] for c in cases)
        if name == "pointer_chase":
            row["ns_per_access"] = t["ns_per_access"]
        if "host_ms" in t:
            row["host_ms"] = t["host_ms"]
        if "link_bound_ms" in t:
            row["link_bound_ms"] = t["link_bound_ms"]
        rows.append(row)
    for row in rows:
        row["bound_share"] = round(
            row["bound_ms"] / (row["kernel_device_ms"] or row["ms"]), 3)
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
    offload = phase_serve_offload(serve.pop("tokens"))
    pager = phase_pager()
    phase_degrade()
    phase_disagg()
    heimdall = phase_heimdall(offload["fetch_gb_per_s"])
    phase_paged_sim()
    phase_kv_quant()
    emit(kernels_line(kern, serve, offload, paged, pager, flat, compressed,
                      heimdall))


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


ONLY = {"serve": phase_serve, "serve_offload": phase_serve_offload,
        "pager": phase_pager, "paged_kernels": phase_paged_kernels,
        "degrade": phase_degrade, "disagg": phase_disagg,
        "heimdall": phase_heimdall}


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
        tokens = None
        for name in only:
            if name == "serve_offload":
                phase_serve_offload(tokens)
            elif name == "serve":
                tokens = phase_serve()["tokens"]
            else:
                ONLY[name]()
    else:
        phase_all()
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
