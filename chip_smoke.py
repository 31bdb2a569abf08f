#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py                       # every phase
    python3 chip_smoke.py --only serve,pager    # just those, after the build
    python3 chip_smoke.py --only paged_kernels  # K2-K5 alone, after the build
    python3 chip_smoke.py --only serve,serve_offload  # HBM, then offloaded
    python3 chip_smoke.py --only degrade,disagg # the pager's consumers
    python3 chip_smoke.py --only heimdall       # probes, micro, apps, fit
    python3 chip_smoke.py --only models         # the model zoo
    python3 chip_smoke.py --only kernel         # K1's holds and timing
    python3 chip_smoke.py --only decode_kernel  # K8's holds and timing
    python3 chip_smoke.py --only norm_rope_kernel  # K9's and K10's
    python3 chip_smoke.py --only serve,mesh,dryrun  # the mesh path, dry-run
    python3 chip_smoke.py --only heimdall,tooling   # the runner, examples

Phases, one JSON line each, in this order (the train phases come first,
while the host has the most memory to pin):

  device         the card (nvidia-smi name and power limit), torch and CUDA
                 versions
  build          every kernel family's library (flash attention, paged
                 attention, quant, probes, decode attention, norm and
                 rope) compiled by
                 nvcc for sm_90a from the repo's .cu sources, all at once;
                 seconds and ptxas register/spill lines for each, and the
                 tensor-core (HMMA) instructions in each paged attention
                 kernel's SASS
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
                 at the kernel sweep shapes and the yi-9b, mixtral-8x22b and
                 qwen2-vl-72b prefill shapes and whisper-small's encoder
                 shape (S = 1500, bidirectional, d 64), fp32 and bf16; at
                 the yi-9b, whisper and qwen2-vl shapes in bf16 its time
                 beside the plain version's, one scaled_dot_product_attention
                 call (a yardstick only; the port never calls it) and the
                 least time the card could take
  decode_kernel  K8 (dense GQA decode attention over the (B, S, Hkv, d)
                 cache, the position read on the device) against its plain
                 version at yi-9b's and mixtral-8x22b's decode shapes (64
                 sequences, a 544-slot cache, 528 live keys; fp32 and
                 bf16), one launch a call; in bf16 its time (CUDA events
                 and device time, inputs cold: a rotation of distinct
                 caches, twice the L2 together) beside the plain version's
                 and the byte bound
  norm_rope_kernel  K9 (RMS norm, alone and with its residual add) and K10
                 (rope on q and k) against their plain versions at yi-9b's
                 and mixtral-8x22b's prefill and decode shapes in bf16
                 (rope and the sum bit for bit), one launch a call; their
                 device times with the inputs cold beside the plain
                 versions' and the byte bounds
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
  mesh           the serve phase's yi-9b weights (views, no second copy) as
                 DTensors on a one-rank NCCL mesh (make_host_mesh), K1 on
                 the mesh path: the serve phase's 4 prompts prefilled and
                 32 greedy decode steps through Model.prefill / decode;
                 exactly 48 K1 launches a prefill, the tokens equal to
                 those of the path without a mesh run with the plain decode
                 attention the mesh path keeps (the serve phase's, which
                 K8 decodes, printed beside them), the prefill logits
                 within LOGITS_REL_L2 of its kernel path's, every weight
                 leaf a DTensor over the serve phase's storage; prefill and
                 decode wall and device
                 times beside the plain path's on the same weights (the
                 difference is DTensor's host time on one rank), and the
                 peak allocated bytes over one prefill of the dry-run's
                 one-chip cell (4 x 1024, no decode room)
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
  models         the model zoo, each with seeded bf16 weights drawn on the
                 card, 4 requests; through ServeEngine: gemma3-27b
                 uncut (62 layers, 56.84 GB; prompts of 2048 tokens, twice
                 its local layers' 1024-token window, and 32 new tokens),
                 exactly 62 K1 launches a prefill, 52 of them windowed (both
                 counted where K1 launches), and K1 device time > 0 in a
                 profiled prefill, the kernel path's prefill logits within
                 relative L2 3e-2 of the eager path's, and each of 8 held
                 decode steps (the ring caches have wrapped; 32 are
                 generated) within 3e-2 of an eager full forward over the
                 prompt and the tokens fed so far; mixtral-8x22b at full
                 width with 8 of its 56 layers (1024-token prompts, 8 K1
                 launches, all windowed, the prefill's dropped (token, slot)
                 pairs printed); zamba2-7b and xlstm-350m uncut (1024-token
                 prompts, no K1, as in the reference; 8 decode steps each
                 at most DECODE_GAP_RATIO times as far from an eager fp32
                 forward as the eager bf16 forward is, and xlstm's also
                 within 3e-2 of the bf16 forward); qwen2-vl-72b at full
                 width with 28 of its 80 layers (54.2 GB; served by tokens,
                 as the reference's engine does: 1024-token prompts, 28 K1
                 launches a prefill, 8 held decode steps within 3e-2 of the
                 eager forward), then its M-RoPE grid batch (the prompt's
                 token embeddings with a 24 x 24 image grid of (t, h, w)
                 positions) through K1 against the eager path, 4 decode
                 steps against the forward over the same positions, and
                 apply_rope on the card at head dim 128 over the grid
                 within 1e-2 of the reference's M-RoPE formula in float64
                 (plain RoPE's positions over 1e-1 from it);
                 deepseek-v3 at full width with its 3 dense and 2 of its MoE
                 layers (53 GB; MLA on chunked attention, no K1, the dropped
                 (token, slot) pairs printed), then its MLA decode on the
                 dense layers alone, 8 steps within 3e-2 of the forward;
                 and through Model.prefill({"frames"}) and Model.decode (the
                 engine serves token prompts): whisper-small uncut (4 x 1500
                 frames drawn from the seed, a fixed start token, 32 greedy
                 steps; exactly 12 K1 launches a prefill, none windowed, the
                 encoder through K1 within 3e-2 of the eager encoder, the
                 cross caches (12, 4, 1500, 12, 64) within 1e-2 of the
                 encoder output's projections, every decode step within
                 3e-2 of an eager encdec_forward). After deepseek-v3,
                 zamba2-7b, xlstm-350m and whisper-small each run plain,
                 the same weights (views, no second copy) as DTensors on a
                 one-rank NCCL mesh: 8 greedy steps on the plain and the
                 mesh path, tokens equal, the prefill logits (whisper: the
                 encoder output and the first step's logits) within 3e-2,
                 exactly 12 K1 launches in whisper's mesh prefill and K1
                 on the mesh body's local heads (the first encoder layer's
                 q, k, v) within 1e-2 of flash_attention_ref; both paths'
                 prefill and decode walls and device times. Each prints prefill and
                 decode times, tokens/s, device time and idle share, peak memory,
                 and the bf16 noise floor of the comparison (the eager
                 forward of each request alone against the batch). Before
                 gemma3 the card must hold under 1 GB; each engine is freed
                 before the next. Then K1 at gemma3's local (window 1024)
                 and global shapes against its plain version, its time
                 beside the plain version's, the fastest SDPA form that
                 computes the same attention (the window as a mask: cuDNN,
                 memory-efficient with GQA or on expanded K/V, math; each
                 tried, held and timed) and the bound of the unmasked work
  tooling        HEIMDALL's runner and the four examples, as a user runs
                 them: heimdall.run.main(["--json-out-dir", build/tooling])
                 in this process, all nine families at the reference's
                 default sizes (each family's stderr line ran=all,
                 failed=0, no ERROR row; each family's wall); the six
                 BENCH_<family>.json files held to every assertion of the
                 reference CI's benchmark steps (.github/workflows/ci.yml:
                 22-166, the thresholds read from each file where CI reads
                 them; each value printed beside its limit); kv_quant's and
                 obs's summaries equal to the CPU's but for obs's overhead
                 timings; K1 (the obs family's engine), K2, K3 and P1-P4
                 launched in the runner, K4 and K5 counted; then, as
                 subprocesses started together, `python -m
                 repro_torch.heimdall.run --families qos --json-out` (equal
                 to the in-process BENCH_qos.json) and CI's two artifact
                 steps through the port: a traced --paged-sim serve (a
                 valid Chrome trace, metrics, OpenMetrics ending in # EOF)
                 and --degrade-sim's flight recorder (valid, its reason not
                 the fallback "dump"); quickstart on the card and on the
                 CPU (its checkpoint directory removed first; arch,
                 placement and cost-model lines equal, 10 finite losses, 8
                 tokens a request in the vocabulary, one K1 launch a layer
                 at head dim 16, the prefill logits within LOGITS_REL_L2 of
                 the eager path's), serve_batched (both arms printed),
                 offload_tuning with its defaults and with the card's
                 memory, the heimdall phase's fitted host link and 989
                 TFLOP/s, and train_tiny_lm's full deliverable (lm-100m,
                 300 steps of 8 x 256, checkpoints at steps 75, 150 and 225
                 into build/tooling/: 300 finite losses, improved; step
                 wall, tokens/s, peak memory and checkpoint seconds)
  dryrun         python -m repro_torch.launch.dryrun in subprocesses, all
                 at once, after every timed phase (its processes load the
                 host's cores), on the fake 16x16 production mesh (a fake
                 process group of 256 ranks, no traffic): yi-9b decode_32k,
                 yi-9b train_4k (FSDP, one microbatch), mixtral-8x22b
                 prefill_32k (which must reach the MoE tensor-parallel
                 body), deepseek-v3-671b decode_32k (MLA; the
                 expert-parallel body), zamba2-7b long_500k (the
                 sequence-sharded cache), xlstm-350m train_4k (one
                 microbatch; heads split over 16 ranks) and whisper-small
                 prefill_32k (K1 on local heads); each record ok, its
                 per-chip parameter bytes equal to what spec_for gives,
                 walker FLOPs > 0, a bottleneck of the three, train_4k's
                 MODEL/walker FLOP ratio in the reference's 0.03-1.6; then
                 the one-rank cell of yi-9b's served prefill (4 x 1024,
                 K1, bf16): its predicted peak bytes within
                 DRYRUN_PEAK_TOL of the mesh phase's measured peak, and its
                 walker FLOPs and bytes through a ChipSpec of the card's
                 own rates (the best bf16 torch.matmul rate at the
                 prefill's GEMM shapes, a device copy's rate) against the
                 measured prefill device time: the roofline fraction
                 (printed, not held)
  kernels       every ported kernel (K1-K7, K1 again at whisper-small's
                 encoder, qwen2-vl-72b's prefill and gemma3-27b's two
                 shapes, then the probes P1-P4) with its
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
# straddles the 128-key tiles, zamba2's head dim (112) and one between the
# kernel's instantiations (80, bidirectional and windowed), and the yi-9b
# prefill shape of the serve phase
SWEEP = [(1, 2, 2, 128, 64, True, 0), (2, 4, 2, 128, 64, True, 0),
         (2, 8, 1, 128, 32, True, 0), (1, 2, 2, 128, 64, False, 0),
         (1, 2, 2, 256, 64, True, 64), (1, 2, 2, 128, 128, True, 0),
         (1, 4, 2, 100, 16, True, 0), (2, 16, 2, 300, 128, True, 200),
         (1, 8, 2, 200, 112, True, 0), (2, 8, 8, 256, 80, False, 64)]
YI_PREFILL = (4, 32, 4, 1024, 128, True, 0)
# the models phase's mixtral-8x22b prefill: 48 / 8 heads of 128, 1024
# tokens under its 4096-token window
MIXTRAL_PREFILL = (4, 48, 8, 1024, 128, True, 4096)
# the models phase's two new K1 shapes: whisper-small's encoder (4 requests
# of 1500 frames, 12 MHA heads of 64, bidirectional; 1500 is ragged against
# every tile) and qwen2-vl-72b's prefill (64 / 8 heads of 128, causal)
WHISPER_ENCODER = (4, 12, 12, 1500, 64, False, 0)
QWEN2VL_PREFILL = (4, 64, 8, 1024, 128, True, 0)
K1_MODEL_SHAPES = {"whisper_encoder": WHISPER_ENCODER,
                   "qwen2vl_prefill": QWEN2VL_PREFILL}
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
# The models phase: (arch, layers kept (None: all of them), prompt tokens,
# new tokens, decode steps held within LOGITS_REL_L2 of an eager bf16 full
# forward, decode steps held to DECODE_GAP_RATIO against an eager forward in
# fp32 activations, K1 launches a prefill (all, windowed)). All in bf16
# activations. gemma3's prompts are twice its 1024-token window, so
# the window mask bites in K1 and the ring caches have wrapped when decode
# starts; mixtral keeps 8 of its 56 layers (full width, 40.87 GB); zamba2
# and xlstm run no K1, as in the reference. The eager forward runs the
# serving roles' dropless MoE layers, as prefill and decode do. Mixtral's
# decode steps are not held against the forward (none held). zamba2's
# decode is held to the fp32 forward only: its bf16 forward differs from
# itself by 2.8e-2 (relative L2) when each request runs alone instead of
# in the batch (81 random layers amplify the GEMMs' other summation order),
# so against the bf16 forward a 3e-2 bound cannot tell a fault from
# rounding.
#
# qwen2-vl-72b keeps 28 of its 80 layers at full width (49.2 GB of layers
# and 4.98 GB of embeddings, room left for the checks' eager forward) and is
# served by tokens, as the reference's engine serves it (M-RoPE's rows
# equal); its M-RoPE grid batch is MROPE_GRID below. deepseek-v3 keeps its 3
# dense layers and 2 of its 58 MoE layers (53 GB); it runs no K1 (MLA takes
# chunked attention, as in the reference) and its MoE decode is not held
# against a forward either: its MLA decode is held instead,
# on the dense layers alone (MLA_DENSE_STEPS).
MODELS = [("gemma3-27b", None, 2048, 32, 8, 0, (62, 52)),
          ("mixtral-8x22b", 8, 1024, 16, 0, 0, (8, 8)),
          ("zamba2-7b", None, 1024, 16, 0, 8, (0, 0)),
          ("xlstm-350m", None, 1024, 16, 8, 8, (0, 0)),
          ("qwen2-vl-72b", 28, 1024, 32, 8, 0, (28, 0)),
          ("deepseek-v3-671b", 5, 1024, 16, 0, 0, (0, 0))]
# whisper-small uncut through Model.prefill({"frames"}) and Model.decode
# (the engine serves token prompts): 4 requests of 1500 frames (30 s of
# audio) drawn from the seed, a fixed start token, 32 greedy steps with the
# self cache sized to them; exactly 12 K1 launches a prefill (its encoder)
WHISPER = {"requests": 4, "gen": 32, "start_token": 50258, "seed": 0,
           "k1": (12, 0)}
# qwen2-vl's M-RoPE grid batch: the prompt's token embeddings (the vision
# stub's embeds, as the reference's test builds them) with text positions
# for the first 128 tokens, then a 24 x 24 image grid (t fixed, h the row,
# w the column, all from 128), then text from 152 on; held through K1
# against the eager path and for 4 decode steps against the eager forward
# over the same positions (new tokens at their decode position in all
# three axes, as decode_step places them). Both paths turn q and k by the
# same apply_rope, and with random weights the grid's positions move the
# last logits by about as much as bf16 rounding (1.1e-2 against plain
# RoPE's positions, read on an H100 80GB HBM3 at 700 W), so the section
# split itself is held
# where it shows: apply_rope over the grid against the reference's formula
MROPE_GRID = {"text": 128, "side": 24, "steps": 4}
# deepseek-v3's MLA decode on its 3 dense layers (the MoE layers' weights
# left out): greedy steps held within LOGITS_REL_L2 of the eager forward
MLA_DENSE_STEPS = 8
# A bf16 decode step's gap to the forward in fp32 activations (the same
# weights and tokens) may be at most this many times the bf16 forward's own
# gap to it. Read on the card at full width: 0.98-1.05 for zamba2 (gaps of
# 5.4-6.1e-2), 0.96-1.03 for xlstm; on the CPU at full depth and reduced
# width the reference's own decode reads 0.89-1.04 and the port's 1.00
# (tests/test_torch_decode_parity.py holds both sides to this limit). A
# fault on the bf16 decode path alone gives many times it (a mutation that
# drops the Mamba2 skip term in bf16 read 9-22 there); a rounding of one
# step's state or step size to bf16 stays at 1.
DECODE_GAP_RATIO = 1.25
# The models phase's mesh runs: after deepseek-v3, zamba2-7b, xlstm-350m
# and whisper-small run plain, the same weights (views, no second copy) as
# DTensors on a one-rank NCCL mesh; MESH_STEPS greedy decode steps on each
# path, tokens equal, prefill logits (whisper: the encoder output and the
# first step's logits) within LOGITS_REL_L2; device times over MESH_PROFILED
# decode steps
MESH_ARCHS = ("deepseek-v3-671b", "zamba2-7b", "xlstm-350m")
MESH_STEPS = 8
MESH_PROFILED = 2
# device memory allowed in use before gemma3's 56.84 GB are drawn
MODELS_START_BYTES = 1e9
# The dryrun phase: production-mesh cells (one serve, one train with FSDP,
# one through the MoE tensor-parallel body; deepseek-v3's MLA decode through
# the expert-parallel body over 256 ranks, zamba2's sequence-sharded
# long_500k cache, xlstm's backward through heads split over 16 ranks,
# whisper's encoder through K1 on local heads), each in its own process,
# with any extra flags; the one-chip cell's predicted peak is held within
# this fraction of the measured one; each train cell's MODEL/walker FLOP
# ratio within the reference's bounds (tests/test_roofline.py). The train
# cells take one microbatch: the reference's plan for yi-9b (8 of 2
# sequences a data shard) traced in 193-262 s on the H100 machine's host,
# the script's largest single wait.
DRYRUN_CELLS = [("yi-9b", "decode_32k", ()),
                ("yi-9b", "train_4k", ("--microbatches", "1")),
                ("mixtral-8x22b", "prefill_32k", ()),
                ("deepseek-v3-671b", "decode_32k", ()),
                ("zamba2-7b", "long_500k", ()),
                ("xlstm-350m", "train_4k", ("--microbatches", "1")),
                ("whisper-small", "prefill_32k",
                 ("--attention-kernel", "kernel"))]
DRYRUN_PEAK_TOL = 0.25
DRYRUN_TRAIN_RATIO = (0.03, 1.6)
DRYRUN_TIMEOUT_S = 420



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


def profile_device(fn, attempts: int = 1, cpu: bool = True):
    """Run ``fn`` under torch.profiler; return (its result, the device time
    in ms summed over every kernel, {kernel name: its device ms}). A
    recording that holds no device event is made again, up to ``attempts``
    times (give more than one only where running ``fn`` again changes
    nothing that is checked); after that the device time is None (not
    measured). ``cpu=False`` records the device's activity alone: a run of
    hundreds of thousands of small ops (xlstm's sLSTM loop) then takes
    seconds, not a minute, to sum."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] if cpu else []
    for attempt in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=acts + [ProfilerActivity.CUDA]) as prof:
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


def k1_timing(shape, gen) -> dict:
    """K1 in bf16 at ``shape`` (no window): its time (CUDA events and
    device time), the plain version's, one SDPA call that computes the same
    attention (``is_causal`` as the shape says, GQA heads as they are; held
    against the plain version too) and the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    causal = shape[5]
    q, k, v = _qkv(shape, "bfloat16", gen)

    def kern():
        return flash_attention(q, k, v, causal=causal)

    def plain():
        return flash_attention_ref(q, k, v, causal=causal)

    def library():
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                              enable_gqa=True)
    timing = {
        "kernel_ms": cuda_ms(kern),
        "kernel_device": device_ms_per_call(kern),
        "plain_ms": cuda_ms(plain),
        "library_ms": cuda_ms(library),
        "library_device": device_ms_per_call(library, kernels_per_call=None),
        "library_rel_l2": _rel_l2(library(), plain()),
    }
    bound = attention_bound(shape, "bfloat16")
    timing.update(bound_us=bound["bound_ms"] * 1e3,
                  bound_by=bound["bound_by"], flops=bound["flops"],
                  bytes=bound["bytes"],
                  tflops=bound["flops"] / timing["kernel_ms"] / 1e9,
                  roofline_share=bound["bound_ms"] / timing["kernel_ms"],
                  roofline_share_device=ratio(
                      bound["bound_ms"], timing["kernel_device"]["ms"]))
    return timing


def phase_kernel() -> dict:
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for dtype in ("float32", "bfloat16"):
        for shape in (*SWEEP, YI_PREFILL, MIXTRAL_PREFILL,
                      *K1_MODEL_SHAPES.values()):
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

    def held(shape):
        c = next(c for c in cases if c["dtype"] == "bfloat16"
                 and c["shape"] == list(shape))
        return {"max_abs_err": c["max_abs_err"], "rel_l2": c["rel_l2"]}
    out = {"phase": "kernel", "kernel": "flash_attention", "cases": cases,
           "yi_prefill_bf16": {**k1_timing(YI_PREFILL, gen),
                               **held(YI_PREFILL)},
           "model_shapes": {name: {**k1_timing(shape, gen), **held(shape),
                                   "shape": list(shape)}
                            for name, shape in K1_MODEL_SHAPES.items()}}
    emit(out)
    if bad:
        raise AssertionError(f"flash_attention disagrees with its plain "
                             f"version: {bad}")
    sdpa = {n: t["library_rel_l2"] for n, t in out["model_shapes"].items()
            if t["library_rel_l2"] > BF16_REL_L2}
    if sdpa:
        raise AssertionError(f"SDPA does not compute K1's attention at "
                             f"{sdpa}")
    return out


# (B, Hq, Hkv, S, d, live keys) of the HBM cells' decode: 64 sequences of
# 512 prompt tokens and 32 new, at the 16th new token
K8_SHAPES = {"yi-9b": (64, 32, 4, 544, 128, 528),
             "mixtral-8x22b": (64, 48, 8, 544, 128, 528)}


def decode_attention_bound(B, Hq, Hkv, d, live, size: int) -> dict:
    """K8: the live K and V rows read once, q read and the output written
    once, against P . V's fp32 FMAs (2 * d FLOP per query head and live
    key; q . k runs on the tensor cores)."""
    kv = 2 * B * live * Hkv * d * size
    return bound(kv + 2 * B * Hq * d * size, 2.0 * B * Hq * d * live)


def phase_decode_kernel() -> dict:
    """K8 against its plain version at the HBM cells' decode shapes (fp32
    and bf16), then its bf16 time beside the plain version's and the
    bound."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.decode_attention import (
        dense_decode_attention, dense_decode_attention_ref)
    from repro_torch.kernels.decode_attention.ops import split_plan
    gen = torch.Generator(device="cuda").manual_seed(8)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def inputs(shape, dtype, sets=1):
        B, Hq, Hkv, S, d, live = shape
        dt = getattr(torch, dtype)

        def randn(*dims):
            return torch.randn(*dims, generator=gen, device="cuda").to(dt)
        pos = torch.tensor([live - 1], device="cuda")
        return [(randn(B, 1, Hq, d), randn(B, S, Hkv, d),
                 randn(B, S, Hkv, d), pos) for _ in range(sets)]

    cases, timing = [], {}
    for name, shape in K8_SHAPES.items():
        for dtype in ("float32", "bfloat16"):
            (q, k, v, pos), = inputs(shape, dtype)
            before = kernels.LAUNCHES["decode_attention"]
            out = dense_decode_attention(q, k, v, pos)
            launches = kernels.LAUNCHES["decode_attention"] - before
            ref = dense_decode_attention_ref(q, k, v, pos)
            torch.cuda.synchronize()
            c = _compare(out, ref, dtype)
            c["ok"] = c["ok"] and launches == 1
            cases.append({"model": name, "dtype": dtype,
                          "shape": list(shape), "launches": launches, **c})
            del q, k, v, out, ref
        B, Hq, Hkv, S, d, live = shape
        split, per = split_plan(B, Hkv, S, sms)
        sets = inputs(shape, "bfloat16",
                      cold_sets(2 * B * S * Hkv * d * 2))
        kern = rotation([functools.partial(dense_decode_attention, *x)
                         for x in sets])
        plain = rotation([functools.partial(dense_decode_attention_ref, *x)
                          for x in sets])
        t = {"split": split, "per": per, "cold_sets": len(sets),
             "kernel_ms": cuda_ms(kern),
             "kernel_device": device_ms_per_call(
                 kern, kernels_per_call=1 if split == 1 else 2),
             "plain_ms": cuda_ms(plain, iters=5, warmup=1)}
        b = decode_attention_bound(B, Hq, Hkv, d, live, 2)
        dev_ms = t["kernel_device"]["ms"]
        t.update(bound_us=b["bound_us"], bound_by=b["bound_by"],
                 bytes=b["bytes"],
                 gb_per_s=b["bytes"] / (dev_ms or t["kernel_ms"]) / 1e6,
                 bound_share=b["bound_us"] / 1e3 / t["kernel_ms"],
                 bound_share_device=ratio(b["bound_us"] / 1e3, dev_ms),
                 plain_over_kernel=t["plain_ms"] / t["kernel_ms"])
        timing[name] = t
        del sets, kern, plain
        torch.cuda.empty_cache()
    out = {"phase": "decode_kernel", "kernel": "decode_attention",
           "cases": cases, "timing_bf16": timing}
    emit(out)
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"decode_attention disagrees with its plain "
                             f"version: {bad}")
    return out


# K9 / K10 at the HBM cells' shapes: (B, S, d, Hq, Hkv, head dim) of a
# prefill (64 prompts of 512 tokens) and of a decode step (64 tokens, at
# position 530)
NORM_ROPE_SHAPES = {"yi-9b_prefill": (64, 512, 4096, 32, 4, 128),
                    "yi-9b_decode": (64, 1, 4096, 32, 4, 128),
                    "mixtral-8x22b_prefill": (64, 512, 6144, 48, 8, 128),
                    "mixtral-8x22b_decode": (64, 1, 6144, 48, 8, 128)}


def phase_norm_rope_kernel() -> dict:
    """K9 (the norm alone and with its residual add) and K10 (rope on q
    and k) against their plain versions at the HBM cells' prefill and
    decode shapes in bf16, one launch a call; each one's device time with
    its inputs cold (a rotation of distinct inputs, twice the L2 together)
    beside the plain version's and its byte bound."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import norm_rope
    from repro_torch.models.layers import _rope_freqs
    gen = torch.Generator(device="cuda").manual_seed(9)

    def randn(*dims):
        return torch.randn(*dims, generator=gen, device="cuda").bfloat16()

    cases, timing = [], {}
    for name, (B, S, d, Hq, Hkv, D) in NORM_ROPE_SHAPES.items():
        T = B * S
        freqs = _rope_freqs(D // 2, 1e4, torch.device("cuda"))
        pos = (torch.arange(S, device="cuda")[None].expand(B, S) if S > 1
               else torch.tensor([530], device="cuda").expand(B, 1))

        def norm_set():
            return randn(T, d), randn(T, d), randn(d)

        def rope_set():
            return randn(B, S, Hq, D), randn(B, S, Hkv, D)
        calls = {
            "rmsnorm": (norm_set, lambda x, a, w: norm_rope.rmsnorm(x, w),
                        lambda x, a, w: norm_rope.rmsnorm_ref(x, w, 1e-6),
                        2 * T * d * 2),
            "add_rmsnorm": (norm_set,
                            lambda x, a, w: norm_rope.add_rmsnorm(x, a, w),
                            lambda x, a, w: norm_rope.add_rmsnorm_ref(
                                x, a, w, 1e-6), 4 * T * d * 2),
            "rope": (rope_set,
                     lambda q, k: norm_rope.rope(q, k, pos, freqs, []),
                     lambda q, k: norm_rope.rope_ref(q, k, pos, freqs, []),
                     2 * T * (Hq + Hkv) * D * 2)}
        for kname, (make, kern, plain, nbytes) in calls.items():
            args = make()
            before = kernels.LAUNCHES[kname]
            got = kern(*args)
            launches = kernels.LAUNCHES[kname] - before
            want = plain(*args)
            torch.cuda.synchronize()
            got = got if isinstance(got, (tuple, list)) else [got]
            want = want if isinstance(want, (tuple, list)) else [want]
            equal = all(torch.equal(g, w) for g, w in zip(got, want))
            diff = max(((g.float() - w.float()).abs()
                        / w.float().abs().clamp_min(1e-30)).max().item()
                        for g, w in zip(got, want))
            ok = launches == 1 and (equal or (kname != "rope"
                                              and diff <= 2 ** -7))
            cases.append({"shape": name, "kernel": kname, "bit_equal": equal,
                          "max_rel_diff": diff, "launches": launches,
                          "ok": ok})
            del got, want
            sets = [args] + [make() for _ in range(cold_sets(nbytes) - 1)]
            k_rot = rotation([functools.partial(kern, *a) for a in sets])
            p_rot = rotation([functools.partial(plain, *a) for a in sets])
            dev = device_ms_per_call(k_rot)["ms"]
            plain_dev = device_ms_per_call(p_rot, iters=6, warmup=1,
                                           kernels_per_call=None)["ms"]
            b = bound(nbytes)
            timing[f"{name}/{kname}"] = {
                "cold_sets": len(sets), "kernel_device_ms": dev,
                "kernel_ms": cuda_ms(k_rot), "plain_device_ms": plain_dev,
                "bound_us": b["bound_us"], "bytes": b["bytes"],
                "bound_share_device": ratio(b["bound_us"] / 1e3, dev),
                "plain_over_kernel": ratio(plain_dev, dev)}
            del sets, k_rot, p_rot, args
            torch.cuda.empty_cache()
    out = {"phase": "norm_rope_kernel", "cases": cases,
           "timing_bf16": timing}
    emit(out)
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"norm_rope disagrees with its plain "
                             f"versions: {bad}")
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
    from repro_torch.obs import Tracer

    cfg = get_config("yi-9b")                       # full width
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # cuda, attention kernel; traced, so that every decode step's wall
    # feeds the engine's straggler stats
    engine = ServeEngine(cfg, tracer=Tracer())
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
    batch = _left_pad_batch(reqs, "cuda")
    plen = batch["tokens"].shape[1]
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
    # the mesh phase's weights (views, no second copy) and reference logits
    out["params"], out["prefill_logits"] = params, logits_k
    if not pre_flash:           # None: the profiler recorded nothing
        raise AssertionError(f"no device time under a kernel named "
                             f"{K1_KERNEL!r} in the profiled prefill: "
                             f"{sorted(pre_kernels)}")
    if rel_l2 > LOGITS_REL_L2:
        raise AssertionError(f"kernel-path logits differ from the eager "
                             f"path's: relative L2 {rel_l2} > "
                             f"{LOGITS_REL_L2}")
    return out


def _left_pad_batch(reqs, device) -> dict:
    """The engine's left-padded prompt batch."""
    import numpy as np
    import torch
    plen = max(len(r.prompt) for r in reqs)
    toks = np.zeros((len(reqs), plen), np.int64)
    for i, r in enumerate(reqs):
        toks[i, plen - len(r.prompt):] = r.prompt
    return {"tokens": torch.from_numpy(toks).to(device)}


def _whole(t):
    """A DTensor's whole value (a plain tensor as it is)."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def greedy_run(model, params, batch: dict, gen: int) -> dict:
    """The engine's greedy loop on ``model``: prefill with room for ``gen``
    tokens, then ``gen`` decode steps; wall times, tokens, first logits."""
    import torch
    plen = batch["tokens"].shape[1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch, plen + gen)
    first = _whole(logits)
    tok = torch.argmax(first, dim=-1)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    outs, steps = [], []
    for s in range(gen):
        ts = time.perf_counter()
        logits, cache = model.decode(params, cache, tok, plen + s)
        tok = torch.argmax(_whole(logits), dim=-1)
        outs.append(tok.cpu().numpy()[:, 0])
        steps.append(time.perf_counter() - ts)
    steps.sort()
    return {"prefill_ms": prefill_ms, "logits": first, "tokens": outs,
            "decode_ms_per_tok": sum(steps) * 1e3 / gen,
            "decode_step_median_ms": steps[len(steps) // 2] * 1e3}


@contextlib.contextmanager
def mesh_arithmetic():
    """The plain path's steps with the arithmetic the mesh path keeps, for
    a reference run: the plain decode attention in place of K8, and the
    plain norm and rope chains in place of K9 and K10."""
    from repro_torch.kernels import norm_rope
    from repro_torch.kernels.decode_attention import (
        dense_decode_attention_ref)
    from repro_torch.models import attention
    kernel = attention.dense_decode_attention
    fused = {n: getattr(norm_rope, n) for n in ("rmsnorm", "add_rmsnorm",
                                                  "rope")}
    attention.dense_decode_attention = (
        lambda q, k, v, pos=None: dense_decode_attention_ref(q, k, v, pos))
    norm_rope.rmsnorm = norm_rope.rmsnorm_ref
    norm_rope.add_rmsnorm = norm_rope.add_rmsnorm_ref

    def rope(q, k, positions, freqs, sections):
        out = norm_rope.rope_ref(q, k, positions, freqs, sections)
        return out[0], (out[1] if k is not None else None)
    norm_rope.rope = rope
    try:
        yield
    finally:
        attention.dense_decode_attention = kernel
        for n, f in fused.items():
            setattr(norm_rope, n, f)


def phase_mesh(serve=None) -> dict:
    import numpy as np
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch import kernels
    from repro_torch.config.base import ParallelConfig, get_config
    from repro_torch.launch.mesh import local_process_group, make_host_mesh
    from repro_torch.launch.serve import ServeEngine, make_requests
    from repro_torch.models.model import Model
    from repro_torch.models.params import tree_flatten

    cfg = get_config("yi-9b")                       # full width
    reqs = make_requests(cfg, N_REQUESTS, PROMPT, GEN)
    batch = _left_pad_batch(reqs, "cuda")
    if serve is None:               # alone: the serve phase's engine again
        engine = ServeEngine(cfg)
        ref_tokens = np.array([r.tokens for r in engine.serve(reqs)])
        params = engine.model.params
        with torch.inference_mode():
            ref_logits, _ = engine.model.prefill(
                params, batch, batch["tokens"].shape[1] + 1)
        del engine
    else:
        params, ref_tokens = serve["params"], serve["tokens"]
        ref_logits = serve["prefill_logits"]
    parallel = ParallelConfig(attention_kernel="kernel")
    plain = Model.create(cfg, parallel)
    with local_process_group("cuda"):
        mesh = make_host_mesh()
        model = Model.create(cfg, parallel, mesh=mesh)
        model.set_params(params)
        placed = dict(tree_flatten(model.params))
        for path, leaf in tree_flatten(params):
            d = placed[path]
            if not (isinstance(d, DTensor) and d.device_mesh is mesh
                    and d.to_local().data_ptr() == leaf.data_ptr()):
                raise AssertionError(f"weight {path} is not a DTensor view "
                                     f"of the serve phase's leaf")
        mparams = model.params
        with torch.inference_mode():
            warm = {"tokens": batch["tokens"][:, -64:]}
            greedy_run(plain, params, warm, 2)
            greedy_run(model, mparams, warm, 2)
            plain_run = greedy_run(plain, params, batch, GEN)
            # the mesh path's arithmetic without the mesh: its tokens must
            # match bit for bit (K8's differ by rounding at near-ties)
            with mesh_arithmetic():
                same = np.stack(greedy_run(plain, params, batch,
                                           GEN)["tokens"], axis=1)
            kernels.reset_launches()
            mesh_run = greedy_run(model, mparams, batch, GEN)
            launches = dict(kernels.LAUNCHES)
            n_prof = 4
            times = {}
            for name, m, p in (("plain", plain, params),
                               ("mesh", model, mparams)):
                (_, cache), pre_dev, _ = profile_device(
                    lambda: m.prefill(p, batch, PROMPT + n_prof),
                    attempts=3)

                def steps():
                    tok = torch.zeros((N_REQUESTS, 1), dtype=torch.int64,
                                      device="cuda")
                    for s in range(n_prof):
                        m.decode(p, cache, tok, PROMPT + s)
                _, dec_dev, _ = profile_device(steps, attempts=3)
                times[name] = (pre_dev, ratio(dec_dev, n_prof))
                del cache
            # the dry-run's one-chip cell: one prefill of the batch with no
            # decode room, weights resident
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            logits, cache = model.prefill(mparams, batch)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            del logits, cache
        del model, mparams
    gc.collect()
    torch.cuda.empty_cache()
    toks = np.stack(mesh_run["tokens"], axis=1)
    lm, lr = mesh_run["logits"].float(), ref_logits.float()
    rel_l2 = ((lm - lr).norm() / lr.norm()).item()
    out = {"phase": "mesh", "arch": cfg.name, "layers": cfg.num_layers,
           "mesh": "1x1 (data, model), nccl", "requests": N_REQUESTS,
           "prompt_len": batch["tokens"].shape[1], "gen": GEN,
           "prefill_ms": mesh_run["prefill_ms"],
           "plain_prefill_ms": plain_run["prefill_ms"],
           "decode_ms_per_tok": mesh_run["decode_ms_per_tok"],
           "plain_decode_ms_per_tok": plain_run["decode_ms_per_tok"],
           "decode_step_median_ms": mesh_run["decode_step_median_ms"],
           "plain_decode_step_median_ms":
               plain_run["decode_step_median_ms"],
           "prefill_device_ms": times["mesh"][0],
           "plain_prefill_device_ms": times["plain"][0],
           "decode_device_ms_per_step": times["mesh"][1],
           "plain_decode_device_ms_per_step": times["plain"][1],
           "launches": launches,
           "launches_per_prefill": launches["flash_attention"],
           "logits_rel_l2_vs_serve": rel_l2,
           "tokens_equal_plain_attention": bool((toks == same).all()),
           "tokens_equal_serve": bool((toks == ref_tokens).all()),
           "tokens_differing_from_serve": int((toks != ref_tokens).sum()),
           "weight_leaves_dtensor": len(placed),
           "one_chip_prefill_peak_bytes": peak,
           "one_chip_prefill_base_bytes": base}
    emit(out)
    if launches["flash_attention"] != cfg.num_layers:
        raise AssertionError(f"flash_attention launched "
                             f"{launches['flash_attention']} times in the "
                             f"mesh prefill; expected {cfg.num_layers}")
    if not out["tokens_equal_plain_attention"]:
        raise AssertionError(f"mesh tokens differ from the path without a "
                             f"mesh under the same decode attention: "
                             f"{toks[:, :8]} vs {same[:, :8]}")
    if not (rel_l2 <= LOGITS_REL_L2):
        raise AssertionError(f"mesh prefill logits: relative L2 {rel_l2} "
                             f"from the serve phase's > {LOGITS_REL_L2}")
    return out


def dryrun_param_bytes(arch: str, rec: dict) -> int:
    """Per-chip parameter bytes of a dry-run record's cell, from the specs
    and spec_for alone: each leaf's elements over the product of the mesh
    axes its spec shards it on, in the record's parameter dtype."""
    import numpy as np
    from repro_torch.config.base import ParallelConfig, get_config
    from repro_torch.models.sharding import logical_rules, spec_axes, spec_for
    from repro_torch.models.params import tree_flatten
    from repro_torch.models.transformer import model_specs

    mesh = {"data": 16, "model": 16}
    rules = logical_rules(mesh, ParallelConfig(**rec["parallel"]))
    specs = model_specs(get_config(arch), mesh)
    total = 0
    for _, s in tree_flatten(specs):
        spec = spec_for(s.axes, rules, s.shape, mesh)
        split = int(np.prod([mesh[a] for part in spec
                             for a in spec_axes(part)] or [1]))
        total += int(np.prod(s.shape)) // split * 2      # bf16
    return total


def card_chip_spec() -> "object":
    """A ChipSpec of the card's own rates: the best bf16 torch.matmul rate
    at yi-9b's prefill GEMM shapes (4 x 1024 tokens) and one device copy's
    rate (bytes read and written)."""
    import torch
    from repro_torch.roofline import hw
    M, d, ff, kv = N_REQUESTS * PROMPT, 4096, 11008, 512
    best = 0.0
    gen = torch.Generator(device="cuda").manual_seed(0)
    for K, N in ((d, d), (d, kv), (d, ff), (ff, d)):
        a = torch.randn(M, K, device="cuda", dtype=torch.bfloat16,
                        generator=gen)
        b = torch.randn(K, N, device="cuda", dtype=torch.bfloat16,
                        generator=gen)
        ms = cuda_ms(lambda: torch.matmul(a, b))
        best = max(best, 2 * M * K * N / (ms * 1e-3))
    x = torch.empty(2 ** 28, device="cuda", dtype=torch.bfloat16)
    y = torch.empty_like(x)
    ms = cuda_ms(lambda: y.copy_(x))
    copy = 2 * x.numel() * 2 / (ms * 1e-3)
    del a, b, x, y
    return hw.ChipSpec(name=torch.cuda.get_device_name(0), peak_flops=best,
                       hbm_bandwidth=copy, hbm_capacity=int(
                           torch.cuda.get_device_properties(0).total_memory),
                       ici_bandwidth=copy, ici_links=0, vmem_capacity=0)


_DRYRUN: dict = {}


def start_dryrun() -> None:
    """Start every dry-run cell in its own process, all at once (fake
    tensors: they need the host's cores, not the card). Their output goes
    to files under build/dryrun/."""
    import os
    out_dir = ROOT / "build" / "dryrun"
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    one = ["--arch", "yi-9b", "--shape", "prefill_32k", "--mesh-shape",
           "1x1", "--batch", str(N_REQUESTS), "--seq", str(PROMPT),
           "--attention-kernel", "kernel", "--tag", "one_chip"]
    jobs = [(f"{a}_{s}", ["--arch", a, "--shape", s, *extra, "--tag",
                          "smoke"])
            for a, s, extra in DRYRUN_CELLS] + [("one_chip", one)]
    _DRYRUN["t0"] = time.perf_counter()
    _DRYRUN["jobs"] = jobs
    _DRYRUN["procs"] = {}
    for name, argv in jobs:
        log = open(out_dir / f"{name}.log", "w")
        _DRYRUN["procs"][name] = (subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *argv],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT), log)


def stop_dryrun() -> None:
    """Stop any dry-run process still running."""
    for p, log in _DRYRUN.get("procs", {}).values():
        if p.poll() is None:
            p.kill()
            p.wait()
        log.close()


def phase_dryrun(mesh=None) -> dict:
    from repro_torch.config.base import get_config, get_shape
    from repro_torch.roofline.analysis import Roofline, model_flops_per_step

    start_dryrun()
    out_dir = ROOT / "build" / "dryrun"
    jobs, procs, t0 = _DRYRUN["jobs"], _DRYRUN["procs"], _DRYRUN["t0"]
    waited = time.perf_counter()
    logs, walls = {}, {}
    try:
        for name, (p, log) in procs.items():
            left = DRYRUN_TIMEOUT_S - (time.perf_counter() - t0)
            try:
                p.wait(timeout=max(1.0, left))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"dryrun {name} still running after "
                                     f"{DRYRUN_TIMEOUT_S} s")
            walls[name] = time.perf_counter() - t0
            log.flush()
            logs[name] = (out_dir / f"{name}.log").read_text()
    finally:
        stop_dryrun()
    procs = {name: p for name, (p, _) in procs.items()}
    recs = {}
    for (name, argv) in jobs:
        a, s = argv[1], argv[3]
        label = "1x1" if name == "one_chip" else "16x16"
        tag = argv[-1]
        path = out_dir / f"{a}_{s}_{label}_{tag}.json"
        if procs[name].returncode != 0 or not path.exists():
            raise AssertionError(f"dryrun {name} failed "
                                 f"(rc {procs[name].returncode}):\n"
                                 f"{logs.get(name, '')[-3000:]}")
        recs[name] = json.loads(path.read_text())
    cells = {}
    for name, rec in recs.items():
        if rec["status"] != "ok":
            raise AssertionError(f"dryrun {name}: {rec['status']} "
                                 f"{rec.get('error')}")
        roof = rec["roofline"]
        cells[name] = {"wall_s": walls[name], "trace_s": rec["lower_s"],
                       "flops": roof["flops"], "hbm_bytes": roof["hbm_bytes"],
                       "collective_bytes": roof["collective_bytes"],
                       "collectives": rec["hlo_walk"]["collectives_by_kind"],
                       "bottleneck": roof["bottleneck"],
                       "flops_ratio": roof["flops_ratio"],
                       "peak_bytes": rec["memory_analysis"][
                           "peak_size_in_bytes"],
                       "param_bytes_per_chip": rec["param_bytes_per_chip"],
                       "moe_bodies": rec.get("moe_bodies"),
                       "microbatches": rec["parallel"]["microbatches"]}
        if name == "one_chip":
            continue
        arch = rec["arch"]
        want = dryrun_param_bytes(arch, rec)
        if rec["param_bytes_per_chip"] != want:
            raise AssertionError(f"dryrun {name}: per-chip parameter bytes "
                                 f"{rec['param_bytes_per_chip']} != "
                                 f"{want} from spec_for")
        if not roof["flops"] > 0 or roof["bottleneck"] not in (
                "compute", "memory", "collective"):
            raise AssertionError(f"dryrun {name}: {roof}")
        if rec["shape"] == "train_4k" and not (
                DRYRUN_TRAIN_RATIO[0] <= roof["flops_ratio"]
                <= DRYRUN_TRAIN_RATIO[1]):
            raise AssertionError(f"dryrun {name}: MODEL/walker FLOPs "
                                 f"{roof['flops_ratio']}")
    for name, body in (("mixtral-8x22b_prefill_32k", "tp"),
                       ("deepseek-v3-671b_decode_32k", "ep")):
        if not (recs[name].get("moe_bodies") or {}).get(body):
            raise AssertionError(f"{name} did not reach the MoE {body} body")
    # the one-chip prediction against the card
    rec = recs["one_chip"]
    out = {"phase": "dryrun", "mesh": "16x16 (fake, 256 ranks)",
           "cells": cells, "wall_s": time.perf_counter() - t0,
           "waited_s": time.perf_counter() - waited}
    if mesh is not None:
        chip = card_chip_spec()
        cfg, shape = get_config("yi-9b"), get_shape("prefill_32k")
        shape = dataclasses.replace(shape, global_batch=N_REQUESTS,
                                    seq_len=PROMPT)
        walk = rec["hlo_walk"]
        roof = Roofline.build(
            arch="yi-9b", shape="prefill 4x1024", mesh="1x1",
            flops=walk["flops"], hbm_bytes=walk["bytes"],
            collective_bytes=walk["collective_bytes"],
            model_flops=model_flops_per_step(cfg, shape, 1, False),
            chip=chip)
        measured_s = ratio(mesh["prefill_device_ms"], 1e3)
        pred, meas = (rec["memory_analysis"]["peak_size_in_bytes"],
                      mesh["one_chip_prefill_peak_bytes"])
        out["one_chip"] = {
            "predicted_peak_bytes": pred, "measured_peak_bytes": meas,
            "peak_ratio": pred / meas,
            "card_peak_bf16_flops": chip.peak_flops,
            "card_copy_bytes_per_s": chip.hbm_bandwidth,
            "t_compute_s": roof.t_compute, "t_memory_s": roof.t_memory,
            "t_collective_s": roof.t_collective,
            "roofline_step_s": roof.step_time,
            "measured_device_s": measured_s,
            "roofline_fraction": ratio(roof.step_time, measured_s),
            "model_flops_fraction": ratio(
                roof.model_flops / chip.peak_flops, measured_s),
            "bottleneck": roof.bottleneck}
    emit(out)
    if mesh is not None and abs(out["one_chip"]["peak_ratio"] - 1) > \
            DRYRUN_PEAK_TOL:
        raise AssertionError(f"one-chip predicted peak {pred} vs measured "
                             f"{meas}: outside {DRYRUN_PEAK_TOL}")
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
    steps = sorted(engine.straggler.times[-GEN:])     # the traced run's
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


def _left_padded(reqs, device):
    """The requests' prompts left-padded with token 0 into one batch, as
    ServeEngine.prefill builds it."""
    import numpy as np
    import torch
    plen = max(len(r.prompt) for r in reqs)
    toks = np.zeros((len(reqs), plen), np.int64)
    for i, r in enumerate(reqs):
        toks[i, plen - len(r.prompt):] = r.prompt
    return torch.from_numpy(toks).to(device)


def _rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


def _leaf_draw(params) -> dict:
    """The largest leaf's first and last 2**20 elements against the scale
    it was drawn at: a draw of several G elements that went wrong past some
    index (zeros, a repeat of the start) shows here."""
    import numpy as np
    import torch
    from repro_torch.models.params import tree_flatten
    path, leaf = max(tree_flatten(params), key=lambda pl: pl[1].numel())
    n = min(2 ** 20, leaf.numel() // 2)
    flat = leaf.view(-1)
    first, last = flat[:n].float(), flat[-n:].float()
    want = 1.0 / np.sqrt(int(np.prod(leaf.shape[:-1])))   # ParamSpec's scale
    out = {"leaf": "/".join(path), "shape": list(leaf.shape),
           "elements": leaf.numel(), "scale": want,
           "std_first": first.std().item(), "std_last": last.std().item(),
           "equal": bool(torch.equal(first, last))}
    out["ok"] = (not out["equal"] and all(
        abs(out[k] / want - 1) < 0.05 for k in ("std_first", "std_last")))
    return out


def decode_vs_forward(cfg, params, batch, steps: int, fp32_steps: int) -> dict:
    """On ``params``, in bf16 activations: the prefill of ``batch`` through
    the kernel path (K1 where the model reaches it) against the eager
    path's, then ``steps`` greedy decode steps, each against an eager full
    forward over the prompt and every token fed so far; the first
    ``fp32_steps`` of them also against the same forward in fp32
    activations, beside the bf16 forward's own gap to it; then the bf16
    forward's noise floor (each request alone against the batch: other GEMM
    shapes, so other sums). Relative L2s of the last position's logits."""
    import torch
    from repro_torch.config.base import ParallelConfig
    from repro_torch.models import moe
    from repro_torch.models.layers import unembed
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import forward_hidden
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    kern = Model.create(cfg, ParallelConfig(attention_kernel="kernel"))
    eager = {}
    for dtype in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, dtype=dtype)
        eager[dtype] = c, Model.create(
            c, ParallelConfig(attention_kernel="eager")).serve_mctx
    plen = batch.shape[1]

    def eager_last(tokens, dtype="bfloat16"):
        c, mctx = eager[dtype]
        x, _, _ = forward_hidden(params, c, mctx, {"tokens": tokens})
        return unembed(params["embed"], x[:, -1:], c.tie_embeddings)
    t0 = time.perf_counter()
    with torch.inference_mode():
        kern.mctx.stats = {}
        logits_k, cache = kern.prefill(params, {"tokens": batch},
                                       plen + steps)
        dropped = (moe.read_counts(kern.mctx.stats) or {}).get(
            "dropped_pairs", 0)
        logits_e = eager_last(batch)
        finite = bool(torch.isfinite(logits_k).all()
                      and torch.isfinite(logits_e).all())
        decode_rel, gap_decode, gap_forward = [], [], []
        seq, tok = batch, logits_k.argmax(-1)
        for s in range(steps):
            logits_d, cache = kern.decode(params, cache, tok, plen + s)
            seq = torch.cat([seq, tok], 1)
            forward = eager_last(seq)
            finite &= bool(torch.isfinite(logits_d).all())
            decode_rel.append(_rel_l2(logits_d, forward))
            if s < fp32_steps:
                exact = eager_last(seq, "float32")
                gap_decode.append(_rel_l2(logits_d, exact))
                gap_forward.append(_rel_l2(forward, exact))
            tok = logits_d.argmax(-1)
        del cache
        alone = torch.cat([eager_last(seq[i:i + 1])
                           for i in range(seq.shape[0])])
        floor = _rel_l2(alone, eager_last(seq))
    gap_ratio = [d / f for d, f in zip(gap_decode, gap_forward)]
    return {"prefill_rel_l2_kernel_vs_eager": _rel_l2(logits_k, logits_e),
            "moe_dropped_in_prefill": dropped, "decode_steps": steps,
            "decode_rel_l2": decode_rel,
            "decode_rel_l2_max": max(decode_rel, default=None),
            "decode_gap_to_fp32": gap_decode,
            "forward_gap_to_fp32": gap_forward, "gap_ratio": gap_ratio,
            "gap_ratio_max": max(gap_ratio, default=None),
            "forward_rel_l2_alone_vs_batch": floor, "finite": finite,
            "seconds": time.perf_counter() - t0}


def grid_positions(B: int, S: int, device) -> "torch.Tensor":
    """MROPE_GRID's (3, B, S) M-RoPE positions: text, an image grid (t
    fixed, h the row, w the column, offset by the text before it), then
    text again from the grid's largest position + 1."""
    import torch
    text, side = MROPE_GRID["text"], MROPE_GRID["side"]
    end = text + side * side
    pos = torch.zeros(3, S, dtype=torch.long)
    pos[:, :text] = torch.arange(text)
    g = torch.arange(side * side)
    pos[0, text:end] = text
    pos[1, text:end] = text + g // side
    pos[2, text:end] = text + g % side
    pos[:, end:] = text + side + torch.arange(S - end)
    return pos[:, None].expand(3, B, S).to(device)


def mrope_plain(x, pos, theta: float):
    """The reference's M-RoPE formula (``repro/models/layers.py:45-70``) in
    numpy float64: x (B, S, H, d), pos (3, B, S); each of the three
    sections of the d / 2 frequencies (16 : 24 : 24, rescaled in integer
    arithmetic) turns with its own row of positions."""
    import numpy as np
    half = x.shape[-1] // 2
    secs = [s * half // 64 for s in (16, 24, 24)]
    secs[-1] = half - sum(secs[:-1])
    freqs = 1.0 / theta ** (np.arange(half) / half)
    ang = pos[np.repeat(np.arange(3), secs)].transpose(1, 2, 0) * freqs
    cos, sin = np.cos(ang)[..., None, :], np.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return np.concatenate([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def mrope_grid_check(cfg, params, batch) -> dict:
    """qwen2-vl's M-RoPE with distinct (t, h, w) rows (equal rows are
    plain RoPE): ``apply_rope`` on the card at the model's head dim over
    MROPE_GRID's positions against ``mrope_plain`` (the section split;
    plain RoPE's positions must turn it far from there); ``Model.prefill``
    of the vision stub's batch (``embeds`` the prompt's token embeddings,
    the grid's positions) through K1 against the eager path's, then greedy
    decode steps each against the eager forward over the same embeddings
    and positions. How far plain RoPE's positions move the eager prefill's
    logits is printed, not held: with random weights attention averages
    over many keys, so positions barely move the logits."""
    import torch
    from repro_torch import kernels
    from repro_torch.config.base import ParallelConfig
    from repro_torch.models.layers import apply_rope, embed_tokens, unembed
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import forward_hidden
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    kern = Model.create(cfg, ParallelConfig(attention_kernel="kernel"))
    eager = Model.create(cfg, ParallelConfig(attention_kernel="eager")).mctx
    B, plen = batch.shape
    steps = MROPE_GRID["steps"]

    def embed(tokens):
        return embed_tokens(params["embed"], tokens, torch.bfloat16)

    def eager_last(emb, pos):
        x, _, _ = forward_hidden(params, cfg, eager,
                                 {"embeds": emb, "positions": pos})
        return unembed(params["embed"], x[:, -1:], cfg.tie_embeddings)
    with torch.inference_mode():
        emb, pos = embed(batch), grid_positions(B, plen, batch.device)
        arange = torch.arange(plen, device=batch.device)[None, None] \
            .expand(3, B, plen)
        gen = torch.Generator(device=batch.device).manual_seed(5)
        x = torch.randn(B, plen, 8, cfg.resolved_head_dim, generator=gen,
                        device=batch.device).to(torch.bfloat16)
        turned = apply_rope(x, pos, cfg.rope_theta, mrope=True)
        want = torch.from_numpy(mrope_plain(
            x.double().cpu().numpy(), pos.cpu().numpy(), cfg.rope_theta))
        split_rel = _rel_l2(turned.cpu(), want)
        rope_rel = _rel_l2(apply_rope(x, arange, cfg.rope_theta,
                                      mrope=True).cpu(), want)
        before = kernels.LAUNCHES["flash_attention"]
        logits_k, cache = kern.prefill(
            params, {"embeds": emb, "positions": pos}, plen + steps)
        launches = kernels.LAUNCHES["flash_attention"] - before
        logits_e = eager_last(emb, pos)
        rope = eager_last(emb, arange)
        finite = bool(torch.isfinite(logits_k).all())
        decode_rel, tok = [], logits_k.argmax(-1)
        for s in range(steps):
            logits_d, cache = kern.decode(params, cache, tok, plen + s)
            emb = torch.cat([emb, embed(tok)], 1)
            pos = torch.cat([pos, torch.full((3, B, 1), plen + s,
                                             device=pos.device)], 2)
            decode_rel.append(_rel_l2(logits_d, eager_last(emb, pos)))
            finite &= bool(torch.isfinite(logits_d).all())
            tok = logits_d.argmax(-1)
        del cache
    out = {"grid": dict(MROPE_GRID), "k1_launches": launches,
           "rope_rel_l2_vs_plain": split_rel,
           "rope_positions_rel_l2_vs_plain": rope_rel,
           "prefill_rel_l2_kernel_vs_eager": _rel_l2(logits_k, logits_e),
           "logits_rel_l2_grid_vs_rope_positions": _rel_l2(logits_e, rope),
           "decode_rel_l2": decode_rel, "finite": finite}
    bad = []
    if launches != cfg.num_layers:
        bad.append(f"the grid prefill launched K1 {launches} times, not "
                   f"{cfg.num_layers}")
    if out["prefill_rel_l2_kernel_vs_eager"] > LOGITS_REL_L2:
        bad.append(f"grid prefill: kernel path vs eager relative L2 "
                   f"{out['prefill_rel_l2_kernel_vs_eager']}")
    if max(decode_rel) > LOGITS_REL_L2:
        bad.append(f"grid decode vs forward relative L2 {decode_rel}")
    if split_rel > BF16_REL_L2:
        bad.append(f"M-RoPE on the card differs from the reference's "
                   f"formula: relative L2 {split_rel}")
    if rope_rel <= 10 * BF16_REL_L2:
        bad.append(f"plain RoPE's positions turn q within {rope_rel} of "
                   f"the grid's: the grid is not seen")
    if not finite:
        bad.append("non-finite logits in the grid batch")
    out["failures"] = bad
    return out


def mla_dense_check(cfg, params, batch) -> dict:
    """deepseek-v3's absorbed MLA decode against its prefill path on the
    same weights, the dense layers alone (the MoE segment left empty):
    ``decode_vs_forward`` over MLA_DENSE_STEPS greedy steps."""
    from repro_torch.models.params import tree_map
    fd = cfg.moe.first_dense_layers
    dense = dataclasses.replace(cfg, num_layers=fd)
    params = {**params, "moe": tree_map(lambda t: t[:0], params["moe"])}
    check = decode_vs_forward(dense, params, batch, MLA_DENSE_STEPS, 0)
    bad = []
    if check["prefill_rel_l2_kernel_vs_eager"] > LOGITS_REL_L2:
        bad.append(f"MLA prefill paths differ: "
                   f"{check['prefill_rel_l2_kernel_vs_eager']}")
    if check["decode_rel_l2_max"] > LOGITS_REL_L2:
        bad.append(f"MLA decode vs forward relative L2 "
                   f"{check['decode_rel_l2']}")
    if not check["finite"]:
        bad.append("non-finite logits in the dense MLA check")
    return {"layers": fd, **check, "failures": bad}


def _decoder_generate(model, params, batch: dict, steps: int) -> dict:
    """greedy_run's walls and tokens, and the prefill's logits to hold."""
    import numpy as np
    r = greedy_run(model, params, batch, steps)
    return {"prefill_ms": r["prefill_ms"],
            "decode_ms_per_tok": r["decode_ms_per_tok"],
            "decode_step_median_ms": r["decode_step_median_ms"],
            "tokens": np.stack(r["tokens"], axis=1),
            "held": {"prefill_logits": r["logits"]}}


def _decoder_profile(model, params, batch: dict, n: int) -> tuple:
    """Device ms of one prefill (room for ``n`` steps) and per decode step
    over ``n`` steps."""
    import torch
    B, plen = batch["tokens"].shape
    (_, cache), pre_dev, _ = profile_device(
        lambda: model.prefill(params, batch, plen + n), attempts=3,
        cpu=False)
    tok = torch.zeros((B, 1), dtype=torch.int64, device="cuda")

    def steps():
        for s in range(n):
            model.decode(params, cache, tok, plen + s)
    _, dec_dev, _ = profile_device(steps, attempts=3, cpu=False)
    return pre_dev, ratio(dec_dev, n)


def _whisper_mesh_generate(model, params, frames, steps: int) -> dict:
    r = whisper_generate(model, params, frames, steps)
    return {"prefill_ms": r["prefill_ms"],
            "decode_ms_per_tok": r["decode_ms_per_tok"],
            "tokens": r["tokens"][:, 1:].cpu().numpy(),
            "held": {"encoder": r["enc"], "first_logits": r["logits"][0]}}


def _whisper_profile(model, params, frames, n: int) -> tuple:
    import torch
    (_, cache), pre_dev, _ = profile_device(
        lambda: model.prefill(params, {"frames": frames}, max_len=n),
        attempts=3, cpu=False)
    tok = torch.full((frames.shape[0], 1), WHISPER["start_token"],
                     device=frames.device)

    def steps():
        for s in range(n):
            model.decode(params, cache, tok, s)
    _, dec_dev, _ = profile_device(steps, attempts=3, cpu=False)
    return pre_dev, ratio(dec_dev, n)


def k1_local_heads(model, params, frames) -> dict:
    """K1 at whisper's encoder shape on the local heads the mesh path's
    attention body receives: the first encoder layer's q, k and v of the
    frames as DTensors projected on the mesh (heads as the compute layout
    splits them), then K1 on their local tensors, as the body calls it,
    against flash_attention_ref on the same tensors."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    from repro_torch.models import tp
    from repro_torch.models.layers import sinusoidal_pos_emb
    from repro_torch.models.transformer import layer_views
    cfg, mctx = model.cfg, model.mctx
    S = frames.shape[1]
    x = frames + sinusoidal_pos_emb(torch.arange(S, device=frames.device),
                                    cfg.d_model).to(frames.dtype)
    x = tp.inputs(mctx, x, ("act_batch", None, None))
    lp = layer_views(params["encoder"], cfg.num_encoder_layers)[0]
    h = tp.rms_norm(mctx, x, lp["ln1"], cfg.norm_eps)
    q, k, v = (tp._proj(mctx, h, lp["attn"][w], (
        "embed", "heads" if w == "w_q" else "kv_heads", None)).to_local()
        .transpose(1, 2) for w in ("w_q", "w_k", "w_v"))
    out = flash_attention(q, k, v, causal=False)
    ref = flash_attention_ref(q, k, v, causal=False)
    rel = _rel_l2(out, ref)
    return {"shape": [*q.shape], "causal": False, "rel_l2": rel,
            "max_abs_err": (out.float() - ref.float()).abs().max().item(),
            "ok": rel <= BF16_REL_L2}


def mesh_rerun(cfg, params, prompt, warm, generate, profile,
               k1: int, hold=None) -> dict:
    """``params`` (the plain run's weights) again through the mesh path on
    a one-rank NCCL mesh, as views: ``generate`` MESH_STEPS greedy steps on
    the plain path and on the mesh (after a warm-up of both on ``warm``),
    the mesh run's K1 launches counted, both paths' device times over one
    profiled prefill and MESH_PROFILED decode steps, then ``hold`` on the
    mesh model where given. Checks: every leaf a DTensor over the plain
    leaf's storage, a second plain run equal to the first bit for bit
    (else the mesh's equality below would hold by chance), tokens equal
    (both paths with the plain norm, rope and decode attention,
    ``mesh_arithmetic``: the mesh's MLA borrows the plain path's
    functions),
    the held tensors within LOGITS_REL_L2, exactly ``k1`` K1 launches.
    The mesh bodies keep the capacity MoE layer, so the plain path here
    serves with it too (``serve_mctx`` is the model's own context), not
    with the dropless layer of plain serving."""
    import numpy as np
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch import kernels
    from repro_torch.config.base import ParallelConfig
    from repro_torch.launch.mesh import local_process_group, make_host_mesh
    from repro_torch.models.model import Model
    from repro_torch.models.params import tree_flatten

    class CapacityModel(Model):
        @property
        def serve_mctx(self):
            return self.mctx
    t0 = time.perf_counter()
    parallel = ParallelConfig(attention_kernel="kernel")
    plain = CapacityModel.create(cfg, parallel)
    with local_process_group("cuda"):
        model = Model.create(cfg, parallel, mesh=make_host_mesh())
        model.set_params(params)
        placed = dict(tree_flatten(model.params))
        views = all(isinstance(placed[path], DTensor)
                    and placed[path].to_local().data_ptr() == leaf.data_ptr()
                    for path, leaf in tree_flatten(params))
        mparams = model.params
        stage = [time.perf_counter()]
        with torch.inference_mode():
            with mesh_arithmetic():
                generate(plain, params, warm, 2)
                generate(model, mparams, warm, 2)
                stage.append(time.perf_counter())
                plain_run = generate(plain, params, prompt, MESH_STEPS)
                again = generate(plain, params, prompt, MESH_STEPS)
                kernels.reset_launches()
                mesh_run = generate(model, mparams, prompt, MESH_STEPS)
                launches = dict(kernels.LAUNCHES)
            stage.append(time.perf_counter())
            times = {name: profile(m, p, prompt, MESH_PROFILED)
                     for name, m, p in (("plain", plain, params),
                                        ("mesh", model, mparams))}
            stage.append(time.perf_counter())
            held = hold(model, mparams) if hold else None
        del model, mparams
    gc.collect()
    torch.cuda.empty_cache()
    rel = {k: _rel_l2(mesh_run["held"][k], v)
           for k, v in plain_run["held"].items()}
    equal = bool(np.array_equal(mesh_run["tokens"], plain_run["tokens"]))
    repeat = (bool(np.array_equal(again["tokens"], plain_run["tokens"]))
              and all(torch.equal(again["held"][k], v)
                      for k, v in plain_run["held"].items()))
    out = {"mesh": "1x1 (data, model), nccl", "steps": MESH_STEPS,
           "weight_leaves_dtensor_views": views,
           "prefill_ms": mesh_run["prefill_ms"],
           "plain_prefill_ms": plain_run["prefill_ms"],
           "decode_ms_per_tok": mesh_run["decode_ms_per_tok"],
           "plain_decode_ms_per_tok": plain_run["decode_ms_per_tok"],
           "prefill_device_ms": times["mesh"][0],
           "plain_prefill_device_ms": times["plain"][0],
           "decode_device_ms_per_step": times["mesh"][1],
           "plain_decode_device_ms_per_step": times["plain"][1],
           "launches": launches, "k1_launches_expected": k1,
           "rel_l2_vs_plain": rel, "tokens_equal_plain": equal,
           "plain_repeat_bit_equal": repeat,
           "sample": mesh_run["tokens"][0, :8].tolist(),
           "k1_local_heads": held, "seconds": time.perf_counter() - t0,
           "stage_seconds": dict(zip(("warm", "generate", "profile"),
                                     np.diff(stage).tolist()))}
    bad = []
    if not views:
        bad.append("a mesh weight leaf is not a DTensor view of the plain "
                   "run's")
    if not repeat:
        bad.append("a second plain run differs from the first")
    if not equal:
        bad.append(f"mesh tokens {mesh_run['tokens'][:, :8]} differ from "
                   f"the plain path's {plain_run['tokens'][:, :8]}")
    bad += [f"mesh {k} relative L2 {v} from the plain path's > "
            f"{LOGITS_REL_L2}" for k, v in rel.items()
            if not v <= LOGITS_REL_L2]
    if launches["flash_attention"] != k1:
        bad.append(f"K1 launched {launches['flash_attention']} times in the "
                   f"mesh run's prefill; expected {k1}")
    if held is not None and not held["ok"]:
        bad.append(f"K1 on the mesh path's local heads disagrees with its "
                   f"plain version: {held}")
    out["failures"] = bad
    return out


# checks a model of the zoo runs on the engine's weights after the common
# ones
EXTRA_CHECKS = {"qwen2-vl-72b": mrope_grid_check,
                "deepseek-v3-671b": mla_dense_check}


def serve_model(arch: str, layers, prompt: int, gen: int, held: int,
                fp32_steps: int, k1: tuple) -> dict:
    """One architecture of the zoo through ServeEngine on the card (K1 on
    the prefill path), then its checks; frees the engine before it
    returns."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.config.base import get_config
    from repro_torch.launch.serve import Request, ServeEngine, make_requests
    from repro_torch.models.transformer import segment_plan

    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = ServeEngine(cfg)                       # cuda, attention kernel
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = engine.model.params
    weight_gb = sum(p.numel() * p.element_size()
                    for p in engine.model.parameters()) / 1e9
    draw = _leaf_draw(params)
    reqs = make_requests(cfg, N_REQUESTS, prompt, gen)
    engine.serve([Request(99, reqs[0].prompt[:64], 2)])     # warm-up

    kernels.reset_launches()
    results = engine.serve(reqs)
    launches = dict(kernels.LAUNCHES)
    counted = (launches["flash_attention"],
               launches["flash_attention_windowed"])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    toks = np.array([r.tokens for r in results])
    tokens_ok = (toks.shape == (N_REQUESTS, gen) and toks.min() >= 0
                 and toks.max() < cfg.vocab_size)

    # the kernel path's prefill against the eager path's, and decode
    # against the eager forward, on the engine's weights
    batch = _left_padded(reqs, engine.device)
    plen = batch.shape[1]
    check = decode_vs_forward(cfg, params, batch, max(held, fp32_steps),
                              fp32_steps)
    prefill_rel = check["prefill_rel_l2_kernel_vs_eager"]
    decode_rel = check["decode_rel_l2"][:held]
    extra = EXTRA_CHECKS.get(arch)
    extra = extra(cfg, params, batch) if extra else None
    mesh = None
    if arch in MESH_ARCHS:
        mesh = mesh_rerun(cfg, params, {"tokens": batch},
                          {"tokens": batch[:, -64:]}, _decoder_generate,
                          _decoder_profile, k1[0])

    # where the time goes: one profiled prefill and 4 decode steps (the
    # device's activity: the kernels' time and names is what is read)
    n_prof = 4
    handoff, pre_dev, pre_kernels = profile_device(
        lambda: engine.prefill(reqs), attempts=3, cpu=False)
    _, dec_dev, _ = profile_device(lambda: engine.decode(
        dataclasses.replace(handoff, max_new=n_prof)), attempts=3,
        cpu=False)
    del handoff
    dec_dev = ratio(dec_dev, n_prof)
    r0 = results[0]
    plan = segment_plan(cfg)
    out = {"arch": arch, "layers": cfg.num_layers,
           "layers_of": get_config(arch).num_layers,
           "segments": [dataclasses.asdict(s) for s in plan],
           "slstm_layers": sum(s.n for s in plan if s.kind == "xlstm"),
           "weight_gb": weight_gb, "init_s": init_s, "draw": draw,
           "requests": N_REQUESTS, "prompt_len": plen, "gen": gen,
           "prefill_ms": r0.prefill_ms,
           "decode_ms_per_tok": r0.decode_ms_per_tok,
           "tokens_per_s": N_REQUESTS * 1e3 / r0.decode_ms_per_tok,
           "prefill_device_ms": pre_dev,
           "prefill_flash_ms": device_ms(pre_kernels, K1_KERNEL),
           "prefill_idle_share": less(1, ratio(pre_dev, r0.prefill_ms)),
           "decode_device_ms_per_step": dec_dev,
           "decode_idle_share": less(1, ratio(dec_dev, r0.decode_ms_per_tok)),
           "peak_allocated_gb": peak_gb, "launches": launches,
           "launches_per_prefill": counted[0],
           "windowed_launches_per_prefill": counted[1],
           "launches_expected": list(k1),
           "logits_rel_l2_kernel_vs_eager": prefill_rel,
           "decode_held": held, "decode_rel_l2_max": max(decode_rel,
                                                         default=None),
           "decode_gap_ratio_bound": DECODE_GAP_RATIO,
           "check": check, "extra_check": extra, "mesh": mesh,
           "logits_rel_l2_bound": LOGITS_REL_L2,
           "tokens_ok": bool(tokens_ok), "sample": r0.tokens[:8]}
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()

    bad = []
    if not draw["ok"]:
        bad.append(f"the largest leaf's draw looks wrong: {draw}")
    if counted != k1:
        bad.append(f"flash_attention launched {counted[0]} times in one "
                   f"prefill, {counted[1]} of them windowed; expected {k1}")
    if k1[0] and not out["prefill_flash_ms"]:
        bad.append(f"no device time under {K1_KERNEL!r} in the profiled "
                   f"prefill: {sorted(pre_kernels)}")
    if not tokens_ok:
        bad.append(f"generated tokens out of range: {toks}")
    if not check["finite"]:
        bad.append("non-finite logits")
    if prefill_rel > LOGITS_REL_L2:
        bad.append(f"kernel-path prefill logits differ from the eager "
                   f"path's: relative L2 {prefill_rel} > {LOGITS_REL_L2}")
    if decode_rel and max(decode_rel) > LOGITS_REL_L2:
        bad.append(f"decode logits differ from the eager forward's: "
                   f"relative L2 {decode_rel} > {LOGITS_REL_L2}")
    if any(r > DECODE_GAP_RATIO for r in check["gap_ratio"]):
        bad.append(f"decode logits' gap to the fp32 forward "
                   f"{check['decode_gap_to_fp32']} exceeds "
                   f"{DECODE_GAP_RATIO} x the bf16 forward's "
                   f"{check['forward_gap_to_fp32']}")
    if extra:
        bad += extra["failures"]
    if mesh:
        bad += [f"mesh: {f}" for f in mesh["failures"]]
    out["failures"] = bad
    return out


def whisper_frames(cfg, device) -> "torch.Tensor":
    """WHISPER's requests: 30 s of frame embeddings each (WHISPER_CROSS_LEN
    frames), drawn in fp32 from the seed and rounded to bf16."""
    import numpy as np
    import torch
    from repro_torch.models.decode import WHISPER_CROSS_LEN
    rng = np.random.default_rng(WHISPER["seed"])
    frames = rng.standard_normal(
        (WHISPER["requests"], WHISPER_CROSS_LEN, cfg.d_model), np.float32)
    return torch.from_numpy(frames).to(device=device, dtype=torch.bfloat16)


def whisper_generate(model, params, frames, steps: int) -> dict:
    """``Model.prefill({"frames"})`` with a self cache of ``steps``
    positions, then ``steps`` greedy decode steps from the start token:
    the encoder output, the cache, the tokens fed (start token first), each
    step's logits and the synced walls."""
    import torch
    B = frames.shape[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc, cache = model.prefill(params, {"frames": frames}, max_len=steps)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tok = torch.full((B, 1), WHISPER["start_token"], device=frames.device)
    fed, logits = [tok], []
    for s in range(steps):
        out, cache = model.decode(params, cache, tok, s)
        out = _whole(out)
        tok = out.argmax(-1)
        fed.append(tok)
        logits.append(out)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return {"enc": _whole(enc), "cache": cache, "tokens": torch.cat(fed, 1),
            "logits": logits, "prefill_ms": (t1 - t0) * 1e3,
            "decode_ms_per_tok": (t2 - t1) * 1e3 / steps}


def whisper_checks(cfg, params, frames, run: dict) -> dict:
    """On the counted run: the encoder through K1 against the eager
    (chunked) encoder, the cross caches against the encoder output's
    projections (einsum, another GEMM), and each decode step's logits
    against an eager bf16 ``encdec_forward`` over the frames and the
    tokens fed so far. Relative L2s."""
    import torch
    from repro_torch.config.base import ParallelConfig
    from repro_torch.models.layers import unembed
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import encdec_forward, encode
    eager = Model.create(cfg, ParallelConfig(attention_kernel="eager")).mctx
    cross = run["cache"]["decoder"]["cross"]
    xattn = params["decoder"]["xattn"]
    decode_rel = []
    for s, got in enumerate(run["logits"]):
        x, _, _ = encdec_forward(params, cfg, eager, {
            "frames": frames, "tokens": run["tokens"][:, :s + 1]})
        decode_rel.append(_rel_l2(got, unembed(params["embed"], x[:, -1:],
                                               cfg.tie_embeddings)))
    return {
        "encoder_rel_l2_kernel_vs_eager": _rel_l2(
            run["enc"], encode(params, cfg, eager, frames)),
        "cross_shape": {k: list(v.shape) for k, v in cross.items()},
        "cross_rel_l2_max": max(
            _rel_l2(cross[k][i], torch.einsum("bsd,dhk->bshk", run["enc"],
                                              xattn[w][i]))
            for k, w in (("k", "w_k"), ("v", "w_v"))
            for i in range(cfg.num_layers)),
        "decode_rel_l2": decode_rel,
        "decode_rel_l2_max": max(decode_rel),
        "finite": all(bool(torch.isfinite(lg).all())
                      for lg in run["logits"] + [run["enc"]])}


def serve_whisper() -> dict:
    """whisper-small uncut on the card: seeded bf16 weights, WHISPER's
    requests through ``Model.prefill({"frames"})`` (the encoder, through
    K1) and ``Model.decode``; then its checks and one profiled prefill and
    4 decode steps; frees the model before it returns."""
    import torch
    from repro_torch import kernels
    from repro_torch.config.base import ParallelConfig, get_config
    from repro_torch.models.decode import WHISPER_CROSS_LEN
    from repro_torch.models.model import Model

    cfg = get_config("whisper-small")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model.create(cfg, ParallelConfig(attention_kernel="kernel"))
    gen = torch.Generator(device=model.device).manual_seed(WHISPER["seed"])
    params = model.init(gen, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_gb = sum(p.numel() * p.element_size()
                    for p in model.parameters()) / 1e9
    draw = _leaf_draw(params)
    frames = whisper_frames(cfg, model.device)
    steps, B = WHISPER["gen"], WHISPER["requests"]
    n_prof = 4
    with torch.inference_mode():
        whisper_generate(model, params, frames[:1], 2)          # warm-up
        kernels.reset_launches()
        run = whisper_generate(model, params, frames, steps)
        launches = dict(kernels.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check = whisper_checks(cfg, params, frames, run)
        tokens = run["tokens"][:, 1:].cpu()
        prefill_ms, decode_ms = run["prefill_ms"], run["decode_ms_per_tok"]
        del run
        (_, cache), pre_dev, pre_kernels = profile_device(
            lambda: model.prefill(params, {"frames": frames},
                                  max_len=n_prof), attempts=3)
        tok = torch.full((B, 1), WHISPER["start_token"], device=model.device)

        def decode_steps():
            for s in range(n_prof):
                model.decode(params, cache, tok, s)
        _, dec_dev, _ = profile_device(decode_steps)
        del cache
    mesh = mesh_rerun(cfg, params, frames, frames[:1, :256],
                      _whisper_mesh_generate, _whisper_profile,
                      WHISPER["k1"][0], hold=functools.partial(
                          k1_local_heads, frames=frames))
    dec_dev = ratio(dec_dev, n_prof)
    counted = (launches["flash_attention"],
               launches["flash_attention_windowed"])
    out = {"arch": "whisper-small", "layers": cfg.num_layers,
           "encoder_layers": cfg.num_encoder_layers,
           "weight_gb": weight_gb, "init_s": init_s, "draw": draw,
           "requests": B, "frames": WHISPER_CROSS_LEN, "gen": steps,
           "start_token": WHISPER["start_token"],
           "prefill_ms": prefill_ms, "decode_ms_per_tok": decode_ms,
           "tokens_per_s": B * 1e3 / decode_ms,
           "prefill_device_ms": pre_dev,
           "prefill_flash_ms": device_ms(pre_kernels, K1_KERNEL),
           "prefill_idle_share": less(1, ratio(pre_dev, prefill_ms)),
           "decode_device_ms_per_step": dec_dev,
           "decode_idle_share": less(1, ratio(dec_dev, decode_ms)),
           "peak_allocated_gb": peak_gb, "launches": launches,
           "launches_per_prefill": counted[0],
           "windowed_launches_per_prefill": counted[1],
           "launches_expected": list(WHISPER["k1"]), "check": check,
           "mesh": mesh, "logits_rel_l2_bound": LOGITS_REL_L2,
           "sample": tokens[0, :8].tolist()}
    del model, params, frames
    gc.collect()
    torch.cuda.empty_cache()

    want_cross = [cfg.num_layers, B, WHISPER_CROSS_LEN, cfg.num_kv_heads,
                  cfg.resolved_head_dim]
    bad = []
    if not draw["ok"]:
        bad.append(f"the largest leaf's draw looks wrong: {draw}")
    if counted != WHISPER["k1"]:
        bad.append(f"flash_attention launched {counted[0]} times in one "
                   f"prefill, {counted[1]} of them windowed; expected "
                   f"{WHISPER['k1']}")
    if not out["prefill_flash_ms"]:
        bad.append(f"no device time under {K1_KERNEL!r} in the profiled "
                   f"prefill: {sorted(pre_kernels)}")
    if not (tokens.shape == (B, steps) and 0 <= tokens.min()
            and tokens.max() < cfg.vocab_size):
        bad.append(f"generated tokens out of range: {tokens}")
    if not check["finite"]:
        bad.append("non-finite encoder output or logits")
    if check["encoder_rel_l2_kernel_vs_eager"] > LOGITS_REL_L2:
        bad.append(f"the encoder through K1 differs from the eager one: "
                   f"{check['encoder_rel_l2_kernel_vs_eager']}")
    if any(v != want_cross for v in check["cross_shape"].values()):
        bad.append(f"cross caches {check['cross_shape']}, not {want_cross}")
    if check["cross_rel_l2_max"] > BF16_REL_L2:
        bad.append(f"cross caches differ from the encoder output's "
                   f"projections: {check['cross_rel_l2_max']}")
    if check["decode_rel_l2_max"] > LOGITS_REL_L2:
        bad.append(f"decode logits differ from the eager forward's: "
                   f"{check['decode_rel_l2']}")
    bad += [f"mesh: {f}" for f in mesh["failures"]]
    out["failures"] = bad
    return out


# gemma3-27b's two K1 shapes on its prefill path: (B, Hq, Hkv, S, d,
# causal, window), the local layers' window and the global layers'
GEMMA_K1 = {"local": (4, 32, 16, 2048, 128, True, 1024),
            "global": (4, 32, 16, 2048, 128, True, 0)}


def windowed_sdpa(q, k, v, window: int) -> dict:
    """The ways one PyTorch call computes K1's windowed attention: SDPA
    with the window as a boolean mask on the cuDNN, memory-efficient and
    math backends with GQA heads, and the efficient backend on K/V heads
    expanded inside the call. Name -> the call, for those that run."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    S, rep = q.shape[2], q.shape[1] // k.shape[1]
    pos = torch.arange(S, device=q.device)
    mask = (pos[None, :] <= pos[:, None]) & \
        (pos[None, :] > pos[:, None] - window)

    def sdpa(backend, expand):
        def call():
            kk, vv = k, v
            if expand:
                kk, vv = (k.repeat_interleave(rep, 1),
                          v.repeat_interleave(rep, 1))
            with sdpa_kernel([backend]):
                return F.scaled_dot_product_attention(
                    q, kk, vv, attn_mask=mask, enable_gqa=not expand)
        return call
    calls = {"CUDNN_ATTENTION": sdpa(SDPBackend.CUDNN_ATTENTION, False),
             "EFFICIENT_ATTENTION": sdpa(SDPBackend.EFFICIENT_ATTENTION,
                                         False),
             "EFFICIENT_ATTENTION on expanded K/V":
                 sdpa(SDPBackend.EFFICIENT_ATTENTION, True),
             "MATH": sdpa(SDPBackend.MATH, False)}
    runs = {}
    for name, call in calls.items():
        try:
            call()
            torch.cuda.synchronize()
        except RuntimeError as e:
            print(f"chip_smoke: SDPA {name} refuses the windowed call: "
                  f"{str(e).splitlines()[0][:200]}", file=sys.stderr)
            continue
        runs[name] = call
    return runs


def gemma_k1_rows(launches: dict) -> dict:
    """K1 at gemma3-27b's local and global shapes: against its plain
    version, its time (events and device), the plain version's, and the
    bound of the unmasked work; beside it the fastest PyTorch call that
    computes the same attention (the local window: each SDPA form that
    runs, held against the plain version and timed; global: SDPA
    ``is_causal``). ``launches``: the counted gemma3 prefill's K1 launches
    by shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = {}
    for name, shape in GEMMA_K1.items():
        causal, window = shape[5], shape[6]
        q, k, v = _qkv(shape, "bfloat16", gen)

        def kern():
            return flash_attention(q, k, v, causal=causal, window=window)

        def plain():
            return flash_attention_ref(q, k, v, causal=causal,
                                       window=window)
        out, ref = kern(), plain()
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        rel = _rel_l2(out, ref)
        if window:
            libs = windowed_sdpa(q, k, v, window)
        else:
            libs = {"default (is_causal)":
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=True, enable_gqa=True)}
        tried = {n: {"rel_l2": _rel_l2(call(), ref), "ms": cuda_ms(call)}
                 for n, call in libs.items()}
        same = {n: t for n, t in tried.items() if t["rel_l2"] <= BF16_REL_L2}
        best = min(same, key=lambda n: same[n]["ms"], default=None)
        bnd = attention_bound(shape, "bfloat16")
        t = {"kernel_ms": cuda_ms(kern),
             "kernel_device": device_ms_per_call(kern),
             "plain_ms": cuda_ms(plain, iters=5, warmup=1),
             "library_ms": same[best]["ms"] if best else None,
             "library_device": device_ms_per_call(
                 libs[best], kernels_per_call=None) if best else None}
        rows[name] = {**t, "shape": list(shape), "max_abs_err": err,
                      "rel_l2": rel, "ok": rel <= BF16_REL_L2,
                      "launches": launches[name],
                      "library_backend": best, "library_tried": tried,
                      "bound_us": bnd["bound_ms"] * 1e3,
                      "bound_by": bnd["bound_by"], "flops": bnd["flops"],
                      "bytes": bnd["bytes"]}
    return rows


def phase_models() -> dict:
    """The model zoo on the card: gemma3-27b uncut (K1's windowed and
    global paths), mixtral-8x22b at full width on 8 layers (MoE), zamba2-7b
    (Mamba2 + the shared attention block) and xlstm-350m uncut,
    qwen2-vl-72b at full width on 28 layers (M-RoPE), deepseek-v3 at full
    width on 3 dense + 2 MoE layers (MLA), whisper-small uncut (the
    encoder-decoder, its encoder through K1); then K1 at gemma3's two
    shapes."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    start = torch.cuda.memory_allocated()
    if start > MODELS_START_BYTES:
        raise AssertionError(f"{start / 1e9:.2f} GB still allocated on the "
                             f"card before gemma3-27b's weights are drawn")
    runs = []
    for run in [functools.partial(serve_model, *m) for m in MODELS] + [
            serve_whisper]:
        t0 = time.perf_counter()
        runs.append(run())
        r = runs[-1]
        r["seconds"] = time.perf_counter() - t0
        # progress on stderr: the phase's line comes after every model
        print(json.dumps({"models": r["arch"], "seconds": r["seconds"],
                          "mesh_seconds": (r.get("mesh") or {}).get(
                              "seconds"), "failures": r["failures"]}),
              file=sys.stderr, flush=True)
    gemma = runs[0]
    k1 = gemma_k1_rows({
        "local": gemma["windowed_launches_per_prefill"],
        "global": gemma["launches_per_prefill"]
        - gemma["windowed_launches_per_prefill"]})
    out = {"phase": "models", "start_allocated_gb": start / 1e9,
           "runs": runs, "gemma_k1": k1}
    emit(out)
    bad = [f"{r['arch']}: {f}" for r in runs for f in r["failures"]]
    bad += [f"K1 at gemma3's {n} shape disagrees with its plain version: "
            f"{r['rel_l2']}" for n, r in k1.items() if not r["ok"]]
    bad += [f"no SDPA form computes gemma3's {n} attention: "
            f"{r['library_tried']}" for n, r in k1.items()
            if r["library_backend"] is None]
    if bad:
        raise AssertionError("; ".join(bad))
    return out


# HEIMDALL's runner and the examples (the reference CI's benchmark checks,
# .github/workflows/ci.yml:22-166, on the BENCH files the card writes): each
# check is (family, what, value, comparison, limit), the limit read from the
# file's thresholds where CI reads it there.
TOOLING_FAMILIES = ("micro", "interference", "kv_quant", "qos", "calibration",
                    "obs", "resilience", "disagg", "apps")
CI_CHECKS = [
    ("kv_quant", "bytes_reduction", lambda d: d["bytes_reduction"],
     ">=", lambda d: 1.8),
    ("kv_quant", "prefetch_speedup", lambda d: d["prefetch_speedup"],
     ">=", lambda d: 1.5),
    ("qos", "eta_improvement", lambda d: d["eta_improvement"],
     ">=", lambda d: 1.3),
    ("qos", "single_flow_anchor.rel_err",
     lambda d: d["single_flow_anchor"]["rel_err"], "<", lambda d: 1e-9),
    *[("calibration", k, (lambda k: lambda d: d[k])(k), op,
       (lambda k: lambda d: d["thresholds"][k])(k))
      for k, op in (("fit_bw_err_max", "<="), ("fit_residual_max", "<="),
                    ("validation_rel_err_max", "<="),
                    ("error_reduction_min", ">="))],
    ("obs", "overhead.overhead_frac",
     lambda d: d["overhead"]["overhead_frac"], "<=",
     lambda d: d["thresholds"]["max_overhead_frac"]),
    ("obs", "overhead.attribution_overhead_frac",
     lambda d: d["overhead"]["attribution_overhead_frac"], "<=",
     lambda d: d["thresholds"]["max_attr_overhead_frac"]),
    ("obs", "byte_conservation.max_rel_err",
     lambda d: d["byte_conservation"]["max_rel_err"], "<=",
     lambda d: d["thresholds"]["max_byte_rel_err"]),
    ("obs", "attribution.top_degraded_frac",
     lambda d: d["attribution"]["top_degraded_frac"], ">=",
     lambda d: d["thresholds"]["min_attr_top_frac"]),
    ("obs", "histogram.max_rel_err",
     lambda d: d["histogram"]["max_rel_err"], "<=",
     lambda d: d["thresholds"]["max_hist_rel_err"]),
    ("obs", "drift.flagged_routes", lambda d: d["drift"]["flagged_routes"],
     "==", lambda d: ["host_dram->chip0"]),
    ("obs", "ledger.max_rel_err", lambda d: d["ledger"]["max_rel_err"],
     "<=", lambda d: d["thresholds"]["max_ledger_rel_err"]),
    ("obs", "efficiency.degraded_is_lowest",
     lambda d: d["efficiency"]["degraded_is_lowest"], "==", lambda d: True),
    ("obs", "efficiency.lowest", lambda d: d["efficiency"]["lowest"],
     "==", lambda d: "host_dram->chip0:pcie"),
    ("obs", "recalibration.n_recals",
     lambda d: d["recalibration"]["n_recals"], ">=", lambda d: 1),
    ("obs", "recalibration.max_post_ratio",
     lambda d: d["recalibration"]["max_post_ratio"], "<=",
     lambda d: d["thresholds"]["max_post_recal_ratio"]),
    ("obs", "recalibration.eta_rel_err",
     lambda d: d["recalibration"]["eta_rel_err"], "<=",
     lambda d: d["thresholds"]["max_recal_eta_rel_err"]),
    ("obs", "recalibration.flagged_after",
     lambda d: d["recalibration"]["flagged_after"], "==", lambda d: []),
    ("obs", "openmetrics.valid", lambda d: d["openmetrics"]["valid"],
     "==", lambda d: True),
    ("resilience", "recovery.frac", lambda d: d["recovery"]["frac"], ">=",
     lambda d: d["thresholds"]["min_recovery_frac"]),
    ("resilience", "detect.latency_rounds",
     lambda d: d["detect"]["latency_rounds"], "<=",
     lambda d: d["thresholds"]["max_detect_rounds"]),
    ("resilience", "slo.violations_react",
     lambda d: d["slo"]["violations_react"], "<",
     lambda d: d["slo"]["violations_baseline"]),
    ("resilience", "hot_remove.react_recovery_frac",
     lambda d: d["hot_remove"]["react_recovery_frac"], ">=",
     lambda d: d["thresholds"]["min_recovery_frac"]),
    ("resilience", "detector_overhead_us",
     lambda d: d["detector_overhead_us"], "<=",
     lambda d: d["thresholds"]["max_detector_overhead_us"]),
    ("disagg", "overlap_speedup", lambda d: d["overlap_speedup"], ">=",
     lambda d: d["thresholds"]["overlap_speedup_min"]),
    ("disagg", "deadline_violations", lambda d: d["deadline_violations"],
     "<=", lambda d: d["thresholds"]["deadline_violations_max"]),
    ("disagg", "route_choice.nominal_staging",
     lambda d: d["route_choice"]["nominal_staging"], "==", lambda d: None),
    ("disagg", "route_choice.degraded_staging",
     lambda d: d["route_choice"]["degraded_staging"], "==",
     lambda d: "host_dram"),
    ("disagg", "compressed_ship.bytes_reduction",
     lambda d: d["compressed_ship"]["bytes_reduction"], ">=",
     lambda d: 1.8),
]
CI_OPS = {">=": lambda v, lim: v is not None and v >= lim,
          "<=": lambda v, lim: v is not None and v <= lim,
          "<": lambda v, lim: v is not None and v < lim,
          "==": lambda v, lim: v == lim}
# summaries whose values do not depend on where the pools live: the card's
# must equal the CPU's, but for the obs family's measured overhead timings
TOOLING_SAME_AS_CPU = {"kv_quant": (), "obs": ("overhead",)}
QUICKSTART_HELD = ("arch=", "placement:", "cost-model optimal offload:")
TINY_LM = {"steps": 300, "batch": 8, "seq": 256, "every": 75}
CLI_TIMEOUT_S = 300


def ci_bench_checks(bench: dict) -> list:
    """Every assertion of the reference CI's benchmark steps on the BENCH
    files, each with its value and its limit."""
    rows = []
    for fam, what, value, op, limit in CI_CHECKS:
        d = bench[fam]
        v, lim = value(d), limit(d)
        rows.append({"family": fam, "check": what, "value": v, "op": op,
                     "limit": lim, "ok": bool(CI_OPS[op](v, lim))})
    return rows


def timed_calls(key: str, fn, walls: list):
    """``fn`` (its name kept) appending ``(key, wall s)`` to ``walls`` at
    each call."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            walls.append((key, time.perf_counter() - t0))
    return call


@contextlib.contextmanager
def timed_families(run, walls: list):
    """The runner's benchmarks and summaries, each call timed under its
    family's name (``"<family> summary"`` for a summary)."""
    from unittest import mock
    fams = {f: [timed_calls(f, fn, walls) for fn in fns]
            for f, fns in run._families().items()}
    summary_fn = run._summary_fn
    with mock.patch.object(run, "_families", lambda: fams), \
            mock.patch.object(run, "_summary_fn", lambda f: timed_calls(
                f"{f} summary", summary_fn(f), walls)):
        yield


def run_main(main, argv: list) -> tuple:
    """(exit code, return value, stdout, stderr) of an entry point's
    ``main(argv)`` called in this process."""
    import io
    out, err = io.StringIO(), io.StringIO()
    code, value = 0, None
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            value = main(argv)
        except SystemExit as e:
            code = 0 if e.code is None else e.code
    return code, value, out.getvalue(), err.getvalue()


@contextlib.contextmanager
def checkpoint_walls(walls: list):
    """Each checkpoint's host snapshot and file write, timed where
    ``checkpoint/ckpt.py`` does them (the write on its worker thread)."""
    from unittest import mock

    from repro_torch.checkpoint import ckpt
    with mock.patch.object(ckpt, "_snapshot", timed_calls(
            "snapshot", ckpt._snapshot, walls)), \
            mock.patch.object(ckpt, "_write", timed_calls(
                "write", ckpt._write, walls)):
        yield


def _tooling_runner(dest: Path) -> tuple:
    """HEIMDALL's runner in this process on the card, all nine families at
    the reference's default sizes, BENCH files into ``dest``."""
    from repro_torch import kernels
    from repro_torch.heimdall import run

    fams = run._families()
    walls: list = []
    kernels.reset_launches()
    t0 = time.perf_counter()
    with timed_families(run, walls):
        code, _, csv, err = run_main(run.main,
                                     ["--json-out-dir", str(dest)])
    family_s: dict = {}
    for key, dt in walls:
        family_s[key] = family_s.get(key, 0.0) + dt
    out = {"wall_s": time.perf_counter() - t0, "exit": code,
           "family_s": family_s, "launches": dict(kernels.LAUNCHES)}
    (dest / "run.csv").write_text(csv)
    (dest / "run.err").write_text(err)
    status = {ln.split(":")[0][len("family "):]: ln.split(": ", 1)[1]
              for ln in err.splitlines() if ln.startswith("family ")}
    out["status"] = status
    out["rows"] = csv.count("\n") - 1
    fails = [f"runner exit {code}"] if code else []
    fails += [f"family {f}: {status.get(f)}, expected "
              f"ran={len(fams[f])} skipped=0 failed=0"
              for f in TOOLING_FAMILIES if status.get(f) !=
              f"ran={len(fams[f])} skipped=0 failed=0"]
    fails += [f"ERROR row: {ln}" for ln in csv.splitlines()
              if ",ERROR," in ln]
    if fails:
        print(err[-8000:], file=sys.stderr)
    return out, fails


def _tooling_cli(dest: Path) -> dict:
    """The entry points as users type them, in subprocesses started
    together: the runner's qos family, and CI's two artifact steps (a
    traced --paged-sim serve, a flight-recorder dump of --degrade-sim)."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cli = dest / "cli"
    cli.mkdir()
    jobs = {"qos": ["repro_torch.heimdall.run", "--families", "qos",
                    "--json-out", str(cli / "BENCH_qos.json")],
            "paged_sim": ["repro_torch.launch.serve", "--paged-sim",
                          "--trace-out", str(cli / "trace.json"),
                          "--metrics-out", str(cli / "metrics.json"),
                          "--openmetrics-out", str(cli / "openmetrics.txt")],
            "degrade_sim": ["repro_torch.launch.serve", "--degrade-sim",
                            "--recorder-out",
                            str(cli / "flight_recorder.json")]}
    procs = {}
    for name, argv in jobs.items():
        log = open(cli / f"{name}.out", "w")
        procs[name] = (subprocess.Popen(
            [sys.executable, "-m", *argv], cwd=ROOT, env=env, stdout=log,
            stderr=subprocess.STDOUT), log)
    return procs


def _tooling_cli_check(procs: dict, cli: Path, bench: dict) -> tuple:
    """Wait for ``_tooling_cli``'s processes and check what they wrote."""
    from repro_torch.obs import validate_chrome_trace
    fails = []
    out = {}
    for name, (p, log) in procs.items():
        try:
            code = p.wait(timeout=CLI_TIMEOUT_S)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
        out[f"{name}_exit"] = code
        if code:
            fails.append(f"{name} exited {code}: "
                         f"{(cli / f'{name}.out').read_text()[-2000:]}")
    if fails:
        return out, fails
    qos = json.loads((cli / "BENCH_qos.json").read_text())
    if qos != bench["qos"]:
        fails.append("the CLI's BENCH_qos.json differs from the runner's "
                     "in-process one")
    trace = json.loads((cli / "trace.json").read_text())
    out["paged_sim_trace"] = dict(validate_chrome_trace(trace))
    out["metrics_keys"] = len(json.loads(
        (cli / "metrics.json").read_text()))
    om = (cli / "openmetrics.txt").read_text()
    out["openmetrics_lines"] = om.count("\n")
    if not om.endswith("# EOF\n"):
        fails.append("openmetrics.txt does not end in # EOF")
    rec = json.loads((cli / "flight_recorder.json").read_text())
    out["recorder_trace"] = dict(validate_chrome_trace(rec))
    md = rec["metadata"]
    out["recorder"] = {"reason": md["reason"], "events": md["events"]}
    if md["reason"] == "dump":
        fails.append("the flight recorder's dump is the fallback "
                     "('dump'), not a triggered snapshot")
    return out, fails


def _tooling_quickstart(dest: Path) -> tuple:
    """quickstart on the card and on the CPU: the placement and cost-model
    lines equal, finite losses, 8 tokens a request in the vocabulary, K1
    launched once a layer in its serve's prefill and its prefill logits
    within LOGITS_REL_L2 of the eager path's on the same weights."""
    import tempfile

    import torch
    from repro_torch import kernels
    from repro_torch.config.base import ParallelConfig
    from repro_torch.examples import quickstart
    from repro_torch.models.model import Model

    fails, runs = [], {}
    for where in ("cuda", "cpu"):
        # train() resumes from the newest checkpoint in the example's own
        # scratch directory: every run starts without it
        shutil.rmtree(quickstart.checkpoint_dir(), ignore_errors=True)
        kernels.reset_launches()
        t0 = time.perf_counter()
        code, runs[where], text, err = run_main(quickstart.main,
                                                ["--device", where])
        runs[where]["wall_s"] = time.perf_counter() - t0
        runs[where]["k1"] = kernels.LAUNCHES["flash_attention"]
        runs[where]["lines"] = text.splitlines()
        (dest / f"quickstart_{where}.out").write_text(text + err)
        if code:
            fails.append(f"quickstart on {where} exited {code}")
    shutil.rmtree(quickstart.checkpoint_dir(), ignore_errors=True)
    card = runs["cuda"]
    held = {w: [ln for ln in r["lines"] if ln.startswith(QUICKSTART_HELD)]
            for w, r in runs.items()}
    if held["cuda"] != held["cpu"] or len(held["cuda"]) != 3:
        fails.append(f"quickstart's deterministic lines differ: {held}")
    hist = card["train"]["history"]
    small = card["engine"].cfg
    toks = [r.tokens for r in card["results"]]
    if len(hist) != 10 or not all(math.isfinite(x) for x in hist):
        fails.append(f"quickstart's losses: {hist}")
    if any(len(t) != 8 or min(t) < 0 or max(t) >= small.vocab_size
           for t in toks):
        fails.append(f"quickstart's tokens: {toks}")
    if card["k1"] != small.num_layers:
        fails.append(f"K1 launched {card['k1']} times in quickstart's "
                     f"serve; expected {small.num_layers}")
    engine = card["engine"]
    batch = _left_pad_batch(card["requests"], "cuda")
    params = engine.model.params
    eager = Model.create(small, ParallelConfig(attention_kernel="eager"))
    with torch.inference_mode():
        lk, _ = engine.model.prefill(params, batch)
        le, _ = eager.prefill(params, batch)
    lk, le = lk.float(), le.float()
    rel_l2 = ((lk - le).norm() / le.norm()).item()
    if not (torch.isfinite(lk).all() and rel_l2 <= LOGITS_REL_L2):
        fails.append(f"quickstart's K1 prefill logits: relative L2 "
                     f"{rel_l2} from the eager path's > {LOGITS_REL_L2}")
    out = {"held_lines": held["cuda"], "losses": [hist[0], hist[-1]],
           "tokens": toks, "k1_launches": card["k1"],
           "head_dim": small.head_dim,
           "logits_rel_l2_kernel_vs_eager": rel_l2,
           "logits_rel_l2_bound": LOGITS_REL_L2,
           "serve_line": card["lines"][-1],
           "wall_s": {w: r["wall_s"] for w, r in runs.items()}}
    return out, fails


def _tooling_tiny_lm(dest: Path) -> tuple:
    """train_tiny_lm's full deliverable on the card: lm-100m, 300 steps of
    batch 8 x 256, remat full, checkpoints every 75 steps into a fresh
    directory under build/."""
    import torch
    from repro_torch.examples import train_tiny_lm

    ckpt_dir = dest / "lm100m_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    walls: list = []
    t0 = time.perf_counter()
    with checkpoint_walls(walls):
        code, tr, text, err = run_main(train_tiny_lm.main,
                                       ["--ckpt-dir", str(ckpt_dir)])
    wall = time.perf_counter() - t0
    (dest / "train_tiny_lm.out").write_text(text + err)
    fails = [f"train_tiny_lm exited {code}"] if code else []
    if fails:
        return {}, fails
    hist, step_s = tr["history"], sorted(tr["step_s"][1:])
    final = json.loads(text.splitlines()[-1])
    saved = sorted(p.name for p in ckpt_dir.iterdir())
    want = [f"step_{s:08d}" for s in range(TINY_LM["every"],
                                            TINY_LM["steps"],
                                            TINY_LM["every"])]
    med = step_s[len(step_s) // 2]
    out = {"config_line": text.splitlines()[0], "final": final,
           "steps": len(hist), "first_loss": hist[0],
           "final_loss": hist[-1],
           "step_median_ms": med * 1e3, "step_max_ms": step_s[-1] * 1e3,
           "first_step_ms": tr["step_s"][0] * 1e3,
           "tokens_per_s": TINY_LM["batch"] * TINY_LM["seq"] / med,
           "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "init_s": tr["init_s"], "wall_s": wall,
           "checkpoints": saved,
           "checkpoint_snapshot_s": [w for k, w in walls if k == "snapshot"],
           "checkpoint_write_s": [w for k, w in walls if k == "write"]}
    if len(hist) != TINY_LM["steps"] or not all(math.isfinite(x)
                                                for x in hist):
        fails.append(f"train_tiny_lm: {len(hist)} losses, finite: "
                     f"{all(math.isfinite(x) for x in hist)}")
    if final["improved"] is not True or not hist[-1] < hist[0]:
        fails.append(f"train_tiny_lm did not improve: {final}")
    if saved != want:
        fails.append(f"train_tiny_lm's checkpoints {saved}, expected "
                     f"{want}")
    shutil.rmtree(ckpt_dir)                 # 3 x 1.23 GB of state
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return out, fails


def phase_tooling(host_gb_per_s=None) -> dict:
    """HEIMDALL's runner and the four examples on the card: (a)
    ``heimdall.run.main(["--json-out-dir", ...])`` in this process, all
    nine families at the reference's default sizes, every family ran and
    none failed, the six BENCH files held to every assertion of the
    reference CI's benchmark steps, kv_quant's and obs's summaries equal
    to the CPU's but for obs's overhead timings, the launches counted; (b)
    ``python -m repro_torch.heimdall.run --families qos --json-out`` and
    CI's two artifact steps (a traced ``--paged-sim`` serve, the flight
    recorder of ``--degrade-sim``) as subprocesses; (c) quickstart,
    serve_batched, offload_tuning (its defaults, then the card's memory,
    its fitted host link ``host_gb_per_s`` and 989 TFLOP/s) and
    train_tiny_lm's full deliverable."""
    import torch
    from repro_torch import kernels
    from repro_torch.examples import offload_tuning, serve_batched
    from repro_torch.heimdall import kv_quant, obs

    dest = ROOT / "build" / "tooling"
    shutil.rmtree(dest, ignore_errors=True)
    dest.mkdir(parents=True)
    t_phase = time.perf_counter()
    import torch.distributed as dist
    out = {"phase": "tooling",
           "process_group_at_start": dist.is_available()
           and dist.is_initialized()}
    runner, fails = _tooling_runner(dest)
    bench = {f: json.loads((dest / f"BENCH_{f}.json").read_text())
             for f in ("kv_quant", "qos", "calibration", "obs",
                       "resilience", "disagg")
             if (dest / f"BENCH_{f}.json").exists()}
    if len(bench) != 6:
        fails.append(f"BENCH files written: {sorted(bench)}")
    lc = runner.pop("launches")
    runner["launches"] = {
        "K1": lc["flash_attention"], "K2": lc["paged_attention"],
        "K3": lc["paged_attention_quant"], "K4": lc["quantize_pages"],
        "K5": lc["dequantize_pages"],
        **{p: lc[p] for p in PROBES}}
    fails += [f"{k} never launched in the runner's families"
              for k in ("K1", "K2", "K3", *PROBES)
              if runner["launches"][k] == 0]
    out["runner"] = runner
    out["process_group_after_runner"] = dist.is_initialized()
    procs = _tooling_cli(dest)
    try:
        checks = ci_bench_checks(bench) if len(bench) == 6 else []
        fails += [f"CI check {c['family']} {c['check']}: {c['value']} "
                  f"{c['op']} {c['limit']} fails" for c in checks
                  if not c["ok"]]
        out["ci_checks"] = [[c["family"], c["check"], c["value"], c["op"],
                             c["limit"]] for c in checks]
        t0 = time.perf_counter()
        # obs's overhead entry is wall-clock, left out of the comparison:
        # the CPU's summary takes the card's instead of timing 100 CPU
        # serves (a minute of the phase) that nothing reads
        from unittest import mock
        card_fracs = obs._overhead_fracs(torch.device("cuda"))
        with mock.patch.object(obs, "_overhead_fracs",
                               lambda device: card_fracs):
            cpu = {"kv_quant": kv_quant.bench_summary(device="cpu"),
                   "obs": obs.obs_summary(device="cpu")}
        out["cpu_summaries_s"] = time.perf_counter() - t0
        for fam, timed in TOOLING_SAME_AS_CPU.items():
            card = {k: v for k, v in bench.get(fam, {}).items()
                    if k not in timed}
            _same_reports(f"BENCH_{fam}.json", card,
                          {k: v for k, v in json.loads(json.dumps(
                              cpu[fam])).items() if k not in timed})
        t0 = time.perf_counter()
        out["cli"], bad = _tooling_cli_check(procs, dest / "cli", bench)
        out["cli"]["wait_s"] = time.perf_counter() - t0
        fails += bad
    finally:
        for p, log in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()

    t0 = time.perf_counter()
    out["quickstart"], bad = _tooling_quickstart(dest)
    out["quickstart"]["phase_s"] = time.perf_counter() - t0
    fails += bad
    kernels.reset_launches()
    code, arms, _, _ = run_main(serve_batched.main, [])
    out["serve_batched"] = {**(arms or {}), "k1_launches":
                            kernels.LAUNCHES["flash_attention"]}
    if code or sorted(arms or {}) != ["hbm", "host_sync_offload"]:
        fails.append(f"serve_batched: exit {code}, {arms}")
    card_mem = torch.cuda.get_device_properties(0).total_memory
    if host_gb_per_s is None:
        host_gb_per_s = fitted_host_link()
    tuning = {"defaults": [], "card": [
        "--hbm-gib", f"{card_mem / 2**30:.2f}",
        # the example reads --link-gbs in GiB/s
        "--link-gbs", f"{host_gb_per_s * 1e9 / 2**30:.2f}",
        "--peak-tflops", "989"]}
    out["offload_tuning"] = {}
    for name, argv in tuning.items():
        code, _, text, _ = run_main(offload_tuning.main, argv)
        out["offload_tuning"][name] = {"argv": argv,
                                       "lines": text.splitlines()[-2:]}
        (dest / f"offload_tuning_{name}.out").write_text(text)
        if code or "paper-faithful optimum" not in text:
            fails.append(f"offload_tuning {argv}: exit {code}")
    out["offload_tuning"]["host_link_gb_per_s"] = host_gb_per_s
    out["train_tiny_lm"], bad = _tooling_tiny_lm(dest)
    fails += bad
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    if fails:
        raise AssertionError("; ".join(fails))
    return out


def fitted_host_link() -> float:
    """The host link's bandwidth (GB/s) as the heimdall phase fits it, for
    a run of the tooling phase without that phase."""
    import torch
    from repro_torch.calibrate import CalibrationRunner
    profile = CalibrationRunner("tpu_v5e", source="torch",
                                device=torch.device("cuda", 0)).calibrate()
    return profile.estimate("host_dram", "chip0").bandwidth / 1e9


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
                 heimdall: dict, models: dict, mesh: dict) -> dict:
    """Every ported kernel: launches on its main paths (K1: the HBM and the
    offloaded engines' counted runs, the mesh path's and the models
    phase's, its mesh reruns included; P1-P4: the
    micro family's), agreement with its plain version, its times at the
    main path's shape, and its share of its bound (bound over device time,
    or over event time where the profiler recorded none). K1 has a row at
    yi-9b's prefill shape, one at whisper-small's encoder shape and one at
    qwen2-vl-72b's prefill shape (launches: those models' counted runs),
    and one at each of gemma3-27b's (the local layers' window and the
    global layers), whose launches are the models phase's counted gemma3
    prefill's windowed and other K1 launches."""
    yi = kern["yi_prefill_bf16"]
    k1_source = ("src/repro_torch/kernels/flash_attention/csrc/"
                 "flash_attention.cu")
    k1_replaces = "src/repro/kernels/flash_attention/kernel.py:26"
    rows = [{
        "name": "flash_attention", "route": "cuda",
        "source": k1_source, "replaces": k1_replaces,
        "launches": serve["launches"]["flash_attention"]
        + offload["launches"]["flash_attention"]
        + mesh["launches"]["flash_attention"]
        + sum(r["launches"]["flash_attention"]
              + (r["mesh"]["launches"]["flash_attention"] if r.get("mesh")
                 else 0) for r in models["runs"]),
        "matched": all(c["ok"] for c in kern["cases"]),
        "max_abs_err": yi["max_abs_err"],
        "ms": yi["kernel_ms"], **_device_cols(yi),
        "plain_ms": yi["plain_ms"],
        "bound_ms": yi["bound_us"] / 1e3, "bound_by": yi["bound_by"],
        "library_ms": yi["library_ms"]}]
    by_arch = {r["arch"]: r for r in models["runs"]}
    for name, arch in (("whisper_encoder", "whisper-small"),
                       ("qwen2vl_prefill", "qwen2-vl-72b")):
        t = kern["model_shapes"][name]
        run = by_arch[arch]
        rows.append({
            "name": f"flash_attention/{name}", "route": "cuda",
            "source": k1_source, "replaces": k1_replaces,
            "launches": run["launches"]["flash_attention"] + (
                run["mesh"]["launches"]["flash_attention"] if run.get("mesh")
                else 0),
            "matched": all(c["ok"] for c in kern["cases"]
                           if c["shape"] == t["shape"]),
            "max_abs_err": t["max_abs_err"], "shape": t["shape"],
            "ms": t["kernel_ms"], **_device_cols(t),
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_us"] / 1e3, "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    for shape, t in models["gemma_k1"].items():
        rows.append({
            "name": f"flash_attention/gemma3_{shape}", "route": "cuda",
            "source": k1_source, "replaces": k1_replaces,
            "launches": t["launches"], "matched": t["ok"],
            "max_abs_err": t["max_abs_err"], "shape": t["shape"],
            "ms": t["kernel_ms"], **_device_cols(t),
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_us"] / 1e3, "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library_backend": t["library_backend"]})
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
    phase_decode_kernel()
    phase_norm_rope_kernel()
    paged = phase_paged_kernels()
    serve = phase_serve()
    mesh = phase_mesh(serve)
    for key in ("params", "prefill_logits"):
        del serve[key]
    offload = phase_serve_offload(serve.pop("tokens"))
    pager = phase_pager()
    phase_degrade()
    phase_disagg()
    heimdall = phase_heimdall(offload["fetch_gb_per_s"])
    phase_paged_sim()
    phase_kv_quant()
    models = phase_models()
    phase_tooling(heimdall["host_link"]["fitted_gb_per_s"])
    # last: its processes load the host's cores, which the timed phases'
    # host-bound loops would share
    phase_dryrun(mesh)
    emit(kernels_line(kern, serve, offload, paged, pager, flat, compressed,
                      heimdall, models, mesh))


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
        "mesh": phase_mesh, "dryrun": phase_dryrun,
        "pager": phase_pager, "paged_kernels": phase_paged_kernels,
        "degrade": phase_degrade, "disagg": phase_disagg,
        "heimdall": phase_heimdall, "models": phase_models,
        "kernel": phase_kernel, "decode_kernel": phase_decode_kernel,
        "norm_rope_kernel": phase_norm_rope_kernel,
        "tooling": phase_tooling}


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
    try:
        run_phases(only)
    finally:
        stop_dryrun()
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                 "count": dev["count"]}})
    return 0


def run_phases(only: list) -> None:
    if only:
        tokens, serve, mesh, host = None, None, None, None
        for name in only:
            if name == "serve_offload":
                # as in phase_all, the serve phase's weights go first: on
                # the card they would count as left between offloaded calls
                serve = None
                phase_serve_offload(tokens)
            elif name == "serve":
                serve = phase_serve()
                tokens = serve["tokens"]
            elif name == "mesh":
                mesh = phase_mesh(serve)
                serve = None
            elif name == "dryrun":
                phase_dryrun(mesh)
            elif name == "heimdall":
                host = phase_heimdall()["host_link"]["fitted_gb_per_s"]
            elif name == "tooling":
                phase_tooling(host)
            else:
                ONLY[name]()
    else:
        phase_all()


if __name__ == "__main__":
    sys.exit(main())
