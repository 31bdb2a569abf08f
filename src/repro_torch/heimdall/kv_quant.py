"""kv_quant benchmark family — the quantized KV paging headline numbers.

The port of the reference's ``repro/heimdall/kv_quant.py``. Views of the
same question (does int8 paging pay for itself on the contended host
link?), all over an *identical page set* so the ratios are
apples-to-apples:

  * ``kv_quant_bytes_moved``     — host-link bytes per page set, fp vs int8
  * ``kv_quant_prefetch_sim``    — simulated contended prefetch completion
  * ``kv_quant_decode_schedule`` — deadline-aware decode latency (the
                                   DecodeScheduler end-to-end view)
  * ``kv_quant_kernel_wall``     — wall-clock of the fused int8 paged
                                   attention kernel vs the fp kernel, on
                                   the device

The first three are simulations on the page set's metadata; their pagers'
pools live on ``device`` like every entry point's (default ``cuda``).
``bench_summary()`` condenses the family into the ``BENCH_kv_quant.json``
schema: bytes moved, simulated prefetch time, and decode-step latency fp16
vs int8.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.heimdall.harness import Row, time_fn_stats
from repro_torch.models.context import resolve_device

GiB = 1 << 30


@functools.lru_cache(maxsize=2)
def _paired_caches(device: torch.device):
    """Two pagers with identical placement: bf16 vs int8 cold tier (the
    shared builder lives in launch.serve so the page set cannot drift
    between the decode report and these byte/prefetch rows)."""
    from repro_torch.launch.serve import paired_kv_caches
    return paired_kv_caches(device=device)


@functools.lru_cache(maxsize=2)
def _headline_report(device: torch.device) -> dict:
    """One simulate_paged_decode run shared by the decode rows and the
    JSON summary (it is the family's most expensive simulation)."""
    from repro_torch.launch.serve import simulate_paged_decode
    return simulate_paged_decode(device=device)


def kv_quant_bytes_moved(device=None) -> list:
    """Host-link bytes for one page set, fp16 vs int8 (+scales)."""
    caches = _paired_caches(resolve_device(device))
    seqs = list(range(8))
    rows = []
    per_page = {}
    for label, c in caches.items():
        n = len(c.host_pages(seqs))
        nbytes = n * c.host_page_bytes
        per_page[label] = nbytes
        rows.append(Row(f"kv_quant_bytes/{label}", 0.0,
                        f"host_pages={n};bytes={nbytes};"
                        f"page_bytes={c.host_page_bytes}"))
    rows.append(Row("kv_quant_bytes/reduction", 0.0,
                    f"x={per_page['fp16'] / per_page['int8']:.3f}"))
    return rows


def kv_quant_prefetch_sim(device=None) -> list:
    """Contended prefetch completion for the same page set, fp vs int8
    (offload stream as background on the shared host link)."""
    from repro_torch.fabric.contention import Flow
    caches = _paired_caches(resolve_device(device))
    seqs = list(range(8))
    # fixed size: identical background for both runs (see serve.py note)
    bg = (Flow("offload", "host", "hbm", nbytes=256 << 20),)
    rows = []
    totals = {}
    for label, c in caches.items():
        # priority pinned to 0: this family's premise is the *egalitarian*
        # contended regime; the qos family measures what prioritized page
        # fetches buy on top
        plan = c.plan_prefetch(seqs, background=bg, priority=0)
        totals[label] = plan.total_time
        rows.append(Row(f"kv_quant_prefetch/{label}",
                        plan.total_time * 1e6,
                        f"pages={len(plan.order)};"
                        f"eff_GiB_s={plan.effective_bw / GiB:.2f}"))
    rows.append(Row("kv_quant_prefetch/speedup", 0.0,
                    f"x={totals['fp16'] / totals['int8']:.3f}"))
    return rows


def kv_quant_decode_schedule(device=None) -> list:
    """Deadline-aware decode (DecodeScheduler) latency, fp16 vs int8."""
    d = _headline_report(resolve_device(device))
    rows = []
    for label in ("fp16", "int8"):
        r = d[label]
        rows.append(Row(f"kv_quant_decode/{label}",
                        r["mean_completion_s"] * 1e6,
                        f"first_admit_us={r['first_admit_s'] * 1e6:.1f};"
                        f"overlap={r['overlap_speedup']:.3f}"))
    rows.append(Row("kv_quant_decode/speedup", 0.0,
                    f"x={d['decode_latency_speedup']:.3f}"))
    return rows


def kv_quant_kernel_wall(B: int = 4, Hq: int = 8, Hkv: int = 2,
                         d: int = 64, page: int = 16, pps: int = 4,
                         device=None) -> list:
    """Wall-clock of the fused int8 paged attention kernel vs the fp
    kernel on ``device`` (default ``cuda``; raises if there is none), each
    call ending in a device synchronise."""
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_quant)
    from repro_torch.kernels.quant import quantize_pages
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    n_pages = B * pps + 4

    def put(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a)).to(device, dtype)
    q = put(rng.normal(size=(B, Hq, d)))
    kp = put(rng.normal(size=(n_pages, page, Hkv, d)))
    vp = put(rng.normal(size=(n_pages, page, Hkv, d)))
    bt = put(rng.permutation(n_pages)[:B * pps].reshape(B, pps), torch.int32)
    sl = put(rng.integers(1, pps * page + 1, B), torch.int32)
    kq, ks = quantize_pages(kp)
    vq, vs = quantize_pages(vp)
    # dispersion-guarded wall timing: an unstable measurement is retried
    # and the rerun count rides the Row into the CSV artifact
    t_fp = time_fn_stats(paged_attention, q, kp, vp, bt, sl, iters=5,
                         max_dispersion=0.25)
    t_q = time_fn_stats(paged_attention_quant, q, kq, vq, ks, vs, bt, sl,
                        iters=5, max_dispersion=0.25)
    return [Row("kv_quant_kernel/fp", t_fp.median * 1e6,
                f"B={B};pps={pps};device={device.type}",
                n_reruns=t_fp.n_reruns),
            Row("kv_quant_kernel/int8", t_q.median * 1e6,
                f"rel={t_q.median / t_fp.median:.2f}x",
                n_reruns=t_q.n_reruns)]


ALL_KV_QUANT = [kv_quant_bytes_moved, kv_quant_prefetch_sim,
                kv_quant_decode_schedule, kv_quant_kernel_wall]


def bench_summary(device=None) -> dict:
    """The BENCH_kv_quant.json payload: bytes moved, simulated prefetch
    time, and decode-step latency, fp16 vs int8 on one page set."""
    from repro_torch.core.compression import (expected_int8_rel_error,
                                              int8_compression_factor)
    d = _headline_report(resolve_device(device))
    blk = 64 * 128                       # page_size * head_dim per block
    return {
        "family": "kv_quant",
        "system": d["system"],
        "page_set": {"requests": d["requests"],
                     "tokens_per_seq": d["tokens_per_seq"],
                     "host_pages": d["fp16"]["host_pages"]},
        "host_link_bytes": {lbl: d[lbl]["host_link_bytes"]
                            for lbl in ("fp16", "int8")},
        "bytes_reduction": d["bytes_reduction"],
        "prefetch_total_s": {lbl: d[lbl]["prefetch_total_s"]
                             for lbl in ("fp16", "int8")},
        "prefetch_speedup": d["prefetch_speedup"],
        "decode_mean_completion_s": {lbl: d[lbl]["mean_completion_s"]
                                     for lbl in ("fp16", "int8")},
        "decode_latency_speedup": d["decode_latency_speedup"],
        "quant_model": {
            "block_elems": blk,
            "compression_vs_bf16": round(
                float(int8_compression_factor("bfloat16", blk)), 3),
            "expected_rel_rms_error": expected_int8_rel_error(blk),
        },
    }
