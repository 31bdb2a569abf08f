"""qos benchmark family — DMA QoS (weighted/priority link sharing) numbers.

The port of the reference's ``repro/heimdall/qos.py``: the same rows and
summary, every time a simulation on the ``tpu_v5e`` preset. The one pager
(``qos_decode_admission``) holds its pools on ``device``, as every entry
point's does (default ``cuda``).

CXL-Interference's class-dependent degradation, answered by the fabric's
arbitration: the same page-prefetch stream under the same bulk background
is measured in three DMA classes — egalitarian (the pre-QoS model), a 4x
weight, and strict priority — so the headline is how much sooner the last
deadline-critical page lands when the link arbitrates instead of splitting.

  * ``qos_single_flow_anchor``  — a classed flow, uncontended, must still
                                  reproduce the closed form exactly (QoS
                                  cannot distort the calibrated base model)
  * ``qos_weighted_split``      — steady-state rate split at 1:1 / 2:1 / 4:1
                                  weights on one shared link
  * ``qos_priority_shield``     — scenario view: prefetch slowdown next to
                                  a bulk stream, egalitarian vs prioritized
  * ``qos_prefetch_eta``        — the headline: last-page ETA per DMA class
                                  over an identical background
  * ``qos_decode_admission``    — end-to-end: DecodeScheduler admission /
                                  completion with prioritized page fetches

``qos_summary()`` condenses the family into the reference's
``BENCH_qos.json`` schema (eta_improvement must stay >= 1.3).
"""

from __future__ import annotations

import functools

from repro_torch.fabric.contention import Flow, max_min_rates
from repro_torch.fabric.scenarios import offload_vs_prefetch, \
    qos_prefetch_over_bulk
from repro_torch.fabric.sim import simulate, single_flow_time
from repro_torch.fabric.systems import get_system
from repro_torch.heimdall.harness import Row
from repro_torch.models.context import resolve_device
from repro_torch.serving.pager import plan_prefetch

GiB = 1 << 30
MiB = 1 << 20

# Headline scenario: one page set, one bulk background, three DMA classes.
N_PAGES = 24
PAGE_BYTES = 1 * MiB
BULK_BYTES = 256 * MiB
_CLASSES = (("egalitarian", {}),
            ("weighted_w4", {"weight": 4.0}),
            ("prioritized", {"priority": 1}))


def _bulk_background() -> tuple:
    return (Flow("bulk_offload", "host", "hbm", nbytes=BULK_BYTES),)


@functools.lru_cache(maxsize=1)
def _eta_plans() -> dict:
    """PrefetchPlan per DMA class — same pages, same bulk background."""
    pages = tuple(range(N_PAGES))
    return {label: plan_prefetch(list(pages), PAGE_BYTES,
                                 background=_bulk_background(), **kw)
            for label, kw in _CLASSES}


def qos_single_flow_anchor() -> list:
    """A weighted + prioritized flow alone on the fabric must finish in
    exactly ``single_flow_time`` — QoS only redistributes contention, it
    must not perturb the uncontended calibration anchor."""
    s = get_system("tpu_v5e")
    nbytes = 64 * MiB
    rows = []
    for label, kw in _CLASSES:
        r = simulate(s.fabric, [Flow("f", "host_dram", "chip0", nbytes,
                                     **kw)])[0]
        cf = single_flow_time(s.fabric, "host_dram", "chip0", nbytes)
        rows.append(Row(f"qos_anchor/{label}", r.duration * 1e6,
                        f"GiB_s={nbytes / GiB / r.duration:.2f};"
                        f"closed_form_err={abs(r.duration - cf) / cf:.2e}"))
    return rows


def qos_weighted_split() -> list:
    """Steady-state split of one shared link between a weighted flow and a
    weight-1 neighbor: the share tracks w/(w+1)."""
    s = get_system("tpu_v5e")
    rows = []
    for w in (1.0, 2.0, 4.0):
        flows = [Flow("heavy", "host_dram", "chip0", weight=w),
                 Flow("neighbor", "host_dram", "chip0")]
        rates = max_min_rates(s.fabric, flows)
        share = rates["heavy"] / (rates["heavy"] + rates["neighbor"])
        rows.append(Row(f"qos_weighted_split/w={w:g}", 0.0,
                        f"heavy_GiB_s={rates['heavy'] / GiB:.2f};"
                        f"share={share:.3f}"))
    return rows


def qos_priority_shield() -> list:
    """Scenario view: the KV prefetch's slowdown next to a bulk offload
    stream, egalitarian vs strict-priority (the shield the pager buys)."""
    rows = []
    for label, sc in (("egalitarian", offload_vs_prefetch()),
                      ("prioritized", qos_prefetch_over_bulk())):
        r = sc.result("kv_prefetch")
        rows.append(Row(f"qos_priority_shield/{label}", r.duration * 1e6,
                        f"prefetch_slowdown={sc.slowdown['kv_prefetch']:.2f}x;"
                        f"offload_slowdown={sc.slowdown['offload']:.2f}x"))
    return rows


def qos_prefetch_eta() -> list:
    """Headline: when does the LAST page land, per DMA class, under an
    identical bulk background on the shared host link?"""
    plans = _eta_plans()
    base = plans["egalitarian"].total_time
    rows = []
    for label, plan in plans.items():
        rows.append(Row(f"qos_prefetch_eta/{label}",
                        plan.total_time * 1e6,
                        f"eff_GiB_s={plan.effective_bw / GiB:.2f};"
                        f"improvement={base / plan.total_time:.2f}x"))
    return rows


def qos_decode_admission(device=None) -> list:
    """End-to-end DecodeScheduler view: admission deadlines tighten when
    the page fetches ride the high-priority DMA class. The pager's pools
    live on ``device`` (default ``cuda``; raises if there is none)."""
    import torch

    from repro_torch.launch.serve import DecodeScheduler
    from repro_torch.serving.pager import PagedKVCache, PagerConfig

    device = resolve_device(device)
    cache = PagedKVCache(PagerConfig(page_size=64, n_pages=64, kv_heads=8,
                                     head_dim=128, weights=(2, 1)),
                         device=device)
    kv = torch.zeros((544, 8, 128), dtype=torch.bfloat16, device=device)
    seqs = list(range(4))
    for s in seqs:
        cache.allocate(s)
        cache.append(s, kv, kv)
    rows, mean = [], {}
    for label, prio in (("egalitarian", 0), ("prioritized", None)):
        sched = DecodeScheduler(cache, background=_bulk_background(),
                                step_time=100e-6, priority=prio)
        ds = sched.schedule(seqs, 16)
        mean[label] = ds.mean_completion
        rows.append(Row(f"qos_decode/{label}", ds.mean_completion * 1e6,
                        f"first_admit_us="
                        f"{min(ds.admit_time.values()) * 1e6:.1f};"
                        f"makespan_us={ds.makespan * 1e6:.1f}"))
    rows.append(Row("qos_decode/improvement", 0.0,
                    f"x={mean['egalitarian'] / mean['prioritized']:.3f}"))
    return rows


ALL_QOS = [qos_single_flow_anchor, qos_weighted_split, qos_priority_shield,
           qos_prefetch_eta, qos_decode_admission]


def qos_summary() -> dict:
    """The BENCH_qos.json payload: last-page prefetch ETA per DMA class
    under one bulk background, plus the uncontended closed-form anchor."""
    plans = _eta_plans()
    s = get_system("tpu_v5e")
    nbytes = 64 * MiB
    r = simulate(s.fabric, [Flow("anchor", "host_dram", "chip0", nbytes,
                                 weight=3.0, priority=2)])[0]
    cf = single_flow_time(s.fabric, "host_dram", "chip0", nbytes)
    ega = plans["egalitarian"]
    return {
        "family": "qos",
        "system": "tpu_v5e",
        "scenario": {"pages": N_PAGES, "page_bytes": PAGE_BYTES,
                     "background_bytes": BULK_BYTES},
        "last_page_eta_s": {lbl: p.total_time for lbl, p in plans.items()},
        "effective_bw_GiB_s": {lbl: p.effective_bw / GiB
                               for lbl, p in plans.items()},
        "eta_improvement": round(
            ega.total_time / plans["prioritized"].total_time, 3),
        "weighted_eta_improvement": round(
            ega.total_time / plans["weighted_w4"].total_time, 3),
        "single_flow_anchor": {
            "sim_s": r.duration, "closed_form_s": cf,
            "rel_err": abs(r.duration - cf) / cf,
        },
    }
