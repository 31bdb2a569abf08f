"""disagg benchmark family — disaggregated prefill/decode over the fabric.

The port of the reference's ``repro/heimdall/disagg.py``: the same rows and
summary, every time a simulation on a preset; each run's decode-node pager
holds its pools on ``device`` (default ``cuda``).

The claim under test: shipping freshly
prefilled KV pages to a separate decode node *overlapped* with decode
admission beats the synchronous handoff (wait for every page, then
decode) by >= ``MIN_OVERLAP_SPEEDUP`` on the pooled-memory presets, with
every sequence meeting its SLO deadline. Rows:

  * ``disagg_overlap``      — the headline: overlapped vs synchronous
                              handoff on ``cxl_pool`` and ``tpu_v5e``,
                              quiet and with a best-effort co-tenant
                              stream on the shared fabric.
  * ``disagg_eta_deadline`` — per-sequence shipped-page ETA vs its SLO
                              completion deadline (the slack the decode
                              node actually has), contended headline run.
  * ``disagg_route_choice`` — the transport layer's staging decision:
                              nominal ICI ships HBM->HBM direct; with the
                              chip link degraded 1000x the cost model
                              re-routes through host DRAM.
  * ``disagg_compressed_ship`` — fp16 vs int8 wire bytes on the ship path
                              (the pager's cold-tier compression applied
                              cross-host).

``disagg_summary()`` condenses the family into the reference's
``BENCH_disagg.json`` schema.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.heimdall.harness import Row
from repro_torch.models.context import resolve_device

# Threshold BENCH_disagg.json is held to: overlapped shipment must beat
# the synchronous handoff by this factor on the contended headline run.
MIN_OVERLAP_SPEEDUP = 1.2

GiB = 1 << 30

# Best-effort co-tenant stream per system, contending with the ship route
# on a shared link (cxl_pool: the switch->host0 downlink; tpu_v5e: the
# chip1->chip0 ICI hop).
def _background(system: str) -> tuple:
    from repro_torch.fabric.contention import Flow
    if system == "cxl_pool":
        return (Flow("co_tenant", "pool_mem", "host0"),)
    if system == "tpu_v5e":
        return (Flow("collective", "chip1", "chip0"),)
    return ()


@functools.lru_cache(maxsize=None)
def _run(device: torch.device, system: str = "cxl_pool", kv_dtype=None,
         contended: bool = True, ship_priority: int = 1):
    from repro_torch.serving.disagg import DisaggConfig, run_disagg_serve
    cfg = DisaggConfig(system=system, kv_dtype=kv_dtype,
                       ship_priority=ship_priority,
                       background=_background(system) if contended else ())
    return run_disagg_serve(cfg, device=device)


@functools.lru_cache(maxsize=2)
def _run_degraded_ici(device: torch.device):
    """tpu_v5e with the chip<->chip ICI link collapsed 1000x — the regime
    where bouncing HBM pages through host DRAM wins."""
    from repro_torch.fabric.systems import get_system
    from repro_torch.serving.disagg import DisaggConfig, run_disagg_serve
    s = get_system("tpu_v5e")
    deg = dataclasses.replace(
        s, fabric=s.fabric.rescaled({("chip0", "chip1"): (0.001, 1.0)},
                                    name="tpu_v5e+ici_degraded"))
    return run_disagg_serve(DisaggConfig(system="tpu_v5e"), system=deg,
                            device=device)


def disagg_overlap(device=None) -> list:
    """Overlapped vs synchronous handoff: quiet, contended in the
    high-priority ship class (QoS protects the ETAs — same numbers as
    quiet), and contended egalitarian (the link is actually split)."""
    device = resolve_device(device)
    rows = []
    variants = (("quiet", False, 1), ("contended", True, 1),
                ("contended_egalitarian", True, 0))
    for system in ("cxl_pool", "tpu_v5e"):
        for label, contended, prio in variants:
            rep = _run(device, system, None, contended, prio)
            sched = rep.schedule
            rows.append(Row(
                f"disagg_overlap/{system}/{label}",
                sched.mean_completion * 1e6,
                f"speedup={rep.overlap_speedup:.3f}x;"
                f"sync_us={sched.sync_makespan * 1e6:.1f};"
                f"violations={len(sched.violations)}"))
    return rows


def disagg_eta_deadline(device=None) -> list:
    """Per-sequence last-page ETA vs SLO deadline (contended headline)."""
    rep = _run(resolve_device(device), "cxl_pool", None, True)
    sched = rep.schedule
    rows = []
    for s in sorted(rep.ready):
        slack = rep.deadlines[s] - sched.finish_time[s]
        rows.append(Row(
            f"disagg_eta_deadline/seq{s}", rep.ready[s] * 1e6,
            f"deadline_us={rep.deadlines[s] * 1e6:.1f};"
            f"slack_us={slack * 1e6:.1f};"
            f"violated={int(s in sched.violations)}"))
    return rows


def disagg_route_choice(device=None) -> list:
    """Staging decision: direct ICI ship vs host-DRAM bounce when the
    chip link collapses."""
    device = resolve_device(device)
    rows = []
    for label, rep in (("nominal", _run(device, "tpu_v5e", None, False)),
                       ("ici_x0.001", _run_degraded_ici(device))):
        c = rep.choice
        rows.append(Row(
            f"disagg_route_choice/{label}", c.est_time * 1e6,
            f"staging={c.staging or 'direct'};path={c.route.label};"
            f"bottleneck_GiB_s={c.route.bottleneck_bw / GiB:.2f}"))
    return rows


def disagg_compressed_ship(device=None) -> list:
    """fp16 vs int8 ship on the contended cxl_pool route."""
    device = resolve_device(device)
    fp = _run(device, "cxl_pool", None, True)
    q = _run(device, "cxl_pool", "int8", True)
    rows = []
    for label, rep in (("fp16", fp), ("int8", q)):
        rows.append(Row(
            f"disagg_compressed_ship/{label}",
            rep.schedule.mean_completion * 1e6,
            f"wire_MiB={rep.plan.wire_bytes / (1 << 20):.1f};"
            f"speedup={rep.overlap_speedup:.3f}x"))
    rows.append(Row(
        "disagg_compressed_ship/reduction", 0.0,
        f"bytes_reduction="
        f"{fp.plan.wire_bytes / max(q.plan.wire_bytes, 1):.3f}x"))
    return rows


def disagg_summary(device=None) -> dict:
    """The BENCH_disagg.json payload: headline contended overlap speedup
    on cxl_pool (>= MIN_OVERLAP_SPEEDUP, zero deadline violations), with
    the quiet/tpu runs, route-choice flip, and compressed-ship reduction
    riding along."""
    device = resolve_device(device)
    head = _run(device, "cxl_pool", None, True)
    quiet = _run(device, "cxl_pool", None, False)
    tpu = _run(device, "tpu_v5e", None, True)
    deg = _run_degraded_ici(device)
    q = _run(device, "cxl_pool", "int8", True)
    return {
        "family": "disagg",
        "system": "cxl_pool",
        "headline": head.to_json(),
        "overlap_speedup": round(head.overlap_speedup, 3),
        "deadline_violations": len(head.schedule.violations),
        "quiet_overlap_speedup": round(quiet.overlap_speedup, 3),
        "tpu_overlap_speedup": round(tpu.overlap_speedup, 3),
        "route_choice": {
            "nominal_staging": _run(device, "tpu_v5e", None,
                                    False).choice.staging,
            "degraded_staging": deg.choice.staging,
            "degraded_path": deg.choice.route.label,
        },
        "compressed_ship": {
            "fp16_wire_bytes": head.plan.wire_bytes,
            "int8_wire_bytes": q.plan.wire_bytes,
            "bytes_reduction": round(
                head.plan.wire_bytes / max(q.plan.wire_bytes, 1), 3),
            "int8_overlap_speedup": round(q.overlap_speedup, 3),
        },
        "thresholds": {"overlap_speedup_min": MIN_OVERLAP_SPEEDUP,
                       "deadline_violations_max": 0},
    }


ALL_DISAGG = [disagg_overlap, disagg_eta_deadline, disagg_route_choice,
              disagg_compressed_ship]
