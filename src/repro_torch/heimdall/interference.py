"""HEIMDALL interference benchmark family — fabric-simulated.

The port of the reference's ``repro/heimdall/interference.py``: the same
rows, every number a simulation on a preset, never a measurement of the
card.

The paper's microbenchmarks characterize each tier in isolation; this family
characterizes the *fabric*: what co-running traffic does to a flow on a
shared link. Rows come from the discrete-event simulator over the Table 1
system presets (deterministic, no hardware needed), so the same CSV schema
carries both measured and simulated numbers.

Row names all start with ``interference_``.
"""

from __future__ import annotations

from repro_torch.fabric.contention import Flow
from repro_torch.fabric.scenarios import (bidirectional_fight,
                                    noisy_neighbor_pool,
                                    offload_vs_prefetch)
from repro_torch.fabric.sim import simulate, single_flow_time
from repro_torch.fabric.systems import SYSTEMS, get_system
from repro_torch.heimdall.harness import Row

GiB = 1 << 30


def interference_single_flow_anchor() -> list:
    """Sim vs closed form for one uncontended flow on every preset — the
    calibration anchor (must agree; the contended rows build on it)."""
    rows = []
    nbytes = 64 << 20
    for name in sorted(SYSTEMS):
        s = get_system(name)
        for tier, node in sorted(s.tier_map.items()):
            if node == s.compute:
                continue
            t_sim = simulate(s.fabric,
                             [Flow("f", node, s.compute, nbytes)])[0].duration
            t_cf = single_flow_time(s.fabric, node, s.compute, nbytes)
            rows.append(Row(
                f"interference_anchor/{name}/{tier}", t_sim * 1e6,
                f"GiB_s={nbytes / GiB / t_sim:.2f};"
                f"closed_form_err={abs(t_sim - t_cf) / t_cf:.4f}"))
    return rows


def interference_noisy_neighbor() -> list:
    """Victim bandwidth on a shared CXL pool as neighbors join (the pooled
    memory noisy-neighbor curve)."""
    rows = []
    nbytes = 256 << 20
    for n in (0, 1, 2, 4):
        sc = noisy_neighbor_pool(max(n, 1), nbytes=nbytes) if n else None
        if n == 0:
            s = get_system("cxl_pool")
            t = simulate(s.fabric,
                         [Flow("victim", "pool_mem", "host0",
                               nbytes)])[0].duration
            slow = 1.0
        else:
            r = sc.result("victim")
            t, slow = r.duration, sc.slowdown["victim"]
        rows.append(Row(f"interference_noisy_neighbor/n={n}", t * 1e6,
                        f"GiB_s={nbytes / GiB / t:.2f};slowdown={slow:.2f}x"))
    return rows


def interference_offload_vs_prefetch() -> list:
    """Weight-offload stream vs latency-critical KV prefetch on the shared
    chip<->host PCIe link (why the pager schedules, not just issues)."""
    sc = offload_vs_prefetch()
    rows = []
    for r in sc.results:
        fid = r.flow.id
        rows.append(Row(
            f"interference_offload_prefetch/{fid}", r.duration * 1e6,
            f"GiB_s={r.flow.nbytes / GiB / r.duration:.2f};"
            f"slowdown={sc.slowdown[fid]:.2f}x"))
    return rows


def interference_bidirectional() -> list:
    """Read/write fight on a half-duplex DDR bus vs full-duplex CXL."""
    sc = bidirectional_fight()
    return [Row(f"interference_bidirectional/{r.flow.id}",
                r.duration * 1e6,
                f"slowdown={sc.slowdown[r.flow.id]:.2f}x")
            for r in sc.results]


def interference_loaded_bandwidth() -> list:
    """Effective probe bandwidth chip->host under 0..3 background streams
    (the Fig 6-style loaded curve, per-flow rather than per-tier)."""
    from repro_torch.transport import Route
    rows = []
    s = get_system("tpu_v5e")
    route = Route.resolve(s, "host_dram", "chip0")
    for n_bg in (0, 1, 2, 3):
        bg = [Flow(f"bg{i}", "host_dram", "chip0") for i in range(n_bg)]
        bw = route.effective_bandwidth(bg)
        rows.append(Row(f"interference_loaded_bw/bg={n_bg}", 0.0,
                        f"GiB_s={bw / GiB:.2f}"))
    return rows


ALL_INTERFERENCE = [interference_single_flow_anchor,
                    interference_noisy_neighbor,
                    interference_offload_vs_prefetch,
                    interference_bidirectional,
                    interference_loaded_bandwidth]
