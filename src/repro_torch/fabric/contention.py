"""Shared-link bandwidth sharing and loaded latency over routed flows.

The port's copy of the reference's ``repro/fabric/contention.py``.

CXL-Interference's core observation: co-running traffic on a shared link
degrades each flow super-linearly vs the naive 1/n split once latency is
accounted for — and the degradation is *class-dependent*: latency-critical
reads suffer disproportionately under bulk streams unless the link
arbitrates. The model here is two-layer:

  1. **Rates** — weighted max-min sharing (weighted water-filling) over
     every physical link a set of routed flows crosses, with strict
     priority between classes (DMA QoS): all capacity goes to the highest
     ``Flow.priority`` present on a link first; each class then splits its
     residual in proportion to ``Flow.weight``. Default weight=1/priority=0
     degenerates to the egalitarian max-min of the original model.
     Full-duplex links give each direction its own capacity; half-duplex
     links (DDR bus) pool both directions, so a read and a write fight.
  2. **Latency** — ``loaded_latency_multi``: the M/M/1-shaped blow-up of
     ``costmodel.loaded_latency`` generalized to the *aggregate* utilization
     a flow's bottleneck link sees from all sharers.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

from repro_torch.fabric.topology import FabricLink, FabricTopology

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class Flow:
    """One transfer (or steady stream) between two fabric nodes.

    QoS class: ``priority`` arbitrates strictly (a higher-priority flow
    takes everything it can use before lower classes see a byte — the DMA
    engine's high-priority queue); ``weight`` splits bandwidth *within* a
    priority class proportionally (weighted interleave of the DMA queues).
    The defaults make every flow one egalitarian class.
    """
    id: str
    src: str
    dst: str
    nbytes: int = 0              # 0 = open-ended stream (steady state)
    start: float = 0.0           # seconds (used by fabric.sim)
    demand: float = math.inf     # optional rate cap, bytes/s
    weight: float = 1.0          # share within the priority class
    priority: int = 0            # higher = served first (strict)


def _routes(topo: FabricTopology,
            flows: Sequence[Flow]) -> dict[str, list[FabricLink]]:
    return {f.id: topo.route(f.src, f.dst) for f in flows}


def max_min_rates(topo: FabricTopology, flows: Sequence[Flow],
                  routes: Optional[dict] = None) -> dict[str, float]:
    """QoS-aware max-min fair rate (bytes/s) per flow over the fabric.

    Strict priority between classes, weighted water-filling within one:
    flows are grouped by ``Flow.priority`` (higher first); each class runs
    weighted progressive filling — every unfrozen flow's rate rises in
    proportion to its ``Flow.weight`` until a link's *residual* capacity
    (what higher classes left behind) saturates or the flow hits its
    demand cap; flows crossing a saturated link freeze; repeat. With the
    default weight=1/priority=0 this is exactly egalitarian max-min.
    A flow whose route is empty (src == dst) gets infinite rate; a flow
    starved by higher-priority classes gets rate 0 (it waits, it does not
    error).
    """
    ids = [f.id for f in flows]
    if len(set(ids)) != len(ids):
        raise ValueError(f"duplicate flow ids in {ids}")
    for f in flows:
        if not (f.weight > 0 and math.isfinite(f.weight)):
            raise ValueError(f"flow {f.id!r} has weight {f.weight}; "
                             "weights must be finite and > 0")
    routes = routes if routes is not None else _routes(topo, flows)

    capacity: dict[tuple, float] = {}
    users: dict[tuple, set] = {}
    for f in flows:
        for link in routes[f.id]:
            pid = link.physical_id
            capacity[pid] = link.bandwidth
            users.setdefault(pid, set()).add(f.id)

    rates = {f.id: (math.inf if not routes[f.id] else 0.0) for f in flows}
    demand = {f.id: f.demand for f in flows}
    weight = {f.id: f.weight for f in flows}

    # Strict priority: fill the highest class first; every lower class sees
    # only the residual capacity the classes above it left on each link.
    for prio in sorted({f.priority for f in flows if routes[f.id]},
                       reverse=True):
        unfrozen = {f.id for f in flows
                    if routes[f.id] and f.priority == prio}
        while unfrozen:
            # Max water-level increment (rate_f rises at weight_f per unit)
            # before some shared link saturates or a flow hits its demand.
            inc = math.inf
            for pid, cap in capacity.items():
                active = users[pid] & unfrozen
                if active:
                    residual = cap - sum(rates[u] for u in users[pid])
                    wsum = sum(weight[u] for u in active)
                    inc = min(inc, max(0.0, residual) / wsum)
            for fid in unfrozen:
                inc = min(inc, (demand[fid] - rates[fid]) / weight[fid])
            if not math.isfinite(inc):      # no shared constraint at all
                break
            for fid in unfrozen:
                rates[fid] += weight[fid] * inc
            newly_frozen = set()
            for pid, cap in capacity.items():
                if (users[pid] & unfrozen
                        and cap - sum(rates[u] for u in users[pid])
                        <= _EPS * cap):
                    newly_frozen |= users[pid] & unfrozen
            for fid in unfrozen:
                if rates[fid] >= demand[fid] - _EPS * max(1.0, weight[fid]):
                    newly_frozen.add(fid)
            if not newly_frozen:        # numerical guard; shouldn't happen
                break
            unfrozen -= newly_frozen
    return rates


def effective_bandwidth(topo: FabricTopology, src: str, dst: str,
                        background: Sequence[Flow] = (), *,
                        weight: float = 1.0, priority: int = 0) -> float:
    """Bandwidth a probe flow src->dst achieves alongside background flows.

    ``weight``/``priority`` are the probe's QoS class (default: egalitarian
    best-effort). With no background this is exactly
    ``topo.route_bandwidth(src, dst)`` regardless of class.
    """
    probe = Flow("__probe__", src, dst, weight=weight, priority=priority)
    rates = max_min_rates(topo, [probe, *background])
    bw = rates["__probe__"]
    return topo.route_bandwidth(src, dst) if math.isinf(bw) else bw


def loaded_latency_multi(capacity: float, base_latency: float,
                         flow_bws: Sequence[float]) -> float:
    """M/M/1-shaped loaded latency under multiple co-running flows.

    Generalizes ``costmodel.loaded_latency`` from one achieved bandwidth to
    the aggregate of all sharers: u = sum(flow_bws)/capacity, latency =
    base/(1-u). The paper's CXL expanders hit 1700-3300 ns at saturation vs
    ~300 ns unloaded — that is this curve near u->1.
    """
    if capacity <= 0:
        raise ValueError("capacity must be positive")
    u = min(sum(flow_bws) / capacity, 0.999)
    return base_latency / (1.0 - u)


def route_loaded_latency(topo: FabricTopology, flows: Sequence[Flow],
                         flow_id: str,
                         rates: Optional[dict] = None) -> float:
    """Loaded end-to-end latency one flow sees: per-link M/M/1 blow-up from
    the aggregate traffic crossing each physical link on its route."""
    routes = _routes(topo, flows)
    if flow_id not in routes:
        raise ValueError(f"unknown flow {flow_id!r}")
    rates = rates if rates is not None else max_min_rates(topo, flows,
                                                          routes)
    load: dict[tuple, float] = {}
    for f in flows:
        r = rates[f.id]
        if not math.isfinite(r):
            continue
        for link in routes[f.id]:
            pid = link.physical_id
            load[pid] = load.get(pid, 0.0) + r
    total = 0.0
    for link in routes[flow_id]:
        total += loaded_latency_multi(link.bandwidth, link.latency,
                                      [load.get(link.physical_id, 0.0)])
    return total
