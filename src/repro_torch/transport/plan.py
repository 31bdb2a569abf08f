"""Transfer vocabulary + the one planner wrapping the fabric simulator.

The port's copy of the reference's ``repro/transport/plan.py``.

``PageTransfer`` separates what a transfer *means* (logical bytes) from
what it *costs* (wire bytes after ``kv_dtype`` compression) and carries its
DMA QoS class and deadline. ``plan_transfers`` turns a batch of them into a
``TransferPlan`` by simulating chained flows on the route's fabric against
background traffic — the exact semantics the pager's prefetch planner
always had (one DMA queue: each flow staggered behind the previous one's
contended estimate), now shared by prefetch, host-to-host page shipping,
and recovery migration.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

from repro_torch.obs.trace import NULL_TRACER
from repro_torch.transport.route import Route


@dataclasses.dataclass(frozen=True)
class PageTransfer:
    """One payload to move: logical bytes + wire compression + QoS class.

    ``nbytes`` is the *logical* size (what the consumer sees);
    ``compression`` > 1 models transfer-compressed payloads (int8 KV
    pages), so ``wire_bytes`` is what actually crosses the link.
    ``start`` is the earliest sim time the transfer may begin (e.g. when
    prefill produced the page); ``deadline`` is the consumer's SLO, checked
    by ``TransferPlan.violations``.
    """
    id: object                    # caller's key (page id, seq id, ...)
    nbytes: int                   # logical bytes
    compression: float = 1.0
    weight: float = 1.0
    priority: int = 0
    start: float = 0.0
    deadline: Optional[float] = None

    def __post_init__(self):
        if self.compression <= 0:
            raise ValueError(
                f"compression must be > 0, got {self.compression}")
        if self.nbytes <= 0:
            raise ValueError(f"nbytes must be > 0, got {self.nbytes}")

    @property
    def wire_bytes(self) -> int:
        """Bytes on the wire after compression (>= 1)."""
        return max(1, round(self.nbytes / self.compression))


@dataclasses.dataclass(frozen=True)
class TransferPlan:
    """Simulated schedule of a transfer batch over one route."""
    route: Route
    transfers: tuple              # PageTransfers in planned (issue) order
    eta: dict                     # transfer id -> arrival time (s)
    total_time: float             # when the last transfer lands (s)
    effective_bw: float           # contended wire bandwidth probed (B/s)

    @property
    def order(self) -> tuple:
        return tuple(t.id for t in self.transfers)

    @property
    def logical_bytes(self) -> int:
        return sum(t.nbytes for t in self.transfers)

    @property
    def wire_bytes(self) -> int:
        return sum(t.wire_bytes for t in self.transfers)

    def ready_by(self, deadline: float) -> list:
        """Transfer ids landed if the consumer fires at ``deadline``."""
        return [t.id for t in self.transfers if self.eta[t.id] <= deadline]

    @property
    def violations(self) -> dict:
        """Transfer id -> overrun (s) past its own deadline (transfers
        without a deadline never appear)."""
        return {t.id: self.eta[t.id] - t.deadline for t in self.transfers
                if t.deadline is not None and self.eta[t.id] > t.deadline}


def plan_transfers(route: Route, transfers: Sequence, *,
                   background: Sequence = (), chained: bool = True,
                   background_nbytes: Optional[int] = None,
                   flow_prefix: str = "page",
                   probe_weight: Optional[float] = None,
                   probe_priority: Optional[int] = None,
                   tracer=NULL_TRACER) -> TransferPlan:
    """Simulate ``transfers`` over ``route`` against ``background`` flows.

    ``chained`` (the default) models a single DMA queue: each transfer's
    flow starts no earlier than the previous one's *contended estimate*
    finishes (``wire_bytes / effective_bw + latency``), then the
    discrete-event sim resolves actual ETAs against the background.
    ``chained=False`` issues every flow at its own ``start`` (parallel
    queues).

    Open-ended background flows (``nbytes == 0``, "a stream that outlives
    the plan") cannot enter the event engine, so they are materialized at
    ``background_nbytes`` — by default the plan's own total wire bytes,
    i.e. the background is assumed to stream for at least as long as the
    plan moves data. Pass an explicit size to model shorter or longer
    co-tenants.

    Raises ``ValueError`` for unresolvable background endpoints or invalid
    flows (duplicate transfer ids become duplicate flow ids, which the sim
    rejects). Metrics (when tracing): ``transport.transfers`` /
    ``transport.wire_bytes`` / ``transport.logical_bytes`` labeled by
    route and provenance; the sim tracer emits per-flow lifecycles and
    per-link utilization as always.
    """
    transfers = tuple(transfers)
    bg = route._resolve_flows(background)
    # The contended-rate probe (used for chained stagger and reported as
    # effective_bw) runs in the plan's QoS class: the first transfer's by
    # default, or an explicit probe class for empty plans / mixed batches.
    probe_w = (probe_weight if probe_weight is not None
               else transfers[0].weight if transfers else 1.0)
    probe_p = (probe_priority if probe_priority is not None
               else transfers[0].priority if transfers else 0)
    eff = route.effective_bandwidth(bg, weight=probe_w, priority=probe_p)
    if not transfers:
        return TransferPlan(route, (), {}, 0.0, eff)

    from repro_torch.fabric.contention import Flow
    from repro_torch.fabric.sim import simulate

    lat = route.latency
    flows = []
    prev_end = None
    for tr in transfers:
        est = (tr.wire_bytes / eff + lat
               if eff > 0 and math.isfinite(eff) else lat)
        start = tr.start
        if chained and prev_end is not None:
            start = max(start, prev_end)
        prev_end = start + est
        flows.append(Flow(f"{flow_prefix}{tr.id}", route.src, route.dst,
                          tr.wire_bytes, start=start, weight=tr.weight,
                          priority=tr.priority))
    total_wire = sum(t.wire_bytes for t in transfers)
    autosize = (background_nbytes if background_nbytes is not None
                else total_wire)
    bg_sized = [f if f.nbytes > 0
                else dataclasses.replace(f, nbytes=autosize) for f in bg]
    results = simulate(route.fabric, flows + bg_sized, tracer=tracer)
    # Key ETAs by flow id — simulate() documents input-order results, but
    # positional zip silently breaks the moment flow construction changes.
    by_id = {r.flow.id: r for r in results}
    eta = {tr.id: by_id[f"{flow_prefix}{tr.id}"].finish
           for tr in transfers}
    plan = TransferPlan(route, transfers, eta, max(eta.values()), eff)
    if tracer.enabled:
        m = tracer.metrics
        m.add("transport.transfers", len(transfers), route=route.label,
              provenance=route.provenance)
        m.add("transport.wire_bytes", total_wire, route=route.label,
              provenance=route.provenance)
        m.add("transport.logical_bytes", plan.logical_bytes,
              route=route.label, provenance=route.provenance)
    return plan
