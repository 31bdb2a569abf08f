"""Discrete-event transfer simulator over the fabric graph.

The port's copy of the reference's ``repro/fabric/sim.py``.

Fluid-flow model: at any instant every active flow moves bytes at its
QoS-aware max-min fair rate (repro.fabric.contention: strict priority
between classes, weighted water-filling within one); events are flow
arrivals and completions, and rates are recomputed at each event — the
standard processor-sharing fluid approximation a full-system simulator like
Cohet calibrates against hardware. A single uncontended flow therefore
finishes in exactly ``nbytes / route_bandwidth + route_latency`` — the
closed form ``costmodel.transfer_time`` — whatever its class, while
concurrent flows stretch each other out through shared links according to
their weights and priorities.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from repro_torch.fabric.contention import Flow, max_min_rates
from repro_torch.fabric.topology import FabricLink, FabricTopology
from repro_torch.obs.timeline import LINK_CAT, LINK_META_CAT
from repro_torch.obs.trace import NULL_TRACER

_EPS_BYTES = 1e-6


def link_label(link: FabricLink) -> str:
    """Human-readable identity of the physical link a trace track shows.

    Duplex directions are distinct resources (distinct tracks); a
    half-duplex pair collapses onto one shared track, mirroring
    ``FabricLink.physical_id``.
    """
    a, b, lt = link.physical_id
    arrow = "->" if link.duplex else "<->"
    return f"{a}{arrow}{b}:{lt}"


@dataclasses.dataclass(frozen=True)
class FlowResult:
    flow: Flow
    finish: float                # seconds (absolute, includes route latency)

    @property
    def duration(self) -> float:
        return self.finish - self.flow.start

    @property
    def achieved_bandwidth(self) -> float:
        """Mean bytes/s over the flow's lifetime (latency included)."""
        return self.flow.nbytes / max(self.duration, 1e-18)


def _validate(topo: FabricTopology, flows: Sequence[Flow]) -> dict:
    """Up-front input validation naming the offending flow/link.

    A flow that can *never* make progress (zero demand, a zero-bandwidth
    link on its route) is a modeling error and must be rejected here; a
    flow that is merely rate-starved by higher-priority classes is fine —
    it waits in the event loop until capacity frees up.
    """
    ids = [f.id for f in flows]
    if len(set(ids)) != len(ids):
        dupes = sorted({i for i in ids if ids.count(i) > 1})
        raise ValueError(f"duplicate flow ids {dupes}; the event engine "
                         "keys state by flow id, so duplicates would "
                         "silently merge")
    routes = {}
    for f in flows:
        if f.nbytes <= 0:
            raise ValueError(f"flow {f.id!r} needs nbytes > 0 to simulate "
                             "(open-ended streams belong to the "
                             "steady-state functions in contention.py)")
        if f.demand <= 0:
            raise ValueError(f"flow {f.id!r} has demand {f.demand}; a "
                             "zero-demand flow can never finish — cap with "
                             "a positive rate or drop the flow")
        routes[f.id] = topo.route(f.src, f.dst)
        for link in routes[f.id]:
            if link.bandwidth <= 0:
                raise ValueError(
                    f"flow {f.id!r} routes over zero-bandwidth link "
                    f"{link.src}->{link.dst} ({link.type.value}); it can "
                    "never complete")
    return routes


def simulate(topo: FabricTopology, flows: Sequence[Flow],
             tracer=NULL_TRACER) -> list[FlowResult]:
    """Run all flows to completion; returns results in input order.

    Every flow needs ``nbytes > 0`` (open-ended streams belong to the
    steady-state functions in contention.py, not the event engine). Rates
    honor QoS classes (``Flow.weight``/``Flow.priority``) at every event:
    a flow starved by higher-priority traffic waits at rate 0 and resumes
    the moment the class above it drains.

    With an enabled ``tracer`` (``repro.obs.Tracer``) the run emits, in sim
    time: one async lifecycle span per flow (begin at arrival, a rate
    instant at every arbitration event that changes its rate — rate 0 is a
    starved/queued flow — end when the last byte lands), and one counter
    sample per physical link at every event boundary (fraction-of-capacity
    per QoS class, the per-link utilization timeline
    ``repro.obs.link_timelines`` reconstructs). The default ``NULL_TRACER``
    keeps the event loop byte-identical to the untraced engine.
    """
    routes = _validate(topo, flows)
    lat = {f.id: sum(l.latency for l in routes[f.id]) for f in flows}

    pending = sorted(flows, key=lambda f: (f.start, f.id))
    active: dict[str, Flow] = {}
    remaining: dict[str, float] = {}
    finish: dict[str, float] = {}
    t = pending[0].start if pending else 0.0

    traced = tracer.enabled
    if traced:
        link_cap: dict[tuple, float] = {}     # physical id -> capacity
        link_lbl: dict[tuple, str] = {}
        flow_pids: dict[str, tuple] = {}
        for f in flows:
            pids = []
            for link in routes[f.id]:
                pid = link.physical_id
                if pid not in link_cap:
                    link_cap[pid] = link.bandwidth
                    link_lbl[pid] = link_label(link)
                    tracer.instant(
                        "link", ts=t,
                        track=("fabric", f"link {link_lbl[pid]}"),
                        cat=LINK_META_CAT, link=link_lbl[pid],
                        capacity=link.bandwidth)
                pids.append(pid)
            flow_pids[f.id] = tuple(pids)
        last_rate: dict[str, float] = {}
        last_util: dict[tuple, dict] = {}
        # metrics are accumulated locally and flushed once after the loop:
        # MetricsRegistry.add's label-key formatting is too slow to sit in
        # the per-admission path (it shows up in tracer-overhead numbers)
        link_bytes: dict[tuple, float] = {}
        n_completed = 0

    while pending or active:
        while pending and pending[0].start <= t + 1e-18:
            f = pending.pop(0)
            if not routes[f.id]:          # src == dst: no link to cross
                finish[f.id] = f.start
                continue
            active[f.id] = f
            remaining[f.id] = float(f.nbytes)
            if traced:
                # links: the route's physical link labels, so consumers
                # (obs.attribution) can charge this flow's wait to its
                # bottleneck link without re-resolving the route
                tracer.async_begin(
                    f.id, id=f.id, ts=f.start, track=("fabric", "flows"),
                    cat="flow", src=f.src, dst=f.dst, nbytes=f.nbytes,
                    priority=f.priority, weight=f.weight,
                    links=[link_lbl[pid] for pid in flow_pids[f.id]])
                for pid in flow_pids[f.id]:
                    link_bytes[pid] = link_bytes.get(pid, 0.0) + f.nbytes
        if not active:
            if not pending:                 # only zero-hop flows remained
                break
            t = pending[0].start            # idle gap before next arrival
            continue
        rates = max_min_rates(topo, list(active.values()),
                              {fid: routes[fid] for fid in active})
        if traced:
            # Flow lifecycle: a rate instant per arbitration-driven change.
            for fid, f in active.items():
                r = rates[fid]
                if last_rate.get(fid) != r:
                    last_rate[fid] = r
                    tracer.async_instant(fid, id=fid, ts=t,
                                         track=("fabric", "flows"),
                                         cat="flow", rate_bytes_per_s=r)
            # Utilization sample per physical link: fraction of capacity
            # per QoS class; series present earlier are re-emitted as 0 so
            # the piecewise-constant timeline (and Perfetto's counter
            # tracks) never hold a stale value.
            util: dict[tuple, dict] = {}
            for fid, f in active.items():
                frac = rates[fid]
                cls = f"p{f.priority}"
                for pid in flow_pids[fid]:
                    u = util.setdefault(pid, {})
                    u[cls] = u.get(cls, 0.0) + frac / link_cap[pid]
            for pid in link_cap:
                cur = util.get(pid, {})
                prev = last_util.get(pid)
                if not cur and prev is None:
                    continue            # idle link, nothing sampled yet
                if prev:
                    cur = {**{k: 0.0 for k in prev}, **cur}
                if cur != prev:
                    last_util[pid] = cur
                    tracer.counter(
                        link_lbl[pid], cur, ts=t,
                        track=("fabric", f"link {link_lbl[pid]}"),
                        cat=LINK_CAT)
        next_arrival = pending[0].start if pending else math.inf
        t_done = min(t + remaining[fid] / rates[fid] if rates[fid] > 0
                     else math.inf for fid in active)
        t_next = min(next_arrival, t_done)
        if math.isinf(t_next):
            # Unreachable after _validate: the highest-priority active
            # class always makes progress on positive-bandwidth links.
            starved = sorted(fid for fid in active if rates[fid] <= 0)
            raise RuntimeError(
                "simulation stalled: no active flow progresses and none "
                f"arrive (zero-rate flows: {starved}); this is an engine "
                "invariant violation — please report the topology/flows")
        dt = t_next - t
        for fid in list(active):
            if rates[fid] > 0:
                remaining[fid] -= rates[fid] * dt
            if remaining[fid] <= _EPS_BYTES:
                finish[fid] = t_next + lat[fid]
                if traced:
                    f = active[fid]
                    tracer.async_end(
                        fid, id=fid, ts=finish[fid],
                        track=("fabric", "flows"), cat="flow",
                        drained_ts=t_next,
                        duration=finish[fid] - f.start,
                        achieved_bw=f.nbytes
                        / max(finish[fid] - f.start, 1e-18))
                    n_completed += 1
                del active[fid], remaining[fid]
        t = t_next
        if traced and not active:
            # Idle gap (or drain): utilization is zero from here until the
            # next arrival — without this sample the timeline would hold
            # the last nonzero value across the gap and over-integrate.
            _emit_zero_util(tracer, link_lbl, last_util, t)

    if traced:
        # Close every link's timeline with a bounding all-zero sample.
        for pid in link_cap:
            last_util.setdefault(pid, None)
        _emit_zero_util(tracer, link_lbl, last_util, t)
        for pid, nb in link_bytes.items():
            tracer.metrics.add("fabric.link.bytes", nb, link=link_lbl[pid])
        if n_completed:
            tracer.metrics.add("fabric.flows.completed", n_completed)

    return [FlowResult(f, finish[f.id]) for f in flows]


def _emit_zero_util(tracer, link_lbl: dict, last_util: dict,
                    ts: float) -> None:
    """Emit an all-zero utilization sample for every link whose last
    emitted sample was not already all-zero (``None`` = never sampled)."""
    for pid, prev in last_util.items():
        if prev is not None and not any(prev.values()):
            continue
        zero = {k: 0.0 for k in prev} if prev else {"p0": 0.0}
        last_util[pid] = zero
        tracer.counter(link_lbl[pid], zero, ts=ts,
                       track=("fabric", f"link {link_lbl[pid]}"),
                       cat=LINK_CAT)


def makespan(results: Sequence[FlowResult]) -> float:
    return max(r.finish for r in results) if results else 0.0


def single_flow_time(topo: FabricTopology, src: str, dst: str,
                     nbytes: int) -> float:
    """Closed form an uncontended sim run must reproduce (sanity anchor)."""
    return nbytes / topo.route_bandwidth(src, dst) \
        + topo.route_latency(src, dst)
