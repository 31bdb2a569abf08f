"""Critical-path attribution: per-request latency broken into named segments.

The port's copy of the reference's ``repro/obs/attribution.py``.

Reconstructs each request's end-to-end path from the events the stack
already emits — no new instrumentation inside the simulators:

  * ``attrib.request`` instants (``launch.serve.admission_schedule`` emits
    one per sequence when given ``seq_flows=``): request id, start time,
    pages-ready time, the flow ids carrying its bytes, and optionally its
    prefill completion (the disaggregated path).
  * flow async lifecycles (cat ``"flow"``, ``fabric.sim.simulate``): begin
    at arrival with the route's physical link labels and QoS class, end
    with ``drained_ts`` (last byte off the wire, before route latency).
  * ``fabric.link.meta`` capacity instants — used to pick each flow's
    bottleneck link.
  * ``sched.admit`` instants and the per-sequence ``seq{N}`` async ends —
    admission and completion times.

The walk charges every moment between request start and finish to exactly
one segment: ``prefill``, ``link_wait:<link>[p<class>]`` (both the transfer
itself and the time queued behind other traffic bound for the same
bottleneck link — on a chained DMA queue the wait *is* for that link),
``transfer_tail`` (route latency after the last byte drains),
``sched_wait`` (resident but not yet admitted by the step grid), and
``decode_compute``. ``RequestAttribution.breakdown()`` ranks them — the
"why was this slow" answer; ``attribution_summary`` aggregates top
contributors across requests (the degraded-link headline check in
``heimdall.obs`` counts exactly this).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

from repro_torch.obs.timeline import LINK_META_CAT

ATTRIB_CAT = "attrib"


@dataclasses.dataclass(frozen=True)
class Segment:
    """One attributed slice of a request's end-to-end latency."""
    label: str                   # e.g. "link_wait:host_dram->chip0:pcie[p1]"
    kind: str                    # prefill|link_wait|link_queue|transfer_tail
    start: float                 # |sched_wait|decode_compute
    end: float

    @property
    def duration(self) -> float:
        return self.end - self.start


@dataclasses.dataclass(frozen=True)
class RequestAttribution:
    """One request's latency, fully attributed to named segments."""
    rid: object
    start: float
    finish: float
    segments: tuple              # Segment, in time order

    @property
    def total(self) -> float:
        return self.finish - self.start

    def breakdown(self) -> dict:
        """label -> attributed seconds, largest first."""
        out: dict[str, float] = {}
        for seg in self.segments:
            out[seg.label] = out.get(seg.label, 0.0) + seg.duration
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    def top(self, n: int = 3) -> list:
        """[(label, seconds, fraction_of_total)] for the top contributors."""
        total = max(self.total, 1e-18)
        return [(lbl, s, s / total)
                for lbl, s in itertools.islice(
                    self.breakdown().items(), n)]

    @property
    def top_contributor(self) -> Optional[str]:
        bd = self.breakdown()
        return next(iter(bd), None)

    def to_json(self) -> dict:
        return {
            "rid": self.rid,
            "start_s": self.start,
            "finish_s": self.finish,
            "total_s": self.total,
            "segments": [{"label": s.label, "kind": s.kind,
                          "start_s": s.start, "end_s": s.end,
                          "duration_s": s.duration}
                         for s in self.segments],
            "breakdown": self.breakdown(),
            "top": self.top_contributor,
        }


# --------------------------------------------------------------------------
# Event-stream helpers (list tracers, ring-buffer tracers, scoped views)
# --------------------------------------------------------------------------


def _sink(tracer):
    """Follow scoped views down to the tracer that owns the event sink."""
    while hasattr(tracer, "_parent"):
        tracer = tracer._parent
    return tracer


def event_cursor(tracer) -> int:
    """Opaque position in a tracer's event stream (see ``events_since``).

    Counts *emitted* events, so it stays valid across ring-buffer drops
    (``FlightRecorder``) — ``len(events)`` alone would not.
    """
    t = _sink(tracer)
    emitted = getattr(t, "emitted", None)
    return emitted if emitted is not None else len(t.events)


def events_since(tracer, cursor: int) -> list:
    """Events emitted after ``cursor`` (an earlier ``event_cursor``).

    On a ring-buffer tracer, events dropped since the cursor are simply
    gone — the slice starts at the oldest retained event.
    """
    t = _sink(tracer)
    evs = t.events
    emitted = getattr(t, "emitted", None)
    if emitted is not None:                     # ring buffer: index by
        start = cursor - (emitted - len(evs))   # emission count
        return list(itertools.islice(evs, max(0, start), None))
    return list(evs[cursor:])


# --------------------------------------------------------------------------
# The critical-path walk
# --------------------------------------------------------------------------


def _bottleneck_label(flow: dict, caps: dict) -> str:
    """The physical link a flow's wait is charged to: the lowest-capacity
    link on its route (falls back to src->dst when the trace predates the
    ``links`` begin-arg)."""
    links = flow.get("links") or ()
    known = [l for l in links if l in caps]
    if known:
        return min(known, key=lambda l: caps[l])
    if links:
        return links[0]
    return f"{flow['src']}->{flow['dst']}"


def attribute_requests(events, *, eps: float = 1e-12) -> dict:
    """{request id: RequestAttribution} from one run's event stream.

    ``events`` is an iterable of ``TraceEvent`` (or a tracer — its
    ``events`` attribute is used). Only requests announced by an
    ``attrib.request`` instant are attributed; a request whose flows were
    dropped from a ring buffer gets a partial but still-consistent
    breakdown (missing flows simply leave their time in the surrounding
    wait segments).
    """
    events = getattr(events, "events", events)
    caps: dict[str, float] = {}
    flows: dict[str, dict] = {}
    reqs: dict = {}
    admit: dict = {}
    finish: dict = {}
    seq_of_async: dict[str, object] = {}
    for ev in events:
        args = ev.args or {}
        if ev.cat == LINK_META_CAT:
            caps[args["link"]] = args["capacity"]
        elif ev.cat == "flow":
            if ev.kind == "b":
                flows[ev.id] = {"start": ev.ts, "src": args.get("src"),
                                "dst": args.get("dst"),
                                "links": args.get("links"),
                                "cls": f"p{args.get('priority', 0)}"}
            elif ev.kind == "e" and ev.id in flows:
                flows[ev.id]["drain"] = args.get("drained_ts", ev.ts)
        elif ev.cat == ATTRIB_CAT and ev.name == "attrib.request":
            reqs[args["rid"]] = {"start": args.get("start", 0.0),
                                 "ready": args.get("ready", 0.0),
                                 "flows": args.get("flows", ()),
                                 "prefill_done": args.get("prefill_done")}
        elif ev.cat == "sched":
            if ev.kind == "i" and ev.name == "sched.admit":
                admit[args["seq"]] = ev.ts
            elif ev.kind == "b" and "seq" in args:
                seq_of_async[ev.id] = args["seq"]
            elif ev.kind == "e" and ev.id in seq_of_async:
                finish[seq_of_async[ev.id]] = ev.ts
    out = {}
    for rid, req in reqs.items():
        start = req["start"]
        cursor = start
        segs: list[Segment] = []
        pd = req["prefill_done"]
        if pd is not None and pd > cursor + eps:
            segs.append(Segment("prefill", "prefill", cursor, pd))
            cursor = pd
        fl = sorted((flows[f] for f in req["flows"]
                     if f in flows and "drain" in flows[f]),
                    key=lambda f: f["start"])
        for f in fl:
            label = f"link_wait:{_bottleneck_label(f, caps)}[{f['cls']}]"
            if f["start"] > cursor + eps:
                # queued behind other traffic for the same bottleneck link
                segs.append(Segment(label, "link_queue", cursor,
                                    f["start"]))
                cursor = f["start"]
            if f["drain"] > cursor + eps:
                segs.append(Segment(label, "link_wait", cursor,
                                    f["drain"]))
                cursor = f["drain"]
        ready = max(req["ready"], cursor)
        if ready > cursor + eps:
            # route latency after the last byte drains (and any landing
            # work the plan's ETA covers beyond the wire)
            segs.append(Segment("transfer_tail", "transfer_tail", cursor,
                                ready))
            cursor = ready
        a = admit.get(rid)
        if a is not None and a > cursor + eps:
            segs.append(Segment("sched_wait", "sched_wait", cursor, a))
            cursor = a
        done = finish.get(rid)
        if done is not None and done > cursor + eps:
            segs.append(Segment("decode_compute", "decode_compute",
                                cursor, done))
            cursor = done
        out[rid] = RequestAttribution(rid, start, cursor, tuple(segs))
    return out


def attribution_summary(attrs: dict, *, rids=None) -> dict:
    """Aggregate view over (a subset of) attributed requests.

    ``rids`` selects the requests to pool (e.g. only the SLO violators);
    default is all. ``top_frac`` is the fraction of pooled requests whose
    single largest segment carries each label — the number the headline
    "the degraded link tops >= 90% of violating requests" check reads.
    """
    if rids is None:
        sel = list(attrs.values())
    else:
        sel = [attrs[r] for r in rids if r in attrs]
    seconds: dict[str, float] = {}
    top_counts: dict[str, int] = {}
    for a in sel:
        for lbl, s in a.breakdown().items():
            seconds[lbl] = seconds.get(lbl, 0.0) + s
        tc = a.top_contributor
        if tc is not None:
            top_counts[tc] = top_counts.get(tc, 0) + 1
    n = len(sel)
    return {
        "requests": n,
        "seconds_by_label": dict(sorted(seconds.items(),
                                        key=lambda kv: -kv[1])),
        "top_counts": dict(sorted(top_counts.items(),
                                  key=lambda kv: -kv[1])),
        "top_frac": {lbl: c / n for lbl, c in top_counts.items()} if n
        else {},
    }
