"""BandwidthLedger: charge every wire byte to who moved it and why.

The port's copy of the reference's ``repro/obs/ledger.py``.

The fabric simulator already narrates every transfer (``fabric.sim``
emits one async lifecycle per flow — begin with the route's physical link
labels, a rate instant at every arbitration change, end when the last byte
drains — plus per-link capacity metadata). This module folds that stream
into the always-on accounting a fleet operator scrapes:

  * **attribution** — every byte-second is charged to
    ``(link, QoS class, purpose, request class)`` per fixed time window,
    where purpose is inferred from the flow vocabulary the transport layer
    already uses (``page*`` prefetches, ``ship*`` page shipping,
    ``migrate_*`` recovery migration, ``*offload*``/``*spill*`` bulk).
  * **conservation** — per-flow integrated bytes must equal the flow's
    declared ``nbytes`` (the sim's own completion fuzz is 1e-6 bytes), and
    per-link totals must match both ``LinkTimeline.bytes_moved()`` and the
    ``fabric.link.bytes`` metric counters. The ledger exposes the
    reconciliation, and the obs benchmark family CI-enforces <= 1e-6.
  * **efficiency** — per-link goodput while the link is someone's
    bottleneck, normalized against the calibrated ceiling
    (``link_ceilings(from_profile(...))``). A healthy saturated link reads
    ~1.0; a link degraded below its calibrated bandwidth reads the
    surviving fraction — the "where did the bandwidth go" headline that
    names the halved link in the degradation scenario.

The ledger consumes raw ``TraceEvent`` streams (``ingest``), including
streams holding several sequential ``simulate()`` runs (the degradation
serve loop's rounds): each run re-announces its links' capacity metadata,
which the ledger uses as the run boundary, concatenating run timelines
onto one monotonic ledger clock. Within one tracer, flow ids may repeat
across runs (round-local ``page0``...); each begin opens a fresh record.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

from repro_torch.obs.timeline import LINK_CAT, LINK_META_CAT

# Flow-id vocabulary -> purpose. Prefixes first (the transport layer's
# ``flow_prefix`` contract), substrings as fallback for free-form ids.
_PURPOSE_PREFIXES = (
    ("migrate_", "migration"),
    ("ship", "ship"),
    ("page", "prefetch"),
    ("probe", "prefetch"),
)


def classify_purpose(flow_id: str) -> str:
    """Purpose of one flow from its id (the transport naming contract)."""
    for prefix, purpose in _PURPOSE_PREFIXES:
        if flow_id.startswith(prefix):
            return purpose
    low = flow_id.lower()
    if "offload" in low or "spill" in low:
        return "spill"
    if "migrate" in low:
        return "migration"
    if "ship" in low:
        return "ship"
    return "other"


def classify_request(purpose: str, priority: int) -> str:
    """Request class a byte is billed to: interactive serving traffic
    (prefetch/ship), batch bulk (spill/offload), system overhead
    (migration); unknown purposes fall back to the QoS class."""
    if purpose in ("prefetch", "ship"):
        return "interactive"
    if purpose == "spill":
        return "batch"
    if purpose == "migration":
        return "system"
    return "interactive" if priority and priority > 0 else "batch"


def link_ceilings(system) -> dict:
    """Per-link calibrated bandwidth ceilings keyed by trace link label —
    the normalization ``BandwidthLedger.efficiency`` divides goodput by.
    Pass a calibrated ``System`` (``from_profile(...)``) so the ceiling is
    the machine as measured, not as the datasheet promises."""
    from repro_torch.fabric.sim import link_label
    out: dict = {}
    for link in system.fabric.links.values():
        lbl = link_label(link)
        out[lbl] = max(out.get(lbl, 0.0), link.bandwidth)
    return out


class _FlowState:
    __slots__ = ("fid", "links", "nbytes", "qos", "purpose", "request",
                 "rate", "last_ts", "moved", "t_base", "bottleneck")

    def __init__(self, fid, links, nbytes, qos, purpose, request,
                 ts, t_base, bottleneck):
        self.fid = fid
        self.links = links
        self.nbytes = nbytes
        self.qos = qos
        self.purpose = purpose
        self.request = request
        self.rate = 0.0
        self.last_ts = ts
        self.moved = 0.0
        self.t_base = t_base
        self.bottleneck = bottleneck


class BandwidthLedger:
    """Windowed per-(link, QoS, purpose, request-class) byte accounting
    over a fabric trace stream, with conservation and efficiency views.

    ``window_s`` is the aggregation window on the concatenated-run ledger
    clock; ``ceilings`` maps link label -> bytes/s (``link_ceilings``),
    falling back to the largest capacity each link ever announced;
    ``process`` restricts ingestion to events whose track process matches
    (a scope prefix like ``"react"`` selects one arm of a two-arm trace).
    """

    def __init__(self, *, window_s: float = 0.05,
                 ceilings: Optional[dict] = None,
                 process: Optional[str] = None,
                 classify: Callable[[str], str] = classify_purpose,
                 classify_req: Callable[[str, int], str] = classify_request):
        if window_s <= 0:
            raise ValueError(f"window_s must be positive, got {window_s}")
        self.window_s = float(window_s)
        self._ceilings = dict(ceilings or {})
        self._process = process
        self._classify = classify
        self._classify_req = classify_req
        self._entries: dict = {}          # (link, qos, purpose, req) -> bytes
        self._windows: dict = {}          # window idx -> {key4: bytes}
        self._link_bytes: dict = {}       # link -> bytes (totals)
        self._segments: dict = {}         # link -> [(g0, g1, rate)] bottlenecked
        self._open: dict = {}             # flow id -> _FlowState
        self._flows: list = []            # finalized flow records
        self._caps: dict = {}             # link -> latest announced capacity
        self._max_caps: dict = {}         # link -> max capacity ever seen
        self._t_base = 0.0                # concatenated-run clock offset
        self._run_max = 0.0               # max ts seen in the current run
        self._saw_flow = False            # fabric activity since last boundary

    # -- ingestion -----------------------------------------------------------
    def _match(self, track: tuple) -> bool:
        if self._process is None:
            return True
        p0, proc = track[0], self._process
        return (p0 == proc or p0.startswith(proc + "/")
                or p0.endswith("/" + proc) or f"/{proc}/" in p0)

    def ingest(self, events: Sequence) -> "BandwidthLedger":
        """Fold a slice of ``TraceEvent``s in; call repeatedly to stream."""
        for ev in events:
            cat = ev.cat
            if cat == "flow" and ev.id is not None:
                if not self._match(ev.track):
                    continue
                self._flow_event(ev)
            elif cat == LINK_META_CAT:
                if not self._match(ev.track):
                    continue
                if self._saw_flow:
                    # a fresh simulate() run re-announces link capacity
                    # before any flow begins: close the previous run and
                    # concatenate its span onto the ledger clock
                    self._t_base += self._run_max
                    self._run_max = 0.0
                    self._saw_flow = False
                args = ev.args or {}
                lbl = args.get("link")
                cap = float(args.get("capacity", 0.0))
                if lbl:
                    self._caps[lbl] = cap
                    self._max_caps[lbl] = max(self._max_caps.get(lbl, 0.0),
                                              cap)
                self._run_max = max(self._run_max, ev.ts)
            elif cat == LINK_CAT and self._match(ev.track):
                self._run_max = max(self._run_max, ev.ts)
        return self

    def _flow_event(self, ev) -> None:
        args = ev.args or {}
        self._run_max = max(self._run_max, ev.ts)
        if ev.kind == "b":
            links = tuple(args.get("links") or ())
            if not links:
                return
            self._saw_flow = True
            purpose = self._classify(ev.id)
            prio = int(args.get("priority", 0) or 0)
            caps = self._caps
            bottleneck = min(
                links, key=lambda l: caps.get(
                    l, self._ceilings.get(l, math.inf)))
            self._open[ev.id] = _FlowState(
                ev.id, links, float(args.get("nbytes", 0.0)),
                f"p{prio}", purpose, self._classify_req(purpose, prio),
                ev.ts, self._t_base, bottleneck)
        elif ev.kind == "n":
            st = self._open.get(ev.id)
            rate = args.get("rate_bytes_per_s")
            if st is not None and rate is not None:
                self._advance(st, ev.ts)
                st.rate = float(rate)
        elif ev.kind == "e":
            st = self._open.pop(ev.id, None)
            if st is not None:
                # the flow's bytes stop at drain time; ``ev.ts`` adds the
                # route latency tail and would over-integrate
                self._advance(st, float(args.get("drained_ts", ev.ts)))
                self._flows.append({
                    "id": st.fid, "purpose": st.purpose, "qos": st.qos,
                    "request_class": st.request, "nbytes": st.nbytes,
                    "moved": st.moved, "links": list(st.links),
                    "bottleneck": st.bottleneck,
                })

    def _advance(self, st: _FlowState, ts: float) -> None:
        dt = ts - st.last_ts
        if dt <= 0:
            return
        if st.rate > 0:
            nb = st.rate * dt
            st.moved += nb
            g0 = st.t_base + st.last_ts
            g1 = st.t_base + ts
            for link in st.links:
                key = (link, st.qos, st.purpose, st.request)
                self._entries[key] = self._entries.get(key, 0.0) + nb
                self._link_bytes[link] = \
                    self._link_bytes.get(link, 0.0) + nb
                self._charge_windows(key, g0, g1, st.rate)
            self._segments.setdefault(st.bottleneck, []).append(
                (g0, g1, st.rate))
        st.last_ts = ts

    def _charge_windows(self, key, g0: float, g1: float,
                        rate: float) -> None:
        w = self.window_s
        i0, i1 = int(g0 // w), int(g1 // w)
        for i in range(i0, i1 + 1):
            lo = max(g0, i * w)
            hi = min(g1, (i + 1) * w)
            if hi > lo:
                wd = self._windows.setdefault(i, {})
                wd[key] = wd.get(key, 0.0) + rate * (hi - lo)

    @classmethod
    def from_tracer(cls, tracer, **kw) -> "BandwidthLedger":
        return cls(**kw).ingest(tracer.events)

    # -- views ---------------------------------------------------------------
    @property
    def flows(self) -> list:
        """Finalized flow records (id, purpose, moved vs declared bytes)."""
        return list(self._flows)

    def entries(self) -> list:
        """The ledger proper: one row per (link, QoS class, purpose,
        request class), largest charge first."""
        rows = [{"link": k[0], "qos": k[1], "purpose": k[2],
                 "request_class": k[3], "bytes": v}
                for k, v in self._entries.items()]
        rows.sort(key=lambda r: (-r["bytes"], r["link"], r["qos"],
                                 r["purpose"], r["request_class"]))
        return rows

    def link_totals(self) -> dict:
        return dict(self._link_bytes)

    def total_bytes(self) -> float:
        """Flow-level total (each flow's bytes counted once, however many
        links it crossed) — the number ``FlowResult`` sums reconcile to."""
        return sum(f["moved"] for f in self._flows)

    def windows(self) -> list:
        """Per-window per-link byte charges on the ledger clock."""
        out = []
        for i in sorted(self._windows):
            links: dict = {}
            for (link, _, _, _), nb in self._windows[i].items():
                links[link] = links.get(link, 0.0) + nb
            out.append({"index": i, "start_s": i * self.window_s,
                        "links": links})
        return out

    def efficiency(self) -> dict:
        """Per-link goodput-vs-ceiling while the link was someone's
        bottleneck. Links never on a flow's critical link are omitted —
        a feeder link idling behind a slow hop is not "inefficient"."""
        out = {}
        for link, segs in sorted(self._segments.items()):
            ceiling = self._ceilings.get(link) \
                or self._max_caps.get(link, 0.0)
            if ceiling <= 0:
                continue
            goodput = sum(r * (b - a) for a, b, r in segs)
            ivs = sorted((a, b) for a, b, _ in segs)
            busy = 0.0
            cur_a, cur_b = ivs[0]
            for a, b in ivs[1:]:
                if a > cur_b:
                    busy += cur_b - cur_a
                    cur_a, cur_b = a, b
                else:
                    cur_b = max(cur_b, b)
            busy += cur_b - cur_a
            rate = goodput / busy if busy > 0 else 0.0
            out[link] = {
                "bottlenecked_bytes": goodput,
                "busy_s": busy,
                "goodput_bytes_per_s": rate,
                "ceiling_bytes_per_s": ceiling,
                "efficiency": rate / ceiling,
            }
        return out

    # -- conservation --------------------------------------------------------
    def flow_conservation(self) -> dict:
        """Integrated bytes vs declared ``nbytes`` per finalized flow."""
        worst, worst_id = 0.0, None
        for f in self._flows:
            if f["nbytes"] <= 0:
                continue
            rel = abs(f["moved"] - f["nbytes"]) / f["nbytes"]
            if rel > worst:
                worst, worst_id = rel, f["id"]
        return {"n_flows": len(self._flows), "max_rel_err": worst,
                "worst_flow": worst_id}

    def reconcile_timelines(self, timelines: dict) -> dict:
        """Ledger per-link totals vs ``LinkTimeline.bytes_moved()``
        integrals (``link_timelines`` output; single-run tracers only —
        the timeline reconstruction assumes one monotonic run)."""
        links, worst = {}, 0.0
        for lbl, tl in timelines.items():
            expected = tl.bytes_moved()
            got = self._link_bytes.get(lbl, 0.0)
            rel = (abs(got - expected) / expected if expected > 0
                   else abs(got))
            links[lbl] = {"ledger": got, "timeline": expected,
                          "rel_err": rel}
            worst = max(worst, rel)
        return {"max_rel_err": worst, "links": links}

    def reconcile_metrics(self, metrics) -> dict:
        """Ledger per-link totals vs the ``fabric.link.bytes`` counters
        the simulator flushes (multi-run safe: both accumulate)."""
        links, worst = {}, 0.0
        for lbl, got in sorted(self._link_bytes.items()):
            expected = metrics.counter("fabric.link.bytes", link=lbl)
            rel = (abs(got - expected) / expected if expected > 0
                   else abs(got))
            links[lbl] = {"ledger": got, "counter": expected,
                          "rel_err": rel}
            worst = max(worst, rel)
        return {"max_rel_err": worst, "links": links}

    def reconcile_flow_bytes(self, results: Sequence) -> dict:
        """Ledger flow-level total vs summed ``FlowResult`` bytes (flows
        that crossed at least one link; zero-hop flows emit no trace)."""
        expected = float(sum(r.flow.nbytes for r in results
                             if r.duration > 0 or r.flow.nbytes == 0))
        got = self.total_bytes()
        rel = abs(got - expected) / expected if expected > 0 else abs(got)
        return {"ledger": got, "flow_results": expected, "rel_err": rel}

    def report(self) -> dict:
        """The full ledger snapshot (the CI artifact / OpenMetrics feed)."""
        return {
            "window_s": self.window_s,
            "n_flows": len(self._flows),
            "total_bytes": self.total_bytes(),
            "entries": self.entries(),
            "links": {k: v for k, v in sorted(self._link_bytes.items())},
            "efficiency": self.efficiency(),
            "windows": self.windows(),
            "conservation": self.flow_conservation(),
        }
