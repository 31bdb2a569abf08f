"""Chrome trace-event JSON export (Perfetto / chrome://tracing).

The port's copy of the reference's ``repro/obs/export.py``.

``chrome_trace`` renders a ``Tracer``'s event list (or any iterable of
``TraceEvent``) into the trace-event format: every ``(process, thread)``
track becomes a pid/tid pair with metadata naming events, spans become
matched B/E pairs, async lifecycles (fabric flows) become b/n/e triples
correlated by id, and counter samples become multi-series "C" tracks — the
per-link utilization timelines render as stacked area charts under each
link's track.

Determinism is part of the contract: with an injected fixed clock the
emitted JSON is byte-stable (pids/tids assigned in first-seen order, events
stably sorted by timestamp), which is what the golden-file test pins.

``ChromeTraceWriter`` is the incremental path the flight recorder uses:
already-rendered events are never re-sorted — each ``extend`` batch is
sorted on its own and merged in, so exporting N snapshots of a long run
costs O(new events) per snapshot instead of re-sorting the full history.

``recorder_trace`` exports a *truncated* stream (a ring buffer's tail):
orphaned E/e events whose B/b was dropped are removed and dangling B/b
events are closed with synthetic end events (tagged ``truncated``), so the
snapshot always passes ``validate_chrome_trace`` and loads in Perfetto.

``validate_chrome_trace`` is the self-check the obs benchmark family and
the tests share: timestamps sorted, B/E balanced per track, async events
balanced per (cat, id).
"""

from __future__ import annotations

import heapq
import json
from typing import Iterable, Union

from repro_torch.obs.trace import NullTracer, TraceEvent, Tracer

_US = 1e6                        # trace-event timestamps are microseconds


class ChromeTraceWriter:
    """Incremental trace-event renderer with stable pid/tid assignment.

    ``extend`` renders a batch of ``TraceEvent``s; batches arriving in
    timestamp order append in O(batch log batch) (one local sort), and an
    out-of-order batch falls back to a single linear merge — the full
    history is never re-sorted. ``trace()`` returns the Perfetto-loadable
    object (metadata first, then events).
    """

    def __init__(self):
        self._pids: dict[str, int] = {}
        self._tids: dict[tuple, int] = {}
        self._meta: list[dict] = []
        self._out: list[dict] = []

    def _render(self, ev: TraceEvent) -> dict:
        proc, thread = ev.track
        if proc not in self._pids:
            self._pids[proc] = len(self._pids) + 1
            self._meta.append({"ph": "M", "pid": self._pids[proc],
                               "tid": 0, "name": "process_name",
                               "args": {"name": proc}})
        if ev.track not in self._tids:
            self._tids[ev.track] = sum(
                1 for t in self._tids if t[0] == proc) + 1
            self._meta.append({"ph": "M", "pid": self._pids[proc],
                               "tid": self._tids[ev.track],
                               "name": "thread_name",
                               "args": {"name": thread}})
        e = {"ph": ev.kind, "name": ev.name, "pid": self._pids[proc],
             "tid": self._tids[ev.track], "ts": ev.ts * _US}
        if ev.cat:
            e["cat"] = ev.cat
        if ev.kind == "i":
            e["s"] = "t"                       # thread-scoped instant
        if ev.kind in ("b", "n", "e"):
            e["id"] = ev.id
            e.setdefault("cat", "async")       # async matching needs a cat
        if ev.args:
            e["args"] = ev.args
        return e

    def extend(self, events: Iterable[TraceEvent]) -> None:
        # Stable sort within the batch: events at equal timestamps keep
        # emission order, so an E and the next span's B at the same
        # instant stay correctly ordered.
        batch = [self._render(ev)
                 for ev in sorted(events, key=lambda e: e.ts)]
        if not batch:
            return
        if self._out and batch[0]["ts"] < self._out[-1]["ts"]:
            # rare: a batch overlapping already-written history — one
            # linear merge, still no full re-sort
            self._out = list(heapq.merge(self._out, batch,
                                         key=lambda e: e["ts"]))
        else:
            self._out.extend(batch)

    def add(self, ev: TraceEvent) -> None:
        self.extend((ev,))

    def trace(self) -> dict:
        return {"traceEvents": self._meta + self._out,
                "displayTimeUnit": "ms"}


def chrome_trace(tracer: Union[Tracer, NullTracer, Iterable]) -> dict:
    """Render a tracer's events (or any ``TraceEvent`` iterable) as a
    Chrome trace-event JSON object."""
    events = getattr(tracer, "events", tracer)
    w = ChromeTraceWriter()
    w.extend(events)
    return w.trace()


def write_chrome_trace(tracer: Union[Tracer, NullTracer],
                       path: str) -> dict:
    """Write the trace JSON to ``path``; returns the trace object."""
    trace = chrome_trace(tracer)
    with open(path, "w") as f:
        json.dump(trace, f, indent=1)
    return trace


def _balance_events(events: list) -> list:
    """Repair a truncated event stream (time-sorted ``TraceEvent`` list).

    A ring buffer drops the *oldest* events, so the tail can hold E events
    whose B is gone and B/b events whose E/e falls past the snapshot.
    Orphans are dropped (including an E closing a differently-named B —
    the stack below it belongs to a dropped frame) and dangling opens are
    closed at the last timestamp with synthetic events tagged
    ``truncated`` — the result always validates.
    """
    out: list = []
    stacks: dict[tuple, list] = {}
    async_open: dict[tuple, list] = {}
    last_ts = 0.0
    for ev in events:
        last_ts = ev.ts
        if ev.kind == "B":
            stacks.setdefault(ev.track, []).append((ev.name, len(out)))
            out.append(ev)
        elif ev.kind == "E":
            stack = stacks.get(ev.track)
            if not stack or stack[-1][0] != ev.name:
                continue                       # orphaned close: drop
            stack.pop()
            out.append(ev)
        elif ev.kind == "b":
            async_open.setdefault((ev.cat, ev.id), []).append(ev)
            out.append(ev)
        elif ev.kind == "e":
            opens = async_open.get((ev.cat, ev.id))
            if not opens:
                continue                       # begin was dropped
            opens.pop()
            out.append(ev)
        else:
            out.append(ev)
    closers: list = []
    for track, stack in stacks.items():
        for name, _ in reversed(stack):
            closers.append(TraceEvent("E", name, last_ts, track, "",
                                      None, {"truncated": True}))
    for (cat, id_), opens in async_open.items():
        for ev in opens:
            closers.append(TraceEvent("e", ev.name, last_ts, ev.track,
                                      cat, id_, {"truncated": True}))
    return out + closers


def recorder_trace(events: Iterable[TraceEvent],
                   metadata: dict = None) -> dict:
    """Perfetto-loadable export of a (possibly ring-truncated) event
    stream; ``metadata`` lands under a top-level ``"metadata"`` key
    (ignored by Perfetto, read by humans and the CI artifact checks)."""
    w = ChromeTraceWriter()
    w.extend(_balance_events(sorted(events, key=lambda e: e.ts)))
    trace = w.trace()
    if metadata is not None:
        trace["metadata"] = metadata
    return trace


def validate_chrome_trace(trace: dict) -> dict:
    """Structural self-check of an exported trace; raises ``ValueError``
    naming the first violation. Returns counts for reporting.

    Checks: timestamps non-decreasing within the event stream, B/E pairs
    balanced (LIFO) per (pid, tid), async b/e balanced per (cat, id),
    counter samples numeric.
    """
    events = trace["traceEvents"]
    last_ts = None
    stacks: dict[tuple, list] = {}
    async_open: dict[tuple, int] = {}
    counts = {"events": len(events), "spans": 0, "async": 0,
              "counters": 0, "instants": 0}
    for e in events:
        ph = e["ph"]
        if ph == "M":
            continue
        ts = e["ts"]
        if last_ts is not None and ts < last_ts:
            raise ValueError(f"timestamps out of order: {ts} after "
                             f"{last_ts} ({e['name']!r})")
        last_ts = ts
        key = (e["pid"], e["tid"])
        if ph == "B":
            stacks.setdefault(key, []).append(e["name"])
            counts["spans"] += 1
        elif ph == "E":
            stack = stacks.get(key)
            if not stack:
                raise ValueError(f"E without B on track {key}: "
                                 f"{e['name']!r}")
            top = stack.pop()
            if top != e["name"]:
                raise ValueError(f"mismatched span nesting on {key}: "
                                 f"E {e['name']!r} closes B {top!r}")
        elif ph == "b":
            async_open[(e.get("cat"), e["id"])] = \
                async_open.get((e.get("cat"), e["id"]), 0) + 1
            counts["async"] += 1
        elif ph == "e":
            k = (e.get("cat"), e["id"])
            if async_open.get(k, 0) <= 0:
                raise ValueError(f"async end without begin for {k}")
            async_open[k] -= 1
        elif ph == "C":
            for series, v in e.get("args", {}).items():
                if not isinstance(v, (int, float)):
                    raise ValueError(f"non-numeric counter series "
                                     f"{series!r} in {e['name']!r}")
            counts["counters"] += 1
        elif ph == "i":
            counts["instants"] += 1
    open_spans = {k: v for k, v in stacks.items() if v}
    if open_spans:
        raise ValueError(f"unclosed B spans: {open_spans}")
    dangling = {k for k, v in async_open.items() if v}
    if dangling:
        raise ValueError(f"unclosed async spans: {sorted(dangling)}")
    return counts
