"""Flight recorder: a bounded ring buffer over the tracer event stream.

The port's copy of the reference's ``repro/obs/recorder.py``.

Always-on tracing of a long serve would grow without bound; the flight
recorder keeps only the last ``capacity`` events (a ``deque``), cheap
enough to leave attached to a live engine, and snapshots them to a
Perfetto-loadable dump the moment something goes wrong — an SLO burn
alert, a degradation-detector fire — so the trace of the *interesting*
window survives even though most of the run was never persisted.

``FlightRecorder`` is a drop-in ``Tracer``: every emission API, scoped
views, and the metrics registry work unchanged; only the event sink is a
ring. An optional ``forward`` tracer receives every event too (ring for
the crash dump + full tracer for offline analysis, one emission path).

Snapshots go through ``export.recorder_trace``: a ring that truncated
mid-span still exports a structurally valid trace (orphans dropped,
dangling opens closed with synthetic ``truncated`` events), with the
trigger reason, drop counters, metrics snapshot, and the attribution
summary of the failing window under the top-level ``metadata`` key.
"""

from __future__ import annotations

import collections
import json
from typing import Optional

from repro_torch.obs.trace import TraceEvent, Tracer

_MAX_KEPT_SNAPSHOTS = 4


class FlightRecorder(Tracer):
    """A ``Tracer`` whose event sink is a bounded ring buffer."""

    def __init__(self, capacity: int = 8192, *, clock=None, metrics=None,
                 forward: Optional[Tracer] = None):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        if forward is not None:
            clock = clock if clock is not None else forward.clock
            metrics = metrics if metrics is not None else forward.metrics
        super().__init__(clock=clock, metrics=metrics)
        self.capacity = int(capacity)
        self.events: collections.deque = collections.deque(
            maxlen=self.capacity)
        self.forward = forward
        self.emitted = 0             # total ever emitted (ring-safe cursor)
        self.dropped = 0             # events aged out of the ring
        self.snapshots: list[dict] = []

    def _emit(self, kind, name, ts, track, cat, id=None, args=None):
        if len(self.events) == self.capacity:
            self.dropped += 1
        ev = TraceEvent(kind, name,
                        self.clock() if ts is None else ts,
                        track, cat, id, args or None)
        self.events.append(ev)
        self.emitted += 1
        fw = self.forward
        if fw is not None and fw.enabled:
            fw._emit(kind, name, ev.ts, track, cat, id=id, args=args)

    def snapshot(self, *, reason: str = "manual", attribution=None,
                 ts: Optional[float] = None) -> dict:
        """Export the ring's current contents as a validated trace dict
        and retain it (the last few snapshots are kept for ``dump``)."""
        meta = {"reason": reason,
                "ts": self.clock() if ts is None else ts,
                "capacity": self.capacity, "events": len(self.events),
                "emitted": self.emitted, "dropped": self.dropped,
                "metrics": self.metrics.to_json()}
        if attribution is not None:
            meta["attribution"] = attribution
        from repro_torch.obs.export import recorder_trace
        trace = recorder_trace(list(self.events), metadata=meta)
        self.snapshots.append(trace)
        del self.snapshots[:-_MAX_KEPT_SNAPSHOTS]
        return trace

    def dump(self, path: str, trace: Optional[dict] = None) -> dict:
        """Write a snapshot to ``path`` (the last triggered one by
        default; takes a fresh one if none was triggered)."""
        if trace is None:
            trace = (self.snapshots[-1] if self.snapshots
                     else self.snapshot(reason="dump"))
        with open(path, "w") as f:
            json.dump(trace, f, indent=1)
        return trace
