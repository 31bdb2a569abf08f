"""Tracer: spans, instant events, async flows, and counter samples.

The port's copy of the reference's ``repro/obs/trace.py``, unchanged but
for its import, so ``repro_torch`` imports nothing from ``repro``, and for
the profiler annotation: on the wall clock, while a ``torch.profiler``
records, ``Tracer.span`` also opens a ``record_function`` range of the
span's name, so the program's spans land in the profiler's trace on its
clock. The docstrings below describe the reference's layers, which the
port gains slice by slice.

The event half of ``repro.obs`` (``metrics.py`` is the aggregate half).
One shared vocabulary for every layer that moves bytes or makes a
scheduling decision — the fabric simulator, the KV pager, the decode
scheduler, the serve engine, and calibration validation all emit into the
same event list, which ``repro.obs.export`` renders as Chrome trace-event
JSON (Perfetto / chrome://tracing).

Design constraints, in order:

  * **The hot path pays nothing when disabled.** ``NULL_TRACER`` is the
    default everywhere; every method is a no-op and ``enabled`` is False so
    instrumented code can skip building expensive event arguments.
  * **Deterministic under an injected clock.** Timestamps come from
    ``clock()`` only when the caller does not pass ``ts=`` explicitly;
    simulators pass sim time, tests pass a fixed counter, and the exported
    trace is then byte-stable (the golden-file test's contract).
  * **Zero dependencies.** Events are frozen dataclasses in a list; export
    is a separate concern.

Tracks: every event lives on a ``(process, thread)`` tuple which the
exporter maps to Perfetto process/thread rows — e.g. ``("fabric",
"link host_dram->chip0")`` is one per-link utilization track.
``Tracer.scoped(prefix, **tags)`` returns a view that prepends ``prefix``
to the process name and merges ``tags`` into every event's args (how
``calibrate.validate`` labels truth/calibrated/nominal replays and
``simulate_paged_decode`` separates its fp16 and int8 runs).
"""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Callable, NamedTuple, Optional

from repro_torch.obs.metrics import NULL_METRICS, MetricsRegistry

DEFAULT_TRACK = ("repro", "main")


class TraceEvent(NamedTuple):
    """One trace event (kinds mirror the Chrome trace-event phases).

    ``kind``: "B"/"E" span begin/end, "i" instant, "C" counter sample,
    "b"/"n"/"e" async begin/instant/end (correlated by ``id`` — overlapping
    lifecycles like fabric flows that a B/E stack cannot express).

    A NamedTuple rather than a frozen dataclass: the fabric simulator
    emits one of these per arbitration event per flow, and tuple
    construction is several times cheaper than a frozen dataclass's
    ``object.__setattr__`` chain — measurably lower tracer overhead.
    """
    kind: str
    name: str
    ts: float                    # seconds (sim time or clock())
    track: tuple                 # (process, thread)
    cat: str = ""
    id: Optional[str] = None     # async correlation id ("b"/"n"/"e" only)
    args: Optional[dict] = None


class Tracer:
    """Event collector with an injectable clock and a metrics registry."""

    enabled = True

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 metrics: Optional[MetricsRegistry] = None):
        self.clock = clock if clock is not None else time.perf_counter
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.events: list[TraceEvent] = []

    # -- emission ------------------------------------------------------------
    def _emit(self, kind, name, ts, track, cat, id=None, args=None):
        self.events.append(TraceEvent(
            kind, name, self.clock() if ts is None else ts,
            track, cat, id, args or None))

    def begin(self, name: str, *, ts: Optional[float] = None,
              track: tuple = DEFAULT_TRACK, cat: str = "", **args) -> None:
        self._emit("B", name, ts, track, cat, args=args)

    def end(self, name: str, *, ts: Optional[float] = None,
            track: tuple = DEFAULT_TRACK, cat: str = "", **args) -> None:
        self._emit("E", name, ts, track, cat, args=args)

    def instant(self, name: str, *, ts: Optional[float] = None,
                track: tuple = DEFAULT_TRACK, cat: str = "",
                **args) -> None:
        self._emit("i", name, ts, track, cat, args=args)

    def counter(self, name: str, values: dict, *,
                ts: Optional[float] = None, track: tuple = DEFAULT_TRACK,
                cat: str = "") -> None:
        """One counter sample: ``values`` maps series label -> number (a
        multi-series Chrome counter track, e.g. utilization per QoS
        class)."""
        self._emit("C", name, ts, track, cat, args=dict(values))

    def async_begin(self, name: str, id: str, *,
                    ts: Optional[float] = None,
                    track: tuple = DEFAULT_TRACK, cat: str = "async",
                    **args) -> None:
        self._emit("b", name, ts, track, cat, id=id, args=args)

    def async_instant(self, name: str, id: str, *,
                      ts: Optional[float] = None,
                      track: tuple = DEFAULT_TRACK, cat: str = "async",
                      **args) -> None:
        self._emit("n", name, ts, track, cat, id=id, args=args)

    def async_end(self, name: str, id: str, *,
                  ts: Optional[float] = None,
                  track: tuple = DEFAULT_TRACK, cat: str = "async",
                  **args) -> None:
        self._emit("e", name, ts, track, cat, id=id, args=args)

    @contextlib.contextmanager
    def span(self, name: str, *, track: tuple = DEFAULT_TRACK,
             cat: str = "", **args):
        """Wall-clock (or injected-clock) B/E span around a code block.

        On the wall clock, while a ``torch.profiler`` records, the span
        also opens a ``record_function`` range of its name: a
        ``user_annotation`` on the profiler's clock. Spans on an injected
        clock (sim time) open none."""
        rng = (_profiler_range(name) if self.clock is time.perf_counter
               else None)
        self.begin(name, track=track, cat=cat, **args)
        try:
            yield self
        finally:
            self.end(name, track=track, cat=cat)
            if rng is not None:
                rng.__exit__(None, None, None)

    # -- views ---------------------------------------------------------------
    def scoped(self, prefix: Optional[str] = None, **tags) -> "Tracer":
        """A view emitting into this tracer with ``prefix/`` prepended to
        every event's process name and ``tags`` merged into every event's
        args. Shares the clock, event list, and metrics registry."""
        if prefix is None and not tags:
            return self
        return _ScopedTracer(self, prefix, tags)

    def tagged(self, **tags) -> "Tracer":
        return self.scoped(None, **tags)


def _profiler_range(name: str):
    """An entered ``record_function(name)`` while a torch profiler records
    in this process, else None. torch is looked up, not imported: where it
    is not loaded, no profiler can be on."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd._profiler_enabled():
        return None
    rng = torch.autograd.profiler.record_function(name)
    rng.__enter__()
    return rng


class _ScopedTracer(Tracer):
    """Prefix/tag view over a parent tracer (see ``Tracer.scoped``)."""

    def __init__(self, parent: Tracer, prefix: Optional[str], tags: dict):
        self._parent = parent
        self._prefix = prefix
        self._tags = tags
        self.clock = parent.clock
        self.metrics = parent.metrics
        self.events = parent.events          # shared sink

    def _emit(self, kind, name, ts, track, cat, id=None, args=None):
        if self._prefix is not None:
            track = (f"{self._prefix}/{track[0]}", track[1])
        if self._tags and kind != "C":
            # counter args are {series: number} — tags would add a bogus
            # non-numeric series; the prefixed process name carries scope
            args = {**self._tags, **(args or {})}
        self._parent._emit(kind, name, ts, track, cat, id=id, args=args)

    def scoped(self, prefix: Optional[str] = None, **tags) -> Tracer:
        if prefix is None and not tags:
            return self
        joined = self._prefix if prefix is None else (
            prefix if self._prefix is None else f"{self._prefix}/{prefix}")
        return _ScopedTracer(self._parent, joined, {**self._tags, **tags})


class _NullContext:
    def __enter__(self):
        return NULL_TRACER

    def __exit__(self, *exc):
        return False


_NULL_CONTEXT = _NullContext()


class NullTracer:
    """No-op tracer: the default everywhere, so the hot path pays only a
    truthiness check (``tracer.enabled``) when tracing is off."""

    enabled = False
    events: tuple = ()
    metrics = NULL_METRICS
    clock = staticmethod(time.perf_counter)

    def begin(self, name, **kw):
        pass

    def end(self, name, **kw):
        pass

    def instant(self, name, **kw):
        pass

    def counter(self, name, values, **kw):
        pass

    def async_begin(self, name, id, **kw):
        pass

    def async_instant(self, name, id, **kw):
        pass

    def async_end(self, name, id, **kw):
        pass

    def span(self, name, **kw):
        return _NULL_CONTEXT

    def scoped(self, prefix=None, **tags) -> "NullTracer":
        return self

    def tagged(self, **tags) -> "NullTracer":
        return self


NULL_TRACER = NullTracer()
