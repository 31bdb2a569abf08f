"""Streaming SLO monitor: log-scale latency histograms + burn-rate windows.

The port's copy of the reference's ``repro/obs/slo.py``.

The serving layers (``ServeEngine``, ``serving.disagg``, the degradation
loop) observe one latency sample per finished request; this module turns
that stream into SLO state without per-request storage:

  * ``LatencyHistogram`` — fixed-bucket log-scale histogram (64 buckets per
    decade by default). Mergeable across shards (same shape adds counts),
    constant memory, and percentile reads with a bounded relative error of
    ``sqrt(10^(1/buckets_per_decade)) - 1`` (~1.8% at 64/decade — the
    geometric bucket midpoint is never further than half a bucket from the
    true value). The obs benchmark family holds p50/p95/p99 against exact
    percentiles at <= 2% and CI enforces it.
  * ``SLOMonitor`` — per-class violation burn rate over two sliding count
    windows (the SRE multiwindow idiom, request-count-based so it is
    deterministic under sim time): the short window must burn past
    ``burn_threshold`` x budget AND the long window past budget before the
    monitor alerts, so one unlucky request cannot fire it and a slow leak
    still does. Threshold crossings emit ``slo.burn_alert`` /
    ``slo.burn_clear`` trace instants and invoke ``on_alert`` — the hook
    the flight recorder and ``DegradationDetector`` corroboration ride.

Everything here is pure Python over numbers already in hand; attaching a
monitor to a live engine costs one ``observe`` per request.
"""

from __future__ import annotations

import collections
import math
from typing import Callable, Optional

from repro_torch.obs.trace import NULL_TRACER

# --------------------------------------------------------------------------
# Fixed-bucket log-scale latency histogram
# --------------------------------------------------------------------------


class LatencyHistogram:
    """Log-scale bucketed histogram over ``[lo, hi)`` seconds.

    Bucket ``i`` covers ``[lo * 10^(i/bpd), lo * 10^((i+1)/bpd))``; samples
    below ``lo`` land in the underflow bucket (reported as ``lo``), at or
    above ``hi`` in the overflow bucket (reported as ``hi``). Two
    histograms with the same ``(lo, hi, buckets_per_decade)`` merge by
    adding counts — the property that lets per-shard monitors roll up.
    """

    def __init__(self, lo: float = 1e-6, hi: float = 100.0,
                 buckets_per_decade: int = 64):
        if not 0 < lo < hi:
            raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
        self.lo = float(lo)
        self.hi = float(hi)
        self.bpd = int(buckets_per_decade)
        self.n_buckets = int(math.ceil(
            math.log10(self.hi / self.lo) * self.bpd))
        # [underflow, bucket 0 .. n-1, overflow]
        self.counts = [0] * (self.n_buckets + 2)
        self.count = 0

    @property
    def rel_error_bound(self) -> float:
        """Worst-case relative error of a percentile read (half-bucket)."""
        return math.sqrt(10.0 ** (1.0 / self.bpd)) - 1.0

    def _index(self, v: float) -> int:
        if v < self.lo:
            return 0
        i = int(math.floor(math.log10(v / self.lo) * self.bpd))
        if i >= self.n_buckets:
            return self.n_buckets + 1
        return i + 1

    def _value(self, idx: int) -> float:
        if idx == 0:
            return self.lo
        if idx == self.n_buckets + 1:
            return self.hi
        # geometric midpoint: halves the worst-case relative error vs
        # reporting a bucket edge
        return self.lo * 10.0 ** ((idx - 0.5) / self.bpd)

    def record(self, latency_s: float) -> None:
        self.counts[self._index(max(latency_s, 0.0))] += 1
        self.count += 1

    def percentile(self, q: float) -> float:
        """Latency at percentile ``q`` (0..100); 0.0 on an empty histogram.

        Rank rule: the ``ceil(q/100 * count)``-th smallest sample — the
        same rule the exact-percentile accuracy check uses, so the only
        error left is bucket quantization.
        """
        if self.count == 0:
            return 0.0
        rank = min(self.count, max(1, math.ceil(q / 100.0 * self.count)))
        cum = 0
        for idx, c in enumerate(self.counts):
            cum += c
            if cum >= rank:
                return self._value(idx)
        return self.hi

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        if (self.lo, self.hi, self.bpd) != (other.lo, other.hi, other.bpd):
            raise ValueError(
                f"histogram shapes differ: ({self.lo}, {self.hi}, "
                f"{self.bpd}) vs ({other.lo}, {other.hi}, {other.bpd})")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        return self

    def to_json(self) -> dict:
        return {"lo": self.lo, "hi": self.hi,
                "buckets_per_decade": self.bpd, "count": self.count,
                "buckets": {str(i): c for i, c in enumerate(self.counts)
                            if c}}

    @classmethod
    def from_json(cls, d: dict) -> "LatencyHistogram":
        h = cls(d["lo"], d["hi"], d["buckets_per_decade"])
        for i, c in d["buckets"].items():
            h.counts[int(i)] = int(c)
        h.count = d["count"]
        return h


# --------------------------------------------------------------------------
# Burn-rate windows + the monitor
# --------------------------------------------------------------------------


class _BurnWindow:
    """Violation rate over the last ``size`` observations."""

    def __init__(self, size: int):
        self.buf: collections.deque = collections.deque(maxlen=size)

    def push(self, violated: bool) -> None:
        self.buf.append(bool(violated))

    def rate(self) -> float:
        return sum(self.buf) / len(self.buf) if self.buf else 0.0

    def __len__(self) -> int:
        return len(self.buf)


class _ClassState:
    def __init__(self, slo_s: Optional[float], short: int, long: int,
                 hist_kw: dict):
        self.slo_s = slo_s
        self.hist = LatencyHistogram(**hist_kw)
        self.short = _BurnWindow(short)
        self.long = _BurnWindow(long)
        self.violations = 0
        self.alerting = False
        self.alerts = 0


class SLOMonitor:
    """Per-class streaming SLO state over latency observations.

    ``slos`` maps class name -> SLO latency budget in seconds; classes can
    also be added later via ``add_class`` (idempotent — a caller-provided
    budget is never overwritten). ``budget_frac`` is the tolerated
    violation rate; burn = observed violation rate / budget_frac. The
    monitor alerts when the short window burns past ``burn_threshold`` AND
    the long window past 1.0 (with at least ``min_samples`` short-window
    observations), emitting ``slo.burn_alert`` and calling ``on_alert``
    on the rising edge.
    """

    def __init__(self, slos: Optional[dict] = None, *,
                 budget_frac: float = 0.05, burn_threshold: float = 2.0,
                 short_window: int = 12, long_window: int = 36,
                 min_samples: int = 4, histogram_kw: Optional[dict] = None,
                 tracer=NULL_TRACER,
                 on_alert: Optional[Callable] = None):
        self.budget_frac = float(budget_frac)
        self.burn_threshold = float(burn_threshold)
        self.short_window = int(short_window)
        self.long_window = int(long_window)
        self.min_samples = int(min_samples)
        self.hist_kw = dict(histogram_kw or {})
        self.tracer = tracer
        self.on_alert = on_alert
        self._classes: dict[str, _ClassState] = {}
        for cls, slo_s in (slos or {}).items():
            self.add_class(cls, slo_s)

    def add_class(self, cls: str, slo_s: Optional[float] = None) -> None:
        """Register a class; keeps an existing budget if already set."""
        st = self._classes.get(cls)
        if st is None:
            self._classes[cls] = _ClassState(
                slo_s, self.short_window, self.long_window, self.hist_kw)
        elif st.slo_s is None and slo_s is not None:
            st.slo_s = slo_s

    def _state(self, cls: str) -> _ClassState:
        if cls not in self._classes:
            self.add_class(cls)
        return self._classes[cls]

    def observe(self, cls: str, latency_s: float, *,
                ts: Optional[float] = None,
                violated: Optional[bool] = None) -> bool:
        """Feed one finished request; returns the class's alerting flag.

        ``violated`` defaults to ``latency_s > slo`` when the class has a
        budget; schedulers that judge violations themselves (deadline
        overruns in sim time) pass their own verdict.
        """
        st = self._state(cls)
        if violated is None:
            violated = st.slo_s is not None and latency_s > st.slo_s
        st.hist.record(latency_s)
        st.short.push(violated)
        st.long.push(violated)
        if violated:
            st.violations += 1
        tracer = self.tracer
        burn_s = st.short.rate() / self.budget_frac
        burn_l = st.long.rate() / self.budget_frac
        alerting = (len(st.short) >= self.min_samples
                    and burn_s > self.burn_threshold and burn_l > 1.0)
        if tracer.enabled:
            if violated:
                tracer.instant("slo.violation", ts=ts,
                               track=("slo", cls), cat="slo",
                               latency_s=latency_s, slo_s=st.slo_s)
            tracer.counter("slo.burn", {cls: burn_s}, ts=ts,
                           track=("slo", "burn"), cat="slo")
        if alerting and not st.alerting:
            st.alerts += 1
            if tracer.enabled:
                tracer.instant("slo.burn_alert", ts=ts,
                               track=("slo", cls), cat="slo",
                               burn_short=burn_s, burn_long=burn_l,
                               slo_s=st.slo_s)
                tracer.metrics.add("slo.alerts", 1, cls=cls)
            if self.on_alert is not None:
                self.on_alert(cls, {"burn_short": burn_s,
                                    "burn_long": burn_l,
                                    "slo_s": st.slo_s, "ts": ts})
        elif st.alerting and not alerting and tracer.enabled:
            tracer.instant("slo.burn_clear", ts=ts, track=("slo", cls),
                           cat="slo", burn_short=burn_s, burn_long=burn_l)
        st.alerting = alerting
        return alerting

    def alerting(self, cls: str) -> bool:
        st = self._classes.get(cls)
        return bool(st and st.alerting)

    def percentile(self, cls: str, q: float) -> float:
        return self._state(cls).hist.percentile(q)

    def report(self) -> dict:
        """Per-class snapshot: counts, percentiles, burn, alert state."""
        out = {}
        for cls, st in self._classes.items():
            out[cls] = {
                "slo_s": st.slo_s,
                "count": st.hist.count,
                "violations": st.violations,
                "p50_s": st.hist.percentile(50),
                "p95_s": st.hist.percentile(95),
                "p99_s": st.hist.percentile(99),
                "burn_short": st.short.rate() / self.budget_frac,
                "burn_long": st.long.rate() / self.budget_frac,
                "alerting": st.alerting,
                "alerts": st.alerts,
            }
        return out
