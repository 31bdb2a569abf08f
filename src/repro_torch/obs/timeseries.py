"""Windowed time-series over metrics/ledger + OpenMetrics exposition.

The port's copy of the reference's ``repro/obs/timeseries.py``.

Two halves:

  * ``WindowAggregator`` — fixed-window ring aggregation: counter deltas
    become per-window rates, gauges keep the latest write per window,
    latency samples stream into one mergeable ``LatencyHistogram`` per
    window. Aggregators with the same window size merge (counters add,
    gauges latest-timestamp-wins, histograms add counts), which is how the
    disaggregated prefill and decode roles roll their telemetry up into
    one fleet view.
  * ``openmetrics_text`` — OpenMetrics text exposition over a
    ``MetricsRegistry`` snapshot, a ``BandwidthLedger``, histograms, and
    the aggregator's latest-window rates; ``serve_openmetrics`` exposes
    the same render over HTTP (the ``--metrics-listen`` scrape endpoint),
    ``write_openmetrics`` snapshots it to a file (``--openmetrics-out``).

Registry keys round-trip through ``repro_torch.obs.metrics.parse_key`` — the
delimiter-escaping contract is what makes labeled keys recoverable here.
"""

from __future__ import annotations

import re
import threading
from typing import Callable, Optional

from repro_torch.obs.metrics import _key, parse_key
from repro_torch.obs.slo import LatencyHistogram

# --------------------------------------------------------------------------
# Fixed-window ring aggregation
# --------------------------------------------------------------------------


class WindowAggregator:
    """Ring of fixed ``window_s`` windows holding counter increments,
    gauge last-writes, and latency histograms; keeps the most recent
    ``horizon`` windows and drops older ones as time advances."""

    def __init__(self, window_s: float = 1.0, horizon: int = 256,
                 histogram_kw: Optional[dict] = None):
        if window_s <= 0:
            raise ValueError(f"window_s must be positive, got {window_s}")
        if horizon < 1:
            raise ValueError(f"horizon must be >= 1, got {horizon}")
        self.window_s = float(window_s)
        self.horizon = int(horizon)
        self.hist_kw = dict(histogram_kw or {})
        self._counters: dict = {}        # widx -> {key: value}
        self._gauges: dict = {}          # widx -> {key: (ts, value)}
        self._hists: dict = {}           # widx -> {key: LatencyHistogram}
        self._snapshot: dict = {}        # cumulative-counter ingest state

    def _widx(self, ts: float) -> int:
        return int(ts // self.window_s)

    def _trim(self) -> None:
        tops = [max(d) for d in (self._counters, self._gauges, self._hists)
                if d]
        if not tops:
            return
        cut = max(tops) - self.horizon
        for d in (self._counters, self._gauges, self._hists):
            for i in [i for i in d if i <= cut]:
                del d[i]

    # -- observation ---------------------------------------------------------
    def observe_counter(self, name: str, value: float, *, ts: float,
                        **labels) -> None:
        key = _key(name, labels)
        w = self._counters.setdefault(self._widx(ts), {})
        w[key] = w.get(key, 0.0) + value
        self._trim()

    def observe_gauge(self, name: str, value: float, *, ts: float,
                      **labels) -> None:
        key = _key(name, labels)
        w = self._gauges.setdefault(self._widx(ts), {})
        prev = w.get(key)
        if prev is None or ts >= prev[0]:
            w[key] = (ts, value)
        self._trim()

    def observe_latency(self, name: str, latency_s: float, *, ts: float,
                        **labels) -> None:
        key = _key(name, labels)
        w = self._hists.setdefault(self._widx(ts), {})
        h = w.get(key)
        if h is None:
            h = w[key] = LatencyHistogram(**self.hist_kw)
        h.record(latency_s)
        self._trim()

    def ingest_metrics(self, metrics, *, ts: float) -> None:
        """Diff a cumulative ``MetricsRegistry`` snapshot against the last
        ingest: counter deltas land in ``ts``'s window (so repeated polls
        of one registry become per-window rates), gauges overwrite."""
        snap = metrics.to_json()
        w = self._counters.setdefault(self._widx(ts), {})
        for key, value in snap["counters"].items():
            delta = value - self._snapshot.get(key, 0.0)
            self._snapshot[key] = value
            if delta > 0:
                w[key] = w.get(key, 0.0) + delta
        gw = self._gauges.setdefault(self._widx(ts), {})
        for key, value in snap["gauges"].items():
            if isinstance(value, (int, float)) \
                    and not isinstance(value, bool):
                prev = gw.get(key)
                if prev is None or ts >= prev[0]:
                    gw[key] = (ts, float(value))
        self._trim()

    # -- merge (the disagg roles' roll-up) -----------------------------------
    def merge(self, other: "WindowAggregator") -> "WindowAggregator":
        """Fold ``other``'s windows into this aggregator (same window
        size required). Histograms are copied, not aliased, so merging
        never mutates the source role's telemetry."""
        if other.window_s != self.window_s:
            raise ValueError(
                f"window sizes differ: {self.window_s} vs "
                f"{other.window_s}; resample before merging")
        for i, w in other._counters.items():
            mine = self._counters.setdefault(i, {})
            for key, value in w.items():
                mine[key] = mine.get(key, 0.0) + value
        for i, w in other._gauges.items():
            mine = self._gauges.setdefault(i, {})
            for key, (ts, value) in w.items():
                prev = mine.get(key)
                if prev is None or ts >= prev[0]:
                    mine[key] = (ts, value)
        for i, w in other._hists.items():
            mine = self._hists.setdefault(i, {})
            for key, h in w.items():
                if key in mine:
                    mine[key].merge(h)
                else:
                    mine[key] = LatencyHistogram.from_json(h.to_json())
        self._trim()
        return self

    # -- reads ---------------------------------------------------------------
    def window_indices(self) -> list:
        idx = set(self._counters) | set(self._gauges) | set(self._hists)
        return sorted(idx)

    def rates(self, window: Optional[int] = None) -> dict:
        """Per-second counter rates for one window (latest by default)."""
        if window is None:
            if not self._counters:
                return {}
            window = max(self._counters)
        w = self._counters.get(window, {})
        return {key: value / self.window_s for key, value in w.items()}

    def quantiles(self, window: Optional[int] = None,
                  qs=(50, 95, 99)) -> dict:
        if window is None:
            if not self._hists:
                return {}
            window = max(self._hists)
        out = {}
        for key, h in self._hists.get(window, {}).items():
            out[key] = {f"p{q}": h.percentile(q) for q in qs}
        return out

    def to_json(self) -> dict:
        windows = {}
        for i in self.window_indices():
            windows[str(i)] = {
                "start_s": i * self.window_s,
                "counters": dict(sorted(
                    self._counters.get(i, {}).items())),
                "gauges": {k: v for k, (_, v) in sorted(
                    self._gauges.get(i, {}).items())},
                "quantiles": self.quantiles(i) if i in self._hists else {},
            }
        return {"window_s": self.window_s, "horizon": self.horizon,
                "windows": windows}


# --------------------------------------------------------------------------
# OpenMetrics text exposition
# --------------------------------------------------------------------------

_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def _om_name(name: str) -> str:
    n = _NAME_BAD.sub("_", name)
    if not n or not (n[0].isalpha() or n[0] in "_:"):
        n = "_" + n
    return n


def _om_value(v) -> str:
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _om_labels(labels: dict) -> str:
    if not labels:
        return ""
    parts = []
    for k in sorted(labels):
        v = str(labels[k]).replace("\\", "\\\\") \
            .replace('"', '\\"').replace("\n", "\\n")
        parts.append(f'{_om_name(k)}="{v}"')
    return "{" + ",".join(parts) + "}"


class _Family:
    def __init__(self, om_type: str, help_text: str):
        self.om_type = om_type
        self.help = help_text
        self.samples: list = []          # (suffix, labels, value)


def openmetrics_text(*, metrics=None, ledger=None, aggregator=None,
                     histograms: Optional[dict] = None) -> str:
    """Render one OpenMetrics text exposition (ends with ``# EOF``).

    ``metrics`` is a ``MetricsRegistry`` (counters as ``*_total``, gauges
    verbatim); ``ledger`` a ``BandwidthLedger`` (per-dimension byte totals
    and per-link efficiency); ``aggregator`` contributes latest-window
    per-second rates; ``histograms`` maps metric name ->
    ``LatencyHistogram`` rendered as a quantile summary.
    """
    fams: dict = {}

    def fam(name: str, om_type: str, help_text: str) -> _Family:
        f = fams.get(name)
        if f is None:
            f = fams[name] = _Family(om_type, help_text)
        return f

    if metrics is not None:
        snap = metrics.to_json()
        for key, value in snap["counters"].items():
            name, labels = parse_key(key)
            f = fam(_om_name(name), "counter",
                    f"cumulative total of {name}")
            f.samples.append(("_total", labels, value))
        for key, value in snap["gauges"].items():
            if not isinstance(value, (int, float)) \
                    or isinstance(value, bool):
                continue
            name, labels = parse_key(key)
            f = fam(_om_name(name), "gauge", f"last value of {name}")
            f.samples.append(("", labels, value))

    if ledger is not None:
        f = fam("repro_ledger_bytes", "counter",
                "wire bytes charged per link, QoS class, purpose and "
                "request class")
        for row in ledger.entries():
            f.samples.append(("_total", {
                "link": row["link"], "qos": row["qos"],
                "purpose": row["purpose"],
                "request_class": row["request_class"]}, row["bytes"]))
        f = fam("repro_link_bytes", "counter", "wire bytes per link")
        for link, nb in sorted(ledger.link_totals().items()):
            f.samples.append(("_total", {"link": link}, nb))
        f = fam("repro_link_efficiency", "gauge",
                "bottlenecked goodput / calibrated ceiling per link")
        for link, eff in sorted(ledger.efficiency().items()):
            f.samples.append(("", {"link": link}, eff["efficiency"]))

    if aggregator is not None:
        for key, rate in sorted(aggregator.rates().items()):
            name, labels = parse_key(key)
            f = fam(_om_name(name) + "_rate", "gauge",
                    f"latest-window per-second rate of {name}")
            f.samples.append(("", labels, rate))

    for name, hist in sorted((histograms or {}).items()):
        f = fam(_om_name(name), "summary", f"latency quantiles of {name}")
        for q in (0.5, 0.95, 0.99):
            f.samples.append(("", {"quantile": repr(q)},
                              hist.percentile(q * 100)))
        f.samples.append(("_count", {}, hist.count))

    lines = []
    for name in sorted(fams):
        f = fams[name]
        lines.append(f"# TYPE {name} {f.om_type}")
        lines.append(f"# HELP {name} {f.help}")
        for suffix, labels, value in f.samples:
            lines.append(
                f"{name}{suffix}{_om_labels(labels)} {_om_value(value)}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


OPENMETRICS_CONTENT_TYPE = \
    "application/openmetrics-text; version=1.0.0; charset=utf-8"


def write_openmetrics(path: str, text: str) -> None:
    with open(path, "w") as f:
        f.write(text)


def serve_openmetrics(render: Callable[[], str], host: str = "127.0.0.1",
                      port: int = 9464):
    """Serve ``render()`` at ``/metrics`` (and ``/``) on a daemon thread;
    returns the ``ThreadingHTTPServer`` (``.server_port`` for port 0,
    ``.shutdown()`` to stop). Stdlib-only by design."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self):                              # noqa: N802
            if self.path.split("?")[0] not in ("/", "/metrics"):
                self.send_error(404)
                return
            body = render().encode("utf-8")
            self.send_response(200)
            self.send_header("Content-Type", OPENMETRICS_CONTENT_TYPE)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):                  # quiet scrapes
            pass

    server = ThreadingHTTPServer((host, port), _Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True,
                              name="openmetrics")
    thread.start()
    return server
