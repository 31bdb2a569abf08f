"""repro_torch.obs — tracing + metrics for the fabric-to-serving stack.

The port's copy of the reference's ``repro/obs``, emitting from every
layer named below.

The paper's core method is observation: Heimdall exposes what the
interconnect is actually doing, and every optimization follows from seeing
those timelines. This package is the runtime counterpart for our stack —
one shared event vocabulary threaded through every layer that moves bytes
or makes a scheduling decision:

  * ``fabric.sim.simulate(tracer=)``      — per-flow lifecycle spans and
                                            per-link utilization timelines
  * ``serving.pager`` / ``PagedKVCache``  — spill/fetch/append spans,
                                            hit/miss/bytes counters per tier
  * ``launch.serve`` (engine + scheduler) — admission, deadline slack,
                                            per-step decode spans,
                                            straggler statistics
  * ``calibrate.validate``                — truth/calibrated/nominal
                                            provenance tags on replays

And the consumers that turn that firehose into answers:

  * ``attribution`` — per-request critical-path latency breakdown
    (link-wait by (link, QoS class), scheduler wait, compute) from the
    events above; ``attribution_summary`` ranks "why was this slow".
  * ``slo`` — streaming per-class SLO state: mergeable log-scale latency
    histograms (``LatencyHistogram``) and burn-rate alerting
    (``SLOMonitor``), no per-request storage.
  * ``recorder`` — ``FlightRecorder``, a bounded ring-buffer tracer that
    snapshots the failing window to a Perfetto-loadable dump on alert.
  * ``drift`` — ``DriftSentinel``, observed per-route transfer timings
    replayed against ``CalibrationProfile`` predictions (Cohet-style
    continuous re-validation); its ``on_flag`` rising edge is what
    triggers ``calibrate.recal`` auto-recalibration.
  * ``ledger`` — ``BandwidthLedger``, always-on per-window byte
    accounting over the fabric flow stream: every wire byte charged to
    (link, QoS class, purpose, request class), conservation-reconciled
    against timelines/FlowResults, per-link efficiency vs the calibrated
    ceiling.
  * ``timeseries`` — ``WindowAggregator`` fixed-window rates/gauges/
    histogram quantiles (mergeable across the disagg roles) and the
    OpenMetrics text exposition (``openmetrics_text`` /
    ``serve_openmetrics``).

Exports: ``Tracer`` (spans, instants, async flows, counters; injectable
deterministic clock), ``NullTracer``/``NULL_TRACER`` (free when disabled),
``MetricsRegistry`` (labeled counters/gauges, ``to_json`` snapshot),
``chrome_trace``/``write_chrome_trace``/``ChromeTraceWriter``/
``recorder_trace`` (Perfetto-loadable export, incremental and
ring-sanitized paths), ``link_timelines`` (utilization reconstruction +
byte conservation).
"""

from repro_torch.obs.attribution import (RequestAttribution, Segment,
                                         attribute_requests,
                                         attribution_summary, event_cursor,
                                         events_since)
from repro_torch.obs.drift import DriftSentinel
from repro_torch.obs.export import (ChromeTraceWriter, chrome_trace,
                                    recorder_trace, validate_chrome_trace,
                                    write_chrome_trace)
from repro_torch.obs.ledger import (BandwidthLedger, classify_purpose,
                                    classify_request, link_ceilings)
from repro_torch.obs.metrics import (NULL_METRICS, MetricsRegistry,
                                     NullMetrics, parse_key)
from repro_torch.obs.recorder import FlightRecorder
from repro_torch.obs.slo import LatencyHistogram, SLOMonitor
from repro_torch.obs.timeline import LinkTimeline, link_timelines
from repro_torch.obs.timeseries import (OPENMETRICS_CONTENT_TYPE,
                                        WindowAggregator, openmetrics_text,
                                        serve_openmetrics, write_openmetrics)
from repro_torch.obs.trace import (DEFAULT_TRACK, NULL_TRACER, NullTracer,
                                   TraceEvent, Tracer)

__all__ = [
    "Tracer", "NullTracer", "NULL_TRACER", "TraceEvent", "DEFAULT_TRACK",
    "MetricsRegistry", "NullMetrics", "NULL_METRICS",
    "chrome_trace", "write_chrome_trace", "validate_chrome_trace",
    "ChromeTraceWriter", "recorder_trace",
    "LinkTimeline", "link_timelines",
    "RequestAttribution", "Segment", "attribute_requests",
    "attribution_summary", "event_cursor", "events_since",
    "LatencyHistogram", "SLOMonitor",
    "FlightRecorder", "DriftSentinel",
    "BandwidthLedger", "classify_purpose", "classify_request",
    "link_ceilings", "parse_key",
    "WindowAggregator", "openmetrics_text", "serve_openmetrics",
    "write_openmetrics", "OPENMETRICS_CONTENT_TYPE",
]
