"""Observability: the tracer (events) and the metrics registry (aggregates).

The port's copies of the reference's ``repro.obs.trace`` and
``repro.obs.metrics``; exporters, attribution, SLO monitoring and the rest
of ``repro.obs`` come with the slices that use them.
"""

from repro_torch.obs.metrics import (NULL_METRICS, MetricsRegistry,  # noqa: F401
                                     NullMetrics)
from repro_torch.obs.trace import (NULL_TRACER, NullTracer,  # noqa: F401
                                   TraceEvent, Tracer)
