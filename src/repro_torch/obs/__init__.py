"""repro_torch.obs — the port's observability, its first part.

* :mod:`~repro_torch.obs.trace` — per-request lifecycle spans and
  per-tick engine events on the tick clock + wall clock, exported as a
  single JSON document that is both a schema'd artifact and a
  Perfetto/``chrome://tracing``-loadable timeline;
  :func:`~repro_torch.runtime.workload.drive_trace` keeps its
  per-request bookkeeping in a :class:`TraceRecorder`;
* :mod:`~repro_torch.obs.metrics` — counters / gauges / log-bucket
  histograms with a snapshot API and Prometheus text exposition; the
  drain harnesses of :mod:`repro_torch.runtime.tunables` publish into a
  :class:`MetricsRegistry`.

The reference's ``Observability`` bundle (``Server(obs=)``), its phase
profiler, conformance monitor and CLI are not ported yet (ROADMAP queue
1, item 20).
"""

from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .trace import (TRACE_KIND, TRACE_SCHEMA, Span, TraceRecorder,
                    chrome_events, export_trace, parse_trace,
                    spans_from_events, validate_trace)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "TRACE_KIND", "TRACE_SCHEMA", "Span", "TraceRecorder",
           "chrome_events", "export_trace", "parse_trace",
           "spans_from_events", "validate_trace"]
