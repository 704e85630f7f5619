"""repro_torch.obs — observability for the port's serving runtime (the
port's copy of ``repro.obs``).

Four facilities behind one :class:`~repro_torch.obs.observe.Observability`
bundle a :class:`~repro_torch.runtime.serve.Server` accepts via ``obs=``:

* :mod:`~repro_torch.obs.trace` — per-request lifecycle spans and
  per-tick engine events on the tick clock + wall clock, exported as a
  single JSON document that is both a schema'd artifact and a
  Perfetto/``chrome://tracing``-loadable timeline;
* :mod:`~repro_torch.obs.metrics` — counters / gauges / log-bucket
  histograms with a snapshot API and Prometheus text exposition;
* :mod:`~repro_torch.obs.profile` — per-tick phase attribution (decode vs
  speculate vs prefill vs COW copies vs host), each phase's devices
  synchronized before its clock is read;
* :mod:`~repro_torch.obs.monitor` — the online direction-2
  model-conformance check: the live paged allocator's op stream
  continuously validated against the verified abstract model
  (:mod:`repro_torch.verify`), with a replayable trail on violation.

``python -m repro_torch.obs`` summarizes, schema-checks, and re-exports
recorded traces.
"""

from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .monitor import ConformanceMonitor
from .observe import Observability
from .profile import PhaseProfiler
from .trace import (TRACE_KIND, TRACE_SCHEMA, Span, TraceRecorder,
                    chrome_events, export_trace, parse_trace,
                    spans_from_events, validate_trace)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "ConformanceMonitor", "Observability", "PhaseProfiler",
           "TRACE_KIND", "TRACE_SCHEMA", "Span", "TraceRecorder",
           "chrome_events", "export_trace", "parse_trace",
           "spans_from_events", "validate_trace"]
