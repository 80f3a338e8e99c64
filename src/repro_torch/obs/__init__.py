"""repro_torch.obs — observability: spans, metrics and health (port of
``repro.obs``, the parts the serving path and the replay report through).

* :mod:`repro_torch.obs.telemetry` — contextvar-scoped nested timing spans,
  counters and gauges; a no-op when disabled; compile-vs-execute tagging
  and ``torch.cuda.synchronize`` fencing of device work.
* :mod:`repro_torch.obs.metrics` — typed metric registry (counters,
  gauges, fixed-bucket log2 histograms with p50/p95/p99), the device-side
  ``bucket_counts`` with a host merge per tick, Prometheus textfile and
  JSON snapshot exporters; a no-op when disabled.
* :mod:`repro_torch.obs.health` — per-tick health monitoring for
  ``replay_fleet`` and the ``ServeEngine``: committed-tick KKT gauges,
  SLO/churn/spot breach counters, solver stall detection, non-finite
  guards, the observe-only deadline budget.

Not ported yet: ``solver_trace``, ``export``, ``report``, ``provenance``
and ``regress``.

Design rule: observability may measure the system but never participate
in it — allocations are bit-identical with telemetry, metrics and health
monitoring on or off.
"""
from .telemetry import (Recorder, Span, SpanEvent, counter, current_recorder,
                        gauge, span, telemetry)
from .metrics import (Counter, Gauge, HistCounts, Histogram, MetricRegistry,
                      bucket_counts, collect_metrics, current_metrics, inc,
                      observe, observe_counts, set_gauge)
from .health import HealthEvent, HealthMonitor, HealthReport

__all__ = [
    "Recorder", "Span", "SpanEvent", "telemetry", "current_recorder",
    "span", "counter", "gauge",
    "Counter", "Gauge", "Histogram", "HistCounts", "MetricRegistry",
    "bucket_counts", "collect_metrics", "current_metrics", "inc",
    "set_gauge", "observe", "observe_counts",
    "HealthEvent", "HealthMonitor", "HealthReport",
]
