"""repro_torch.obs — observability: spans, metrics, health, solver traces,
exports, reports, provenance and the bench sentinel (port of
``repro.obs``, every name of its ``__all__``).

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
* :mod:`repro_torch.obs.solver_trace` — the per-iteration PGD and ADMM
  convergence records and host-side helpers that trim, slice and
  summarise them (records of tensors on the CPU or the card, or numpy).
* :mod:`repro_torch.obs.export` — JSONL and Perfetto-loadable Chrome trace
  export, plus the schema validators that
  ``python -m repro_torch.tools.trace_demo`` gates on.
* :mod:`repro_torch.obs.report` — ``ReplayReport``: per-phase
  compile/execute split, p50/p95/p99 tick latency, padding waste,
  solver-iters stats.
* :mod:`repro_torch.obs.provenance` — the provenance block (git SHA, torch
  and CUDA versions, backend, the card's name and power limit, config
  digest, seeds) for every BENCH JSON.
* :mod:`repro_torch.obs.regress` — the bench regression sentinel behind
  ``python -m repro_torch.tools.bench_compare``: provenance-aware
  BENCH-vs-BENCH comparison with per-class tolerances (a pinned copy).

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
from .solver_trace import (SolverTrace, admm_trace_summary, lane_trace,
                           trace_length, trace_summary, traces_to_dict,
                           trim_admm_trace, trim_trace)
from .export import (events_to_dicts, to_chrome_trace, validate_chrome_trace,
                     validate_jsonl, write_chrome_trace, write_jsonl)
from .report import PhaseStats, ReplayReport, percentiles
from .provenance import config_digest, git_sha, provenance_block
from .regress import (BenchComparison, MetricDelta, classify_metric,
                      compare_bench, numeric_leaves, validate_bench)


def __getattr__(name: str):
    # ADMMTrace is re-exported lazily (see solver_trace.__getattr__): the
    # record lives in repro_torch.horizon.admm, which transitively imports
    # this package — an eager import here would be circular.
    if name == "ADMMTrace":
        from .solver_trace import ADMMTrace
        return ADMMTrace
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "Recorder", "Span", "SpanEvent", "telemetry", "current_recorder",
    "span", "counter", "gauge",
    "Counter", "Gauge", "Histogram", "HistCounts", "MetricRegistry",
    "bucket_counts", "collect_metrics", "current_metrics", "inc",
    "set_gauge", "observe", "observe_counts",
    "HealthEvent", "HealthMonitor", "HealthReport",
    "SolverTrace", "trace_length", "lane_trace", "trim_trace",
    "trace_summary", "traces_to_dict",
    "ADMMTrace", "trim_admm_trace", "admm_trace_summary",
    "events_to_dicts", "write_jsonl", "to_chrome_trace",
    "write_chrome_trace", "validate_chrome_trace", "validate_jsonl",
    "PhaseStats", "ReplayReport", "percentiles",
    "git_sha", "provenance_block", "config_digest",
    "BenchComparison", "MetricDelta", "classify_metric", "compare_bench",
    "numeric_leaves", "validate_bench",
]
