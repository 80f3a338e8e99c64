"""``ReplayReport`` — aggregate an instrumented replay into numbers — port
of ``repro.obs.report``.

The instrumented call sites (``fleet/replay.py``, ``fleet/batching.py``,
``horizon/controller.py``) emit spans under a small stable namespace, the
reference's:

* ``replay/tick`` — one span per replayed tick (both engines), tagged with
  ``tick`` / ``engine`` / ``controller``;
* ``replay/stack``, ``replay/solve``, ``replay/round``,
  ``replay/metrics`` — the phases inside a tick (solve spans carry a
  ``compile_key`` so their first occurrence is tagged ``phase="compile"``:
  on the card it includes loading the kernels and the first launches);
* gauge ``stack/padding_waste`` — padded-cell waste fraction per stacked
  bucket; gauge ``replay/solver_iters`` — per-tick summed PGD iterations.

:class:`ReplayReport` rolls a recorder up along those conventions: per-name
phase stats with compile/execute split and p50/p95/p99 over steady-state
spans, per-tick latency percentiles, padding-waste and solver-iters
distributions. It renders as a text table (``render()``) and exports as a
JSON-ready dict (``to_dict()`` — the ``telemetry`` section of a BENCH
JSON). It degrades gracefully: a recorder with none of the replay spans
produces an empty-but-valid report, so the aggregation works for any
instrumented region, not just replays.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .telemetry import Recorder

__all__ = ["PhaseStats", "ReplayReport", "percentiles"]


def percentiles(values: Sequence[float],
                qs: Sequence[float] = (50, 95, 99)) -> Dict[str, float]:
    """``{"p50": ..., "p95": ...}`` over ``values`` (empty dict if none)."""
    arr = np.asarray(list(values), dtype=float)
    if arr.size == 0:
        return {}
    return {f"p{int(q)}": float(np.percentile(arr, q)) for q in qs}


@dataclass
class PhaseStats:
    """Rollup of all spans sharing one name.

    ``compile_ms`` sums spans tagged ``phase="compile"`` (first call per
    ``compile_key`` — on the card it includes loading the kernels);
    ``execute_ms`` sums the steady-state rest. The percentile fields are over steady-state spans
    only (compile outliers would swamp them); when a name never declared a
    compile key every span counts as steady-state."""

    name: str
    count: int
    total_ms: float
    compile_ms: float
    execute_ms: float
    p50_ms: Optional[float] = None
    p95_ms: Optional[float] = None
    p99_ms: Optional[float] = None

    def to_dict(self) -> Dict[str, Any]:
        """JSON-ready dict of the rollup."""
        return {"name": self.name, "count": self.count,
                "total_ms": self.total_ms, "compile_ms": self.compile_ms,
                "execute_ms": self.execute_ms, "p50_ms": self.p50_ms,
                "p95_ms": self.p95_ms, "p99_ms": self.p99_ms}


@dataclass
class ReplayReport:
    """Aggregated view of one instrumented run (see module docstring)."""

    n_ticks: int = 0
    tick_ms: Dict[str, float] = field(default_factory=dict)
    phases: List[PhaseStats] = field(default_factory=list)
    compile_ms: float = 0.0
    execute_ms: float = 0.0
    padding_waste: Dict[str, float] = field(default_factory=dict)
    solver_iters: Dict[str, float] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)

    @classmethod
    def from_recorder(cls, rec: Recorder) -> "ReplayReport":
        """Build the report by rolling up a recorder's spans and gauges."""
        by_name: Dict[str, list] = {}
        for e in rec.events:
            by_name.setdefault(e.name, []).append(e)

        phases = []
        for name in sorted(by_name):
            evs = by_name[name]
            comp = [e for e in evs if e.phase == "compile"]
            steady = [e for e in evs if e.phase != "compile"]
            pcts = percentiles([e.dur_us / 1e3 for e in steady],
                               (50, 95, 99))
            phases.append(PhaseStats(
                name=name, count=len(evs),
                total_ms=sum(e.dur_us for e in evs) / 1e3,
                compile_ms=sum(e.dur_us for e in comp) / 1e3,
                execute_ms=sum(e.dur_us for e in steady) / 1e3,
                p50_ms=pcts.get("p50"), p95_ms=pcts.get("p95"),
                p99_ms=pcts.get("p99")))

        ticks = by_name.get("replay/tick", [])
        waste = [v for _, v in rec.gauges.get("stack/padding_waste", [])]
        iters = [v for _, v in rec.gauges.get("replay/solver_iters", [])]
        iters_stats = percentiles(iters, (50, 95))
        if iters:
            iters_stats["max"] = float(max(iters))
            iters_stats["total"] = float(sum(iters))
        waste_stats: Dict[str, float] = {}
        if waste:
            waste_stats = {"mean": float(np.mean(waste)),
                           "max": float(max(waste))}
        return cls(
            n_ticks=len(ticks),
            tick_ms=percentiles([e.dur_us / 1e3 for e in ticks],
                                (50, 95, 99)),
            phases=phases,
            compile_ms=sum(p.compile_ms for p in phases),
            execute_ms=sum(p.execute_ms for p in phases),
            padding_waste=waste_stats,
            solver_iters=iters_stats,
            counters=dict(rec.counters))

    def to_dict(self) -> Dict[str, Any]:
        """JSON-ready dict — embedded as the BENCH ``telemetry`` section."""
        return {
            "n_ticks": self.n_ticks,
            "tick_ms": self.tick_ms,
            "compile_ms": self.compile_ms,
            "execute_ms": self.execute_ms,
            "phases": [p.to_dict() for p in self.phases],
            "padding_waste": self.padding_waste,
            "solver_iters": self.solver_iters,
            "counters": self.counters,
        }

    def render(self) -> str:
        """Human-readable text summary of the run."""
        lines = [f"replay report: {self.n_ticks} ticks, "
                 f"compile {self.compile_ms:.1f}ms, "
                 f"execute {self.execute_ms:.1f}ms"]
        if self.tick_ms:
            lines.append(
                "  tick latency  p50 {p50:.2f}ms  p95 {p95:.2f}ms  "
                "p99 {p99:.2f}ms".format(**self.tick_ms))
        if self.phases:
            lines.append(f"  {'phase':<28s} {'n':>5s} {'total':>10s} "
                         f"{'compile':>9s} {'p50':>8s} {'p99':>8s}")
            for p in self.phases:
                p50 = f"{p.p50_ms:.2f}" if p.p50_ms is not None else "-"
                p99 = f"{p.p99_ms:.2f}" if p.p99_ms is not None else "-"
                lines.append(f"  {p.name:<28s} {p.count:>5d} "
                             f"{p.total_ms:>8.1f}ms {p.compile_ms:>7.1f}ms "
                             f"{p50:>8s} {p99:>8s}")
        if self.padding_waste:
            lines.append("  padding waste  mean {mean:.1%}  max {max:.1%}"
                         .format(**self.padding_waste))
        if self.solver_iters:
            si = self.solver_iters
            lines.append(f"  solver iters/tick  p50 {si.get('p50', 0):.0f}"
                         f"  p95 {si.get('p95', 0):.0f}"
                         f"  max {si.get('max', 0):.0f}"
                         f"  total {si.get('total', 0):.0f}")
        for name in sorted(self.counters):
            lines.append(f"  counter {name:<24s} {self.counters[name]:g}")
        return "\n".join(lines)
