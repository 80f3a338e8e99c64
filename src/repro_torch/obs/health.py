"""Per-tick fleet health monitoring for ``replay_fleet`` and the
``ServeEngine`` — port of ``repro.obs.health``.

``repro_torch.obs.telemetry`` measures *time*; this module watches *health*: is
the solver actually solving, are SLOs holding, did a NaN sneak into an
allocation, did a tick blow its latency budget? A :class:`HealthMonitor`
rides along a replay (``replay_fleet(..., health=monitor)``) and, per
committed (tenant, tick):

* **KKT-residual gauges** — every ``kkt_every`` ticks the committed tick's
  RELAXED solution is certified through
  :func:`repro_torch.core.kkt.kkt_report` (on the problem's device: on the
  card its gradient is one launch of the ``alloc_objective`` kernel)
  (the paper's eq. 8-11 residuals; cold multistart ticks included). The
  worst stationarity residual and its (tenant, tick, solver) provenance are
  tracked — the continuous version of the one-off KKT certificate tests.
  Integer allocations are deliberately NOT certified: rounding leaves any
  integer point a bounded distance from stationarity, so its residual
  measures the grid, not the solver.
* **Breach counters** — SLO-breach ticks (the snapshot metric's
  ``satisfied`` flag), churn-bound violations
  (``ControllerStep.churn_violation > 0``) and spot-interruption ticks
  (any spot twin unavailable this tick).
* **Stall detection** — a warm solve whose merit went flat for
  ``stall_window`` trailing iterations (adaptive/fixed PGD traces), or an
  ADMM solve whose primal residual was non-decreasing for ``stall_window``
  trailing outer iterations (checked against its ``ADMMDiag`` certificate's
  final residual): both emit ``stall`` :class:`HealthEvent`\\ s — budget
  that bought nothing is a misconfiguration signal, not an error.
* **Non-finite guards** — NaN/Inf anywhere in the committed counts, the
  relaxed solution, or the KKT stationarity residual (the residual sees the
  gradient, so a non-finite gradient is caught here even when the iterate
  stayed finite) emits an ``error``-severity event with full provenance
  instead of silently propagating.
* **Deadline budget** — an observe-only per-tick ``deadline_ms``: tick
  durations (measured by the ENGINE via ``monitor.clock``, injectable for
  deterministic tests) land in a latency histogram and every overrun bumps
  a deadline-miss counter. Nothing is interrupted — the ENFORCED budget is
  ``core.pgd.AnytimeConfig`` (``replay_fleet(..., anytime=...)``,
  ``repro_torch.serve``); ticks whose solve that budget truncated are
  counted separately as ``deadline_truncated_ticks``. Ticks that are the
  FIRST sighting of their engine's ``compile_key`` pay one-off costs (on
  the card, loading the kernel library and the first launches), not
  steady-state solve latency; they are excluded from the miss counter and
  counted (and histogrammed) separately as ``compile_excluded_ticks``.

Everything is observe-only: the monitor never touches solver state, so
per-tenant integer allocations are bit-identical with health monitoring on
or off. Events are
structured :class:`HealthEvent` records with lane/tick/solver provenance;
:meth:`HealthMonitor.report` rolls everything into a :class:`HealthReport`
that ``FleetReplayMetrics.summary()`` surfaces. When a
:class:`repro_torch.obs.metrics.MetricRegistry` is attached (``registry=``), the
same signals are mirrored as ``health/*`` counters/gauges/histograms for
the Prometheus/JSON exporters.

Usage::

    from repro_torch.obs import HealthMonitor

    mon = HealthMonitor(deadline_ms=50.0)
    result = replay_fleet(catalog, tenants, replay_mode="batched",
                          health=mon, device="cpu")
    print(result.metrics.summary())        # includes the health section
    for ev in mon.report().events:
        print(ev.severity, ev.kind, ev.tenant, ev.tick, ev.message)
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .metrics import MetricRegistry

__all__ = ["HealthEvent", "HealthMonitor", "HealthReport"]

# cap on stored events: a pathological replay (every tick NaN) must not
# turn the monitor into an unbounded memory leak; counters keep counting.
DEFAULT_MAX_EVENTS = 1000


@dataclass(frozen=True)
class HealthEvent:
    """One structured health incident with full replay provenance.

    ``kind`` is the signal (``non_finite``, ``stall``, ``kkt_residual``);
    ``severity`` is ``"warn"`` or ``"error"``. ``lane`` is the batch lane
    (batched engines) or None (sequential). ``value`` carries the
    triggering number (residual, streak length, ...)."""

    kind: str
    severity: str
    tenant: str
    tick: int
    solver: str
    lane: Optional[int] = None
    value: Optional[float] = None
    message: str = ""

    def to_dict(self) -> Dict[str, Any]:
        """JSON-ready dict (numpy scalars coerced to Python floats)."""
        return {"kind": self.kind, "severity": self.severity,
                "tenant": self.tenant, "tick": self.tick,
                "solver": self.solver, "lane": self.lane,
                "value": None if self.value is None else float(self.value),
                "message": self.message}


@dataclass
class HealthReport:
    """The rolled-up output of one monitored replay (see module docstring).

    ``worst_kkt_stationarity`` is the max stationarity residual over every
    certified committed tick (None when no tick was certified);
    ``worst_kkt`` carries its (tenant, tick, solver) provenance.
    ``deadline_miss_ticks``/``deadline_ms`` are populated only when the
    monitor ran with a deadline budget."""

    events: List[HealthEvent] = field(default_factory=list)
    slo_breach_ticks: int = 0
    churn_violation_ticks: int = 0
    spot_interruption_ticks: int = 0
    deadline_miss_ticks: int = 0
    # first-sighting-of-compile-key ticks: their duration is dominated by
    # one-off costs, so they are excluded from the miss counter
    compile_excluded_ticks: int = 0
    # committed steps whose solve an ENFORCED anytime budget truncated
    deadline_truncated_ticks: int = 0
    stall_events: int = 0
    nonfinite_events: int = 0
    ticks_observed: int = 0
    kkt_ticks_certified: int = 0
    worst_kkt_stationarity: Optional[float] = None
    worst_kkt: Optional[Dict[str, Any]] = None
    deadline_ms: Optional[float] = None

    @property
    def error_count(self) -> int:
        """Number of error-severity events recorded (capped storage does
        not affect this — it counts emissions, not retained records)."""
        return self.nonfinite_events

    def to_dict(self) -> Dict[str, Any]:
        """JSON-ready dict for snapshots."""
        return {
            "slo_breach_ticks": self.slo_breach_ticks,
            "churn_violation_ticks": self.churn_violation_ticks,
            "spot_interruption_ticks": self.spot_interruption_ticks,
            "deadline_miss_ticks": self.deadline_miss_ticks,
            "compile_excluded_ticks": self.compile_excluded_ticks,
            "deadline_truncated_ticks": self.deadline_truncated_ticks,
            "stall_events": self.stall_events,
            "nonfinite_events": self.nonfinite_events,
            "ticks_observed": self.ticks_observed,
            "kkt_ticks_certified": self.kkt_ticks_certified,
            "worst_kkt_stationarity": self.worst_kkt_stationarity,
            "worst_kkt": self.worst_kkt,
            "deadline_ms": self.deadline_ms,
            "events": [e.to_dict() for e in self.events],
        }

    def summary_lines(self) -> List[str]:
        """The health section ``FleetReplayMetrics.summary()`` prints."""
        lines = [
            f"  health: SLO breaches  : {self.slo_breach_ticks} ticks",
            f"  health: churn overrun : {self.churn_violation_ticks} ticks",
        ]
        if self.spot_interruption_ticks:
            lines.append(f"  health: spot outages  : "
                         f"{self.spot_interruption_ticks} ticks")
        if self.deadline_ms is not None:
            lines.append(f"  health: deadline miss : "
                         f"{self.deadline_miss_ticks} ticks "
                         f"(budget {self.deadline_ms:g} ms, "
                         f"{self.compile_excluded_ticks} compile ticks "
                         f"excluded)")
        if self.deadline_truncated_ticks:
            lines.append(f"  health: anytime trunc : "
                         f"{self.deadline_truncated_ticks} steps")
        if self.worst_kkt_stationarity is not None:
            prov = self.worst_kkt or {}
            lines.append(
                f"  health: worst KKT stat: "
                f"{self.worst_kkt_stationarity:.3e} "
                f"(tenant {prov.get('tenant', '?')}, "
                f"tick {prov.get('tick', '?')})")
        if self.stall_events:
            lines.append(f"  health: solver stalls : {self.stall_events}")
        if self.nonfinite_events:
            lines.append(f"  health: NON-FINITE    : "
                         f"{self.nonfinite_events} events (ERROR)")
        return lines


def _finite_streak_tail(values: np.ndarray) -> np.ndarray:
    """Strip the fixed-shape trace's sentinel tail: keep the finite prefix
    (traces pad unused rows with NaN)."""
    v = np.asarray(values, np.float64).ravel()
    finite = np.isfinite(v)
    if finite.all():
        return v
    # the finite prefix ends at the first non-finite row
    end = int(np.argmin(finite))
    return v[:end]


def _flat_merit_streak(merit: np.ndarray, rtol: float = 1e-9) -> int:
    """Length of the TRAILING run of iterations that improved nothing:
    rows whose merit is not below the best merit seen before them (within
    ``rtol`` relative slack). A solve that converged early and sat at its
    solution also reports a long streak — the point: budget spent past this
    row bought nothing."""
    m = _finite_streak_tail(merit)
    if m.size < 2:
        return 0
    best = np.minimum.accumulate(m)
    tol = rtol * np.maximum(np.abs(best), 1.0)
    # row i "improved" iff it beat the best of rows [0, i)
    improved = m[1:] < best[:-1] - tol[:-1]
    streak = 0
    for flag in improved[::-1]:
        if flag:
            break
        streak += 1
    return streak


def _nondecreasing_tail(res: np.ndarray) -> int:
    """Length of the trailing run of NON-decreasing residuals (each row >=
    its predecessor) — ADMM's stall signature: outer iterations that are
    not contracting the primal residual."""
    r = _finite_streak_tail(res)
    if r.size < 2:
        return 0
    streak = 0
    for i in range(r.size - 1, 0, -1):
        if r[i] >= r[i - 1]:
            streak += 1
        else:
            break
    return streak


class HealthMonitor:
    """Observe-only per-tick health monitor for ``replay_fleet`` (module
    docstring has the full signal list).

    Knobs:

    * ``deadline_ms`` — per-tick latency budget; ticks over it bump the
      deadline-miss counter (observe-only: nothing is interrupted). None
      disables the budget (durations are still histogrammed).
    * ``kkt_every`` — certify every k-th committed tick per tenant through
      ``kkt_report`` (1 = every tick; 0 disables KKT entirely).
    * ``kkt_warn`` — optional stationarity threshold; residuals above it
      emit ``kkt_residual`` warn events (worst-residual tracking happens
      regardless).
    * ``stall_window`` — trailing no-improvement (PGD) or non-decrease
      (ADMM) streak length that counts as a stall.
    * ``registry`` — optional :class:`repro_torch.obs.metrics.MetricRegistry` to
      mirror every signal into (``health/*`` metrics for the exporters).
    * ``clock`` — the monotonic-seconds callable the ENGINES use to time
      ticks (``time.perf_counter`` by default; inject a fake for
      deterministic deadline tests).
    """

    def __init__(self, *, deadline_ms: Optional[float] = None,
                 kkt_every: int = 1, kkt_warn: Optional[float] = None,
                 stall_window: int = 20,
                 registry: Optional[MetricRegistry] = None,
                 max_events: int = DEFAULT_MAX_EVENTS,
                 clock: Callable[[], float] = time.perf_counter):
        if kkt_every < 0:
            raise ValueError(f"kkt_every must be >= 0, got {kkt_every}")
        if stall_window < 2:
            raise ValueError(f"stall_window must be >= 2, got {stall_window}")
        self.deadline_ms = deadline_ms
        self.kkt_every = int(kkt_every)
        self.kkt_warn = kkt_warn
        self.stall_window = int(stall_window)
        self.registry = registry
        self.max_events = int(max_events)
        self.clock = clock
        self._report = HealthReport(deadline_ms=deadline_ms)
        self._dropped_events = 0
        # engine compile keys already sighted once; the first tick carrying
        # a new key pays one-off costs and is excluded from the deadline
        # budget (see observe_tick)
        self._compile_seen: set = set()

    # -- event plumbing -----------------------------------------------------

    def _emit(self, ev: HealthEvent) -> None:
        if len(self._report.events) < self.max_events:
            self._report.events.append(ev)
        else:
            self._dropped_events += 1

    def _inc(self, name: str, v: float = 1.0) -> None:
        if self.registry is not None:
            self.registry.counter(name).inc(v)

    # -- per-committed-(tenant, tick) observation ---------------------------

    def observe_step(self, *, tenant: str, tick: int, step: Any, solver: str,
                     lane: Optional[int] = None, prob: Any = None,
                     x_rel: Optional[np.ndarray] = None, trace: Any = None,
                     diag: Any = None, spot_unavailable: int = 0) -> None:
        """Observe one committed (tenant, tick): ``step`` is the recorded
        ``ControllerStep``; ``prob``/``x_rel`` (this tick's problem and the
        solve's RELAXED solution) enable the KKT certificate;
        ``trace``/``diag`` (the solve's convergence rows / ADMM residual
        certificate, when captured) enable stall detection;
        ``spot_unavailable`` is the number of spot twins interrupted this
        tick. All optional inputs degrade gracefully — a monitor attached
        to an untraced replay still counts breaches and guards NaNs."""
        rep = self._report
        # breach counters ---------------------------------------------------
        if getattr(step, "deadline_hit", False):
            rep.deadline_truncated_ticks += 1
            self._inc("health/deadline_truncated_ticks")
        if not step.metrics.satisfied:
            rep.slo_breach_ticks += 1
            self._inc("health/slo_breach_ticks")
        if step.churn_violation > 0:
            rep.churn_violation_ticks += 1
            self._inc("health/churn_violation_ticks")
        if spot_unavailable > 0:
            rep.spot_interruption_ticks += 1
            self._inc("health/spot_interruption_ticks")
        # non-finite guards -------------------------------------------------
        counts = np.asarray(step.counts, np.float64)
        if not np.all(np.isfinite(counts)):
            self._nonfinite(tenant, tick, solver, lane,
                            "committed counts contain NaN/Inf")
        if x_rel is not None:
            xr = np.asarray(x_rel, np.float64)
            if not np.all(np.isfinite(xr)):
                self._nonfinite(tenant, tick, solver, lane,
                                "relaxed solution contains NaN/Inf")
                xr = None  # certifying a NaN iterate adds nothing
            x_rel = xr
        # KKT certificate on the committed tick's relaxed solution ----------
        if (prob is not None and x_rel is not None and self.kkt_every > 0
                and tick % self.kkt_every == 0):
            self._certify(tenant, tick, solver, lane, prob, x_rel)
        # stall detection ---------------------------------------------------
        if trace is not None:
            self._check_stall(tenant, tick, solver, lane, trace, diag)

    def _nonfinite(self, tenant: str, tick: int, solver: str,
                   lane: Optional[int], message: str,
                   value: Optional[float] = None) -> None:
        self._report.nonfinite_events += 1
        self._inc("health/nonfinite_events")
        self._emit(HealthEvent(kind="non_finite", severity="error",
                               tenant=tenant, tick=tick, solver=solver,
                               lane=lane, value=value, message=message))

    def _certify(self, tenant: str, tick: int, solver: str,
                 lane: Optional[int], prob: Any, x_rel: np.ndarray) -> None:
        """Run the KKT certificate on the problem's device and track the
        worst residual. The stationarity residual evaluates the objective
        GRADIENT at the iterate, so a non-finite gradient (e.g. a NaN cost)
        surfaces here even when the iterate itself stayed finite."""
        from ..core.kkt import kkt_report

        rep = kkt_report(prob, torch.as_tensor(x_rel, dtype=torch.float32,
                                               device=prob.device))
        stat = float(rep.stationarity)
        self._report.kkt_ticks_certified += 1
        if not math.isfinite(stat):
            self._nonfinite(tenant, tick, solver, lane,
                            "KKT stationarity residual is NaN/Inf "
                            "(non-finite objective gradient)", value=stat)
            return
        if self.registry is not None:
            self.registry.histogram("health/kkt_stationarity").observe(stat)
            self.registry.gauge("health/worst_kkt_stationarity").set(
                max(stat, self._report.worst_kkt_stationarity or 0.0))
        if (self._report.worst_kkt_stationarity is None
                or stat > self._report.worst_kkt_stationarity):
            self._report.worst_kkt_stationarity = stat
            self._report.worst_kkt = {"tenant": tenant, "tick": tick,
                                      "solver": solver, "lane": lane}
        if self.kkt_warn is not None and stat > self.kkt_warn:
            self._emit(HealthEvent(kind="kkt_residual", severity="warn",
                                   tenant=tenant, tick=tick, solver=solver,
                                   lane=lane, value=stat,
                                   message=f"stationarity {stat:.3e} above "
                                           f"threshold {self.kkt_warn:g}"))

    def _check_stall(self, tenant: str, tick: int, solver: str,
                     lane: Optional[int], trace: Any, diag: Any) -> None:
        """Duck-typed stall check: PGD traces carry ``merit`` rows, ADMM
        traces carry ``primal`` residual rows (duck typing avoids importing
        either solver module here)."""
        if hasattr(trace, "primal"):
            streak = _nondecreasing_tail(np.asarray(trace.primal))
            if streak >= self.stall_window:
                final = (float(np.asarray(diag.primal_res))
                         if diag is not None else None)
                self._stall(tenant, tick, solver, lane, streak,
                            f"ADMM primal residual non-decreasing for "
                            f"{streak} trailing outer iterations"
                            + (f" (certificate primal_res {final:.3e})"
                               if final is not None else ""))
        elif hasattr(trace, "merit"):
            streak = _flat_merit_streak(np.asarray(trace.merit))
            if streak >= self.stall_window:
                self._stall(tenant, tick, solver, lane, streak,
                            f"merit flat for {streak} trailing iterations")

    def _stall(self, tenant: str, tick: int, solver: str,
               lane: Optional[int], streak: int, message: str) -> None:
        self._report.stall_events += 1
        self._inc("health/stall_events")
        self._emit(HealthEvent(kind="stall", severity="warn", tenant=tenant,
                               tick=tick, solver=solver, lane=lane,
                               value=float(streak), message=message))

    # -- per-tick latency ---------------------------------------------------

    def observe_tick(self, tick: int, duration_ms: float,
                     compile_key=None) -> None:
        """Record one tick's wall-clock duration (measured by the engine via
        ``self.clock``; fleet-wide tick in the batched engines, per-tenant
        tick in the sequential engine) against the deadline budget.

        ``compile_key`` is the engine's tick-level program identity (a
        hashable tuple, same convention as telemetry span compile keys). A
        tick carrying a key this monitor has NOT seen before is a
        compile tick: its raw wall time is dominated by one-off costs,
        not the solve the budget governs, so it is counted (and
        histogrammed) under ``compile_excluded_ticks`` instead of being
        compared against ``deadline_ms``."""
        self._report.ticks_observed += 1
        if compile_key is not None and compile_key not in self._compile_seen:
            self._compile_seen.add(compile_key)
            self._report.compile_excluded_ticks += 1
            self._inc("health/compile_excluded_ticks")
            if self.registry is not None:
                self.registry.histogram(
                    "health/tick_compile_ms").observe(duration_ms)
            return
        if self.registry is not None:
            self.registry.histogram("health/tick_ms").observe(duration_ms)
        if self.deadline_ms is not None and duration_ms > self.deadline_ms:
            self._report.deadline_miss_ticks += 1
            self._inc("health/deadline_miss_ticks")

    # -- reading back -------------------------------------------------------

    def report(self) -> HealthReport:
        """The rolled-up :class:`HealthReport` (live object: a monitor can
        be read mid-replay)."""
        return self._report
