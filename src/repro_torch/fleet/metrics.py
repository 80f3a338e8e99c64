"""Fleet/time metric aggregation for trace replays — port of
``repro.fleet.metrics`` (numpy only).

Extends the paper's snapshot metrics (repro_torch.core.metrics) over TIME
(cost integral, SLO-violation ticks, churn) and over the FLEET (tenant
aggregates).

Metric definitions (see docs/fleet.md for the full glossary):

* cost integral — sum over ticks of the allocation's $/hr ($ for 1h ticks).
* SLO-violation ticks — ticks where provided capacity < demand on any
  resource (the snapshot metric's ``satisfied`` flag, counted over time).
* churn — L1 distance between consecutive allocations, summed over ticks:
  the number of node adds+removes the plan asked operations to execute.
* fragmentation — providers in use per tick (mean over the trace).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from ..core.metrics import AllocationMetrics
from ..obs.health import HealthReport


@dataclass
class TenantReplayMetrics:
    """One tenant's trace replay, integrated over ticks."""

    name: str
    ticks: int
    cost_integral: float          # sum over ticks of $/hr (== $ for 1h ticks)
    slo_violation_ticks: int      # ticks where provided < demand
    total_churn: float            # sum ||x_t - x_{t-1}||_1
    mean_utilization_pct: float
    mean_fragmentation: float     # mean providers used per tick
    mean_diversity: float         # mean distinct instance types per tick
    peak_cost: float
    max_churn_violation: float = 0.0  # worst per-tick excess over delta_max
    # per-tick PGD iteration counts (ControllerStep.solver_iters; 0 on cold
    # ticks). compare=False: solver effort is diagnostics — last-ulp
    # differences shift Armijo accepts by a few iterations while the
    # rounded allocations agree.
    solver_iters: Optional[List[int]] = field(default=None, compare=False)

    @property
    def slo_violation_rate(self) -> float:
        return self.slo_violation_ticks / max(self.ticks, 1)


def tenant_metrics(name: str, steps: Sequence[AllocationMetrics],
                   churns: Sequence[float],
                   churn_violations: Optional[Sequence[float]] = None,
                   solver_iters: Optional[Sequence[int]] = None
                   ) -> TenantReplayMetrics:
    """Integrate one tenant's per-tick snapshot metrics over the trace (see
    the module docstring for each metric's definition).
    ``churn_violations`` are the per-tick ``ControllerStep.churn_violation``
    values (the rounded allocation's excess over ``delta_max``);
    ``solver_iters`` the per-tick ``ControllerStep.solver_iters``, which feed
    the fleet-level iteration percentiles."""
    costs = np.asarray([s.total_cost for s in steps], np.float64)
    return TenantReplayMetrics(
        name=name,
        ticks=len(steps),
        cost_integral=float(costs.sum()),
        slo_violation_ticks=int(sum(not s.satisfied for s in steps)),
        total_churn=float(np.sum(churns)),
        mean_utilization_pct=float(np.mean([s.utilization_pct for s in steps])),
        mean_fragmentation=float(np.mean([s.provider_fragmentation
                                          for s in steps])),
        mean_diversity=float(np.mean([s.instance_diversity for s in steps])),
        peak_cost=float(costs.max()),
        max_churn_violation=(float(np.max(churn_violations))
                             if churn_violations is not None
                             and len(churn_violations) else 0.0),
        solver_iters=(None if solver_iters is None
                      else [int(i) for i in solver_iters]),
    )


@dataclass
class FleetReplayMetrics:
    """Aggregate over all tenants; optionally paired with the Cluster-
    Autoscaler ``baseline`` replayed on the same traces
    (``replay_fleet(run_ca_baseline=True)``, one entry per tenant).

    ``replay_mode`` and ``controller`` record which engine and control loop
    produced the histories (provenance only). ``oracle`` optionally holds
    the same fleet replayed by the MPC controller under the ground-truth
    oracle forecaster (``replay_fleet(run_oracle_baseline=True)``): the
    regret reference. ``health`` is the rolled-up
    ``repro_torch.obs.HealthReport`` of a replay run with a
    ``HealthMonitor`` (``replay_fleet(health=...)``), surfaced by
    ``summary()``; compare=False, since it holds wall-clock observations."""

    tenants: List[TenantReplayMetrics]
    baseline: Optional[List[TenantReplayMetrics]] = None
    replay_mode: str = "batched"
    controller: str = "myopic"
    oracle: Optional[List[TenantReplayMetrics]] = None
    health: Optional[HealthReport] = field(default=None, compare=False)

    @property
    def total_cost_integral(self) -> float:
        return sum(t.cost_integral for t in self.tenants)

    @property
    def total_slo_violation_ticks(self) -> int:
        return sum(t.slo_violation_ticks for t in self.tenants)

    @property
    def total_churn(self) -> float:
        return sum(t.total_churn for t in self.tenants)

    @property
    def mean_fragmentation(self) -> float:
        return float(np.mean([t.mean_fragmentation for t in self.tenants]))

    @property
    def total_tenant_ticks(self) -> int:
        """Sum of per-tenant tick counts (well-defined for ragged
        horizons)."""
        return sum(t.ticks for t in self.tenants)

    @property
    def max_churn_violation(self) -> float:
        """Fleet-wide worst per-tick excess of realized churn over
        ``delta_max`` (rounding's feasibility-first overshoot)."""
        return max((t.max_churn_violation for t in self.tenants), default=0.0)

    @property
    def solver_iters_percentiles(self) -> Optional[dict]:
        """Fleet-wide per-tick PGD iteration percentiles (p50/p95/max) over
        WARM ticks (cold ticks report 0 and are excluded); None when no
        warm tick recorded any."""
        vals = [i for t in self.tenants if t.solver_iters is not None
                for i in t.solver_iters if i > 0]
        if not vals:
            return None
        arr = np.asarray(vals, np.float64)
        return {"p50": float(np.percentile(arr, 50)),
                "p95": float(np.percentile(arr, 95)),
                "max": int(arr.max())}

    @property
    def baseline_cost_integral(self) -> Optional[float]:
        if self.baseline is None:
            return None
        return sum(t.cost_integral for t in self.baseline)

    @property
    def oracle_cost_integral(self) -> Optional[float]:
        if self.oracle is None:
            return None
        return sum(t.cost_integral for t in self.oracle)

    @property
    def regret_vs_oracle(self) -> Optional[float]:
        """Cost-integral regret against the oracle-forecast replay of the
        same fleet and controller: cost(this run) - cost(oracle run), the
        price of forecast error."""
        base = self.oracle_cost_integral
        if base is None:
            return None
        return self.total_cost_integral - base

    @property
    def cost_savings_vs_baseline_pct(self) -> Optional[float]:
        base = self.baseline_cost_integral
        if base is None or base <= 0:
            return None
        return 100.0 * (base - self.total_cost_integral) / base

    def summary(self) -> str:
        # horizons may be ragged — report the range, not tenants[0]'s length
        ticks = sorted({t.ticks for t in self.tenants})
        if not ticks:
            horizon = "0 ticks"
        elif len(ticks) == 1:
            horizon = f"{ticks[0]} ticks"
        else:
            horizon = (f"{self.total_tenant_ticks} tenant-ticks "
                       f"(ragged horizons {ticks[0]}-{ticks[-1]})")
        lines = [
            f"fleet of {len(self.tenants)} tenants, {horizon} "
            f"({self.replay_mode} replay, {self.controller} controller)",
            f"  cost integral      : ${self.total_cost_integral:,.2f}",
            f"  SLO violation ticks: {self.total_slo_violation_ticks}",
            f"  total churn (L1)   : {self.total_churn:,.1f}",
            f"  max churn overrun  : {self.max_churn_violation:.1f} "
            f"(worst per-tick excess over delta_max)",
            f"  mean fragmentation : {self.mean_fragmentation:.2f} providers",
        ]
        pct = self.solver_iters_percentiles
        if pct is not None:
            lines.append(f"  solver iters/tick  : p50 {pct['p50']:.0f}, "
                         f"p95 {pct['p95']:.0f}, max {pct['max']} "
                         f"(warm ticks)")
        if self.baseline is not None:
            lines.append(f"  CA baseline cost   : "
                         f"${self.baseline_cost_integral:,.2f}")
            lines.append(f"  savings vs CA      : "
                         f"{self.cost_savings_vs_baseline_pct:+.1f}%")
        if self.oracle is not None:
            lines.append(f"  oracle-MPC cost    : "
                         f"${self.oracle_cost_integral:,.2f}")
            lines.append(f"  regret vs oracle   : "
                         f"${self.regret_vs_oracle:+,.2f}")
        if self.health is not None:
            lines.extend(self.health.summary_lines())
        return "\n".join(lines)
