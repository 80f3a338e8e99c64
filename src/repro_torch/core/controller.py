"""Infrastructure Optimization Controller (paper §I.C, §III.E) — the state
the batched fleet replay drives, ported from ``repro.core.controller``:
``make_problem``, ``apply_counts`` and the step history. ``step`` (whose
cold tick runs ``multistart_solve``) is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..device import DeviceLike
from .api import problem_from_demand
from .catalog import Catalog
from .metrics import AllocationMetrics, evaluate
from .problem import AllocationProblem, PenaltyParams


@dataclass
class ControllerStep:
    """One recorded tick: the demand seen, the allocation deployed, its
    snapshot metrics, the L1 churn paid, and whether it was a full replan
    (see ``repro.core.controller.ControllerStep``)."""

    demand: np.ndarray
    counts: np.ndarray
    metrics: AllocationMetrics
    churn: float                 # ||x_t - x_{t-1}||_1
    replanned: bool
    churn_violation: float = 0.0  # max(0, churn - delta_max) on warm ticks
    solver_iters: int = 0         # inner PGD iterations spent on this tick


@dataclass
class InfrastructureOptimizationController:
    """Per-cluster control-loop state: the current allocation under the L1
    churn bound ``delta_max`` and its history. ``device`` is where
    :meth:`make_problem` builds each tick's problem (None means "cuda")."""

    catalog: Catalog
    delta_max: float = 8.0                       # max L1 churn per tick
    params: Optional[PenaltyParams] = None
    n_starts: int = 4
    allowed_idx: Optional[np.ndarray] = None
    normalize: bool = True                       # demand-normalized solver units
    x_current: np.ndarray = None                 # set on first step
    history: List[ControllerStep] = field(default_factory=list)
    terms: tuple = ()
    spot_idx: Optional[np.ndarray] = None        # (S,) catalog spot-twin idx
    spot_availability: Optional[np.ndarray] = None   # (T', S) in {0, 1}
    device: DeviceLike = None

    def make_problem(self, demand: np.ndarray) -> AllocationProblem:
        """This tick's AllocationProblem (the tick index is
        ``len(self.history)``; the spot overlay reads availability row t,
        clamped to the last row)."""
        unavailable = None
        if self.spot_idx is not None and self.spot_availability is not None:
            avail = np.asarray(self.spot_availability)
            t = min(len(self.history), len(avail) - 1)
            spot = np.asarray(self.spot_idx, np.int64)
            unavailable = spot[avail[t] <= 0.0]
        return problem_from_demand(self.catalog, demand, params=self.params,
                                   allowed_idx=self.allowed_idx,
                                   normalize=self.normalize,
                                   terms=self.terms,
                                   unavailable_idx=unavailable,
                                   device=self.device)

    def apply_counts(self, demand: np.ndarray, counts: np.ndarray,
                     replanned: bool, solver_iters: int = 0) -> ControllerStep:
        """Record an allocation computed for this tick (by the batched fleet
        engine): churn and metrics, advance ``x_current``, append history."""
        demand = np.asarray(demand, np.float64)
        x = np.asarray(counts, np.float64)
        churn = float(np.abs(x - (self.x_current if self.x_current is not None
                                  else np.zeros_like(x))).sum())
        # rounding may overshoot the relaxed solve's churn bound; record the
        # excess (replans ignore the bound by design, so they report 0)
        violation = 0.0 if replanned else max(0.0, churn - float(self.delta_max))
        self.x_current = x
        step = ControllerStep(demand=demand, counts=x,
                              metrics=evaluate(self.catalog, x, demand),
                              churn=churn, replanned=replanned,
                              churn_violation=violation,
                              solver_iters=int(solver_iters))
        self.history.append(step)
        return step

    def step(self, demand: np.ndarray) -> ControllerStep:
        """The sequential control loop's tick: not ported yet (its cold
        tick runs ``multistart_solve``)."""
        raise NotImplementedError(
            "InfrastructureOptimizationController.step is not ported yet; "
            'use replay_fleet(..., replay_mode="batched")')
