"""Infrastructure Optimization Controller (paper §I.C, §III.E) — port of
``repro.core.controller``: the control loop that keeps a cluster's
allocation against a time-varying demand stream. The first tick is a cold
multistart solve; every later tick replans under the incremental-adoption
bound ||x - x_cur||_1 <= delta_max, warm-started from the current counts;
``replan_on_failure`` relaxes the bound by the failed nodes. The batched
fleet replay drives the same state through :meth:`make_problem` and
:meth:`apply_counts`. A warm tick can also capture the solver's
convergence rows (``capture_solver_trace``) or run under an anytime
deadline (``anytime``), which deploys the best-so-far feasible iterate when
the budget expires.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..device import DeviceLike
from .api import problem_from_demand
from .catalog import Catalog
from .incremental import solve_incremental_info
from .metrics import AllocationMetrics, evaluate
from .multistart import multistart_solve
from .pgd import AnytimeConfig
from .problem import AllocationProblem, PenaltyParams
from .rounding import round_and_polish


@dataclass
class ControllerStep:
    """One recorded tick: the demand seen, the allocation deployed, its
    snapshot metrics, the L1 churn paid, and whether it was a full replan
    (see ``repro.core.controller.ControllerStep``). ``deadline_hit`` marks
    a tick whose solve an anytime deadline truncated."""

    demand: np.ndarray
    counts: np.ndarray
    metrics: AllocationMetrics
    churn: float                 # ||x_t - x_{t-1}||_1
    replanned: bool
    churn_violation: float = 0.0  # max(0, churn - delta_max) on warm ticks
    solver_iters: int = 0         # inner PGD iterations spent on this tick
    deadline_hit: bool = False    # anytime budget truncated this tick's solve


@dataclass
class InfrastructureOptimizationController:
    """Stateful per-cluster control loop: cold multistart solve on the first
    tick, then warm-started incremental solves under the L1 churn bound
    ``delta_max``. ``device`` is where :meth:`make_problem` builds each
    tick's problem and the solves run (None means "cuda"); ``use_kernel``
    (default) evaluates eq. (1) with the CUDA kernel there, False with the
    plain PyTorch version. ``capture_solver_trace`` appends every warm
    solve's :class:`~repro_torch.core.pgd.PGDTrace` (numpy rows) to
    ``solver_traces``; an enabled ``anytime`` config truncates every warm
    solve at its deadline. The two exclude each other."""

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
    use_kernel: bool = True
    capture_solver_trace: bool = False
    solver_traces: List = field(default_factory=list)
    anytime: Optional[AnytimeConfig] = None

    # not a dataclass field: the last warm solve's PGD iteration count,
    # recorded by step() (0 until a warm solve has run)
    _last_solver_iters = 0
    # not a dataclass field: whether the last warm solve's anytime budget
    # expired before convergence
    _last_deadline_hit = False
    # not a dataclass field: the last solve's RELAXED solution (cold and
    # warm); the integer counts are a rounding of it
    last_x_rel: Optional[np.ndarray] = None

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

    def cold_start_counts(self, prob: AllocationProblem) -> np.ndarray:
        """First-tick allocation: full multistart solve, no churn bound; the
        best rounded start (``optimize`` without branch-and-bound)."""
        ms = multistart_solve(prob, n_starts=self.n_starts,
                              use_kernel=self.use_kernel)
        self.last_x_rel = ms.best.x.cpu().numpy().astype(np.float64)
        return ms.x_int.cpu().numpy().astype(np.float64)

    def incremental_counts(self, prob: AllocationProblem,
                           x_init: Optional[np.ndarray] = None) -> np.ndarray:
        """Warm-tick allocation: incremental solve from the current counts
        under the L1 churn bound, then greedy rounding. ``x_init``
        optionally overrides the warm start; the solve's iteration count is
        kept on ``_last_solver_iters`` and its truncation on
        ``_last_deadline_hit``."""
        f32 = dict(dtype=torch.float32, device=prob.device)
        x_init = None if x_init is None else torch.as_tensor(x_init, **f32)
        timed = self.anytime is not None and self.anytime.enabled
        if timed and self.capture_solver_trace:
            raise ValueError("anytime deadlines and capture_solver_trace "
                             "are mutually exclusive; drop one")
        x_rel, iters, *extra = solve_incremental_info(
            prob, torch.as_tensor(self.x_current, **f32),
            torch.as_tensor(self.delta_max, **f32), x_init=x_init,
            use_kernel=self.use_kernel,
            capture_trace=self.capture_solver_trace,
            anytime=self.anytime if timed else None)
        self._last_deadline_hit = bool(timed and extra[0].deadline_hit)
        if self.capture_solver_trace:
            self.solver_traces.append(
                type(extra[0])(*(f.cpu().numpy() for f in extra[0])))
        self._last_solver_iters = int(iters)
        self.last_x_rel = x_rel.cpu().numpy().astype(np.float64)
        # rounding may exceed the churn bound slightly when demand jumps;
        # that's the feasibility-first tradeoff (shortage beats churn).
        return round_and_polish(prob, x_rel, use_kernel=self.use_kernel
                                ).cpu().numpy().astype(np.float64)

    def apply_counts(self, demand: np.ndarray, counts: np.ndarray,
                     replanned: bool, solver_iters: int = 0,
                     deadline_hit: bool = False) -> ControllerStep:
        """Record an allocation computed for this tick (by :meth:`step`, or
        by the batched fleet engine): churn and metrics, advance
        ``x_current``, append history."""
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
                              solver_iters=int(solver_iters),
                              deadline_hit=bool(deadline_hit))
        self.history.append(step)
        return step

    def step(self, demand: np.ndarray,
             x_init: Optional[np.ndarray] = None) -> ControllerStep:
        """Advance one tick: solve for this demand (cold multistart on the
        first call, warm-started incremental solve after) and record it."""
        demand = np.asarray(demand, np.float64)
        prob = self.make_problem(demand)
        if self.x_current is None:
            x, replanned = self.cold_start_counts(prob), True
            self._last_solver_iters = 0
            self._last_deadline_hit = False
        else:
            x, replanned = self.incremental_counts(prob, x_init=x_init), False
        return self.apply_counts(demand, x, replanned,
                                 solver_iters=self._last_solver_iters,
                                 deadline_hit=self._last_deadline_hit)

    def replan_on_failure(self, failed_counts: np.ndarray,
                          demand: np.ndarray) -> ControllerStep:
        """Remove failed nodes from the current allocation, then replan with
        the churn bound relaxed by the failure size (we must at least
        replace what died)."""
        if self.x_current is None:
            raise RuntimeError("controller has no allocation yet")
        failed = np.minimum(np.asarray(failed_counts, np.float64),
                            self.x_current)
        self.x_current = self.x_current - failed
        old_delta = self.delta_max
        self.delta_max = float(old_delta + failed.sum())
        try:
            out = self.step(demand)
        finally:
            self.delta_max = old_delta
        return out

    def total_cost(self) -> float:
        return sum(s.metrics.total_cost for s in self.history)

    def total_churn(self) -> float:
        return sum(s.churn for s in self.history)
