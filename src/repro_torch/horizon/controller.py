"""Model-predictive (receding-horizon) allocation controller — port of
``repro.horizon.controller``.

``ModelPredictiveController`` extends the myopic
``InfrastructureOptimizationController``: each tick it feeds the observed
demand to its forecaster, builds the H-tick window [observed demand, H-1
forecast ticks] of per-tick problems with the same ``make_problem`` (on the
controller's ``device``), solves the time-expanded program
(``horizon.solver.solve_horizon_info``, eq. (1) by the kernel where
``use_kernel``), and commits only tick 0 through the inherited
``apply_counts``; then the horizon rolls forward one tick.

Cold start: the first tick has no allocation, hence no churn to plan
around; it is the myopic multistart. ``cold_start="myopic"`` (default)
picks the best rounded candidate by tick-0 merit; ``"window"`` scores the
same candidates against the whole window's objective
(:func:`window_candidate_scores`, each candidate held constant across the
window). At H = 1 both are the myopic selection, and every warm tick is
``solve_incremental`` plus ``round_and_polish``: MPC with a one-tick
window commits the myopic controller's allocations exactly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..core import objective as obj
from ..core.controller import (ControllerStep,
                               InfrastructureOptimizationController)
from ..core.multistart import multistart_solve
from ..core.problem import AllocationProblem
from ..device import DeviceLike
from ..fleet.batching import stack_problems
from ..obs.telemetry import span
from .forecast import Forecaster, LastValueForecaster
from .problem import (DEFAULT_COUPLING_EPS, DEFAULT_COUPLING_W,
                      expand_problems)
from .solver import (HorizonSolverConfig, _resolve_cfg, round_committed,
                     solve_horizon_info)


def window_candidate_scores(probs: List[AllocationProblem],
                            candidates, use_kernel: bool = True,
                            device: DeviceLike = None) -> np.ndarray:
    """Whole-window objective of each candidate held constant across the
    window: ``scores[s] = Σ_h f_h(candidates[s])`` (float64, summed tick by
    tick). The coupling of a constant plan is 0, so no weight enters.

    The window's H problems are stacked on ``device`` (default: the first
    problem's) and the S candidates evaluated at every tick in one
    ``core.objective`` call: on the card one ``alloc_objective`` value
    launch with B = H, T = S."""
    window = stack_problems(list(probs), device=device).problem
    cands = torch.as_tensor(np.asarray(candidates, np.float32),
                            device=window.device)               # (S, n)
    X = cands[None].expand(len(probs), *cands.shape).contiguous()
    vals = obj.objective(window, X, use_kernel).cpu().numpy()   # (H, S)
    scores = np.zeros(cands.shape[0], np.float64)
    for row in vals:
        scores += row.astype(np.float64)
    return scores


def select_window_candidate(scores: np.ndarray,
                            feasible: np.ndarray) -> int:
    """Pick the candidate index by window score, tick-0-infeasible ones
    pushed behind every feasible one (the myopic multistart's +1e12
    convention: at H = 1 the two selections agree)."""
    merit = np.where(np.asarray(feasible, bool), scores, scores + 1e12)
    return int(np.argmin(merit))


@dataclass
class ModelPredictiveController(InfrastructureOptimizationController):
    """Receding-horizon controller: forecast H ticks, solve the
    time-expanded program, commit tick 0, roll forward.

    Inherits the myopic controller's fields (catalog, delta_max, params,
    n_starts, allowed_idx, normalize, terms, the spot overlay, device,
    use_kernel, capture_solver_trace, anytime) and its bookkeeping. Extra
    knobs, as in ``repro.horizon.ModelPredictiveController``: ``horizon``
    (H; 1 is the myopic controller), ``forecaster`` (default: a fresh
    ``last_value``), ``coupling_w`` / ``coupling_eps``, ``solver_config``
    (a ``HorizonSolverConfig``, default its defaults) and ``cold_start``.
    ``plan`` holds the last relaxed plan (H, n) as numpy."""

    horizon: int = 8
    forecaster: Optional[Forecaster] = None
    coupling_w: float = DEFAULT_COUPLING_W
    coupling_eps: float = DEFAULT_COUPLING_EPS
    solver_config: Optional[HorizonSolverConfig] = None
    cold_start: str = "myopic"
    plan: Optional[np.ndarray] = None

    def __post_init__(self) -> None:
        """Default the forecaster; resolve the solver config; validate."""
        if self.horizon < 1:
            raise ValueError(f"horizon must be >= 1, got {self.horizon}")
        if self.cold_start not in ("myopic", "window"):
            raise ValueError(f"unknown cold_start {self.cold_start!r}")
        if self.forecaster is None:
            self.forecaster = LastValueForecaster()
        self.solver_config = _resolve_cfg(self.solver_config)

    # -- window construction -------------------------------------------------

    def window_demands(self, demand: np.ndarray) -> np.ndarray:
        """Observe this tick's demand, then assemble the (H, m) window: row
        0 the observed demand, rows 1..H-1 the forecaster's next ticks."""
        demand = np.asarray(demand, np.float64)
        self.forecaster.observe(demand)
        if self.horizon == 1:
            return demand[None, :]
        future = self.forecaster.predict(self.horizon - 1)
        return np.concatenate([demand[None, :], future], axis=0)

    def window_problems(self, demands: np.ndarray) -> List[AllocationProblem]:
        """One ``make_problem`` per window tick: tick 0's IS the myopic
        problem."""
        return [self.make_problem(d) for d in demands]

    def shifted_plan(self) -> np.ndarray:
        """The next solve's warm start: the previous plan advanced one tick
        (the last row repeats), row 0 reset to the deployed counts."""
        H = self.horizon
        out = np.empty((H, len(self.x_current)), np.float64)
        out[0] = self.x_current
        for h in range(1, H):
            out[h] = (self.plan[min(h + 1, H - 1)] if self.plan is not None
                      else self.x_current)
        return out

    # -- cold start ----------------------------------------------------------

    def cold_window_counts(self, probs: List[AllocationProblem]) -> np.ndarray:
        """``cold_start="window"``: the myopic multistart's rounded
        candidates ranked by the whole window's objective."""
        ms = multistart_solve(probs[0], n_starts=self.n_starts,
                              use_kernel=self.use_kernel)
        self.last_x_rel = ms.best.x.cpu().numpy().astype(np.float64)
        cands = ms.x_int_all.cpu().numpy().astype(np.float64)      # (S, n)
        scores = window_candidate_scores(probs, cands, self.use_kernel)
        j = select_window_candidate(scores, ms.feas_int_all.cpu().numpy())
        return cands[j]

    # -- the receding-horizon tick -------------------------------------------

    def plan_counts(self, probs: List[AllocationProblem]) -> np.ndarray:
        """Warm tick: solve the time-expanded program, keep the relaxed
        plan (and the iteration count on ``_last_solver_iters``), and
        return the committed tick's rounded counts — plan-respecting at
        H > 1 (``round_committed``). With ``capture_solver_trace`` the
        engine's rows join ``solver_traces``; an enabled ``anytime``
        budget truncates the solve to its best-so-far plan."""
        hp = expand_problems(probs, coupling_w=self.coupling_w,
                             coupling_eps=self.coupling_eps)
        f32 = dict(dtype=torch.float32, device=hp.problem.device)
        with span("mpc/plan", cat="mpc",
                  compile_key=("solve_horizon", self.horizon, self.catalog.n,
                               self.solver_config, self.capture_solver_trace,
                               self.anytime is not None and
                               self.anytime.enabled)) as sp:
            res = solve_horizon_info(
                hp, torch.as_tensor(self.x_current, **f32),
                torch.as_tensor(self.delta_max, **f32),
                x_init=torch.as_tensor(self.shifted_plan(), **f32),
                cfg=self.solver_config,
                capture_trace=self.capture_solver_trace,
                anytime=self.anytime, use_kernel=self.use_kernel)
            sp.fence(res.plan)
        if res.trace is not None:
            self.solver_traces.append(
                type(res.trace)(*(f.cpu().numpy() for f in res.trace)))
        self.plan = res.plan.cpu().numpy().astype(np.float64)
        # the committed tick's relaxed point (what health's KKT certifies)
        self.last_x_rel = self.plan[0]
        self._last_solver_iters = int(res.iters)
        self._last_deadline_hit = bool(res.deadline_hit or False)
        with span("mpc/commit", cat="mpc"):
            return round_committed(
                probs[0], res.plan[0], respect_plan=self.horizon > 1,
                use_kernel=self.use_kernel).cpu().numpy().astype(np.float64)

    def step(self, demand: np.ndarray,
             x_init: Optional[np.ndarray] = None) -> ControllerStep:
        """Advance one tick: forecast, solve the window, commit tick 0.
        ``x_init`` is accepted for interface parity and ignored (the warm
        start is the shifted plan)."""
        demand = np.asarray(demand, np.float64)
        with span("mpc/forecast", cat="mpc"):
            demands = self.window_demands(demand)
        with span("mpc/window", cat="mpc"):
            probs = self.window_problems(demands)
        if self.x_current is None:
            x = (self.cold_window_counts(probs)
                 if self.cold_start == "window"
                 else self.cold_start_counts(probs[0]))
            replanned = True
            self._last_solver_iters = 0
            self._last_deadline_hit = False
            self.plan = np.tile(x, (self.horizon, 1))
        else:
            x, replanned = self.plan_counts(probs), False
        return self.apply_counts(demand, x, replanned,
                                 solver_iters=self._last_solver_iters,
                                 deadline_hit=self._last_deadline_hit)
