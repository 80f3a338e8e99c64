"""repro_torch.horizon — forecast-driven receding-horizon (MPC) allocation,
the port of ``repro.horizon``:

  * forecast   — demand predictors (last_value, ewma, holt_winters, and
                 the ground-truth oracle) behind ``make_forecaster``; a
                 numpy copy of the reference's module.
  * problem    — the time-expanded program: H stacked per-tick problems
                 over the plan X (H, n) with smoothed inter-tick churn
                 coupling; a fleet of windows stacks lane-major (B, H, ...).
  * solver     — ``solve_horizon`` (one window) and
                 ``solve_horizon_fleet_step`` (B windows at once) on the
                 shared BB/Armijo engine, every per-tick eq. (1) of all
                 B·H ticks in one ``alloc_objective`` launch on the card.
  * admm       — consensus ADMM over the same program (``solver="admm"``):
                 the committed prox and the B·(H−1) planned proxes as two
                 batched engine calls per outer iteration.
  * controller — ``ModelPredictiveController``: forecast H ticks, solve,
                 commit tick 0, roll forward; H = 1 is the myopic
                 controller. ``fleet.replay_fleet(controller="mpc")``
                 drives it in both engines.
"""
from .forecast import (FORECASTER_KINDS, EWMAForecaster, Forecaster,
                       HoltWintersForecaster, LastValueForecaster,
                       OracleForecaster, make_forecaster)
from .problem import (DEFAULT_COUPLING_EPS, DEFAULT_COUPLING_W,
                      HorizonProblem, HorizonTermDef, churn_bound_grad,
                      churn_bound_penalty, commit_coupling_grad,
                      commit_coupling_penalty, coupling_grad,
                      coupling_penalty, coupling_term_defs, expand_problems,
                      horizon_objective, horizon_objective_terms,
                      smoothed_churn, stack_windows, tick_problem)
from .admm import (ADMMDiag, ADMMTrace, admm_residual_history,
                   admm_solve_plan)
from .solver import (DEFAULT_DELTA_PENALTY_W, DEFAULT_PENALTY_W,
                     HorizonFleetStepResult, HorizonSolveResult,
                     HorizonSolverConfig, round_committed, solve_horizon,
                     solve_horizon_fleet_step, solve_horizon_info)
from .controller import (ModelPredictiveController, select_window_candidate,
                         window_candidate_scores)

__all__ = [
    "Forecaster", "LastValueForecaster", "EWMAForecaster",
    "HoltWintersForecaster", "OracleForecaster", "FORECASTER_KINDS",
    "make_forecaster",
    "HorizonProblem", "expand_problems", "tick_problem",
    "horizon_objective", "horizon_objective_terms",
    "coupling_penalty", "coupling_grad", "smoothed_churn",
    "HorizonTermDef", "coupling_term_defs",
    "commit_coupling_penalty", "commit_coupling_grad",
    "churn_bound_penalty", "churn_bound_grad",
    "DEFAULT_COUPLING_W", "DEFAULT_COUPLING_EPS", "DEFAULT_PENALTY_W",
    "DEFAULT_DELTA_PENALTY_W",
    "solve_horizon", "solve_horizon_info", "solve_horizon_fleet_step",
    "HorizonFleetStepResult", "HorizonSolveResult", "HorizonSolverConfig",
    "round_committed",
    "ADMMDiag", "ADMMTrace", "admm_solve_plan", "admm_residual_history",
    "ModelPredictiveController", "window_candidate_scores",
    "select_window_candidate",
    "stack_windows",
]
