"""repro_torch.core — the paper's allocation model in PyTorch: problem
container, eq. (1) objective and its kernel routing, the BB/Armijo PGD
engine, the barrier relaxation, multistart solves, greedy rounding,
branch-and-bound, the one-shot ``optimize`` pipeline over the paper's
scenarios, the Cluster-Autoscaler baseline, incremental adoption (traced,
or under an anytime deadline), the KKT certificate, and the controller's
control loop, whose state the fleet replay and the serving engine
drive; scenario terms (``terms``: SLO pricing, priority eviction, spot
risk), parameter tuning (``pareto``) and the paper's §VII extensions
(``extensions``)."""
from .catalog import (Catalog, InstanceType, make_cloud_catalog,
                      make_tpu_catalog, spot_catalog, spot_risk_prices)
from .controller import ControllerStep, InfrastructureOptimizationController
from .api import (OptimizeResult, optimize, problem_from_demand,
                  problem_from_scenario)
from .branch_bound import BnBResult, branch_and_bound
from .autoscaler import (NodePool, default_pools_for,
                         simulate_cluster_autoscaler,
                         simulate_cluster_autoscaler_batch)
from .incremental import (project_incremental, project_l1_ball,
                          solve_incremental, solve_incremental_info)
from .metrics import AllocationMetrics, evaluate, per_dim_utilization
from .multistart import make_starts, multistart_solve
from .objective import (constraint_residuals, grad_objective, is_feasible,
                        objective_terms, project, value_and_grad)
from .objective import objective as objective_value
from .pgd import (AnytimeConfig, AnytimeReport, PGDConfig, PGDTrace,
                  pgd_minimize, pgd_minimize_traced)
from .kkt import KKTReport, kkt_report
from .problem import AllocationProblem, PenaltyParams
from .rounding import greedy_round, round_and_polish, scale_down
from .scenarios import Scenario, build_scenarios, scaled_scenario
from .solver import SolveResult, SolverConfig, phase1_point, solve_relaxation
from .terms import (BASE_TERMS, SCENARIO_TERMS, TERM_DEFS, PricedTerm,
                    TermDef, make_term, register_term, term_signature,
                    with_terms)
from .pareto import grid_search, pareto_mask, sensitivity
from . import workloads

__all__ = [
    "AllocationProblem", "PenaltyParams", "objective_value", "objective_terms",
    "grad_objective", "constraint_residuals", "is_feasible", "PGDConfig",
    "AnytimeConfig", "AnytimeReport", "PGDTrace",
    "pgd_minimize", "pgd_minimize_traced", "SolverConfig",
    "SolveResult", "solve_relaxation", "multistart_solve", "make_starts",
    "greedy_round", "round_and_polish", "scale_down", "branch_and_bound",
    "BnBResult", "project_l1_ball", "project_incremental", "solve_incremental",
    "solve_incremental_info",
    "kkt_report", "KKTReport",
    "PricedTerm", "TermDef", "make_term", "register_term", "with_terms",
    "term_signature", "BASE_TERMS", "SCENARIO_TERMS", "TERM_DEFS",
    "Catalog", "InstanceType", "make_cloud_catalog",
    "make_tpu_catalog", "spot_catalog", "spot_risk_prices",
    "NodePool", "simulate_cluster_autoscaler",
    "simulate_cluster_autoscaler_batch", "default_pools_for",
    "AllocationMetrics", "evaluate", "per_dim_utilization",
    "Scenario", "build_scenarios", "scaled_scenario", "optimize",
    "problem_from_demand", "problem_from_scenario", "OptimizeResult",
    "InfrastructureOptimizationController", "ControllerStep", "grid_search",
    "sensitivity", "pareto_mask", "workloads",
]
