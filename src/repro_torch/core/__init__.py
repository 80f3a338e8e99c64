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
                      spot_catalog, spot_risk_prices)
from .controller import ControllerStep, InfrastructureOptimizationController
from .api import (OptimizeResult, optimize, problem_from_demand,
                  problem_from_scenario)
from .branch_bound import BnBResult, branch_and_bound
from .autoscaler import (NodePool, default_pools_for,
                         simulate_cluster_autoscaler,
                         simulate_cluster_autoscaler_batch)
from .incremental import (project_incremental, project_l1_ball,
                          solve_incremental_info)
from .metrics import AllocationMetrics, evaluate
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
    "Catalog", "InstanceType", "make_cloud_catalog", "spot_catalog",
    "spot_risk_prices",
    "ControllerStep", "InfrastructureOptimizationController",
    "OptimizeResult", "optimize", "problem_from_demand",
    "problem_from_scenario", "BnBResult", "branch_and_bound", "NodePool", "default_pools_for",
    "simulate_cluster_autoscaler", "simulate_cluster_autoscaler_batch",
    "project_incremental", "project_l1_ball",
    "solve_incremental_info", "AllocationMetrics",
    "evaluate", "make_starts", "multistart_solve", "constraint_residuals",
    "grad_objective", "is_feasible", "objective_terms", "project",
    "value_and_grad", "objective_value", "PGDConfig", "pgd_minimize",
    "AnytimeConfig", "AnytimeReport", "PGDTrace", "pgd_minimize_traced",
    "KKTReport", "kkt_report",
    "AllocationProblem", "PenaltyParams", "greedy_round", "round_and_polish",
    "scale_down", "Scenario", "build_scenarios", "scaled_scenario",
    "SolveResult", "SolverConfig", "phase1_point", "solve_relaxation",
    "BASE_TERMS", "SCENARIO_TERMS", "TERM_DEFS", "PricedTerm", "TermDef",
    "make_term", "register_term", "term_signature", "with_terms",
    "grid_search", "pareto_mask", "sensitivity", "workloads",
]
