"""repro_torch.core — the paper's allocation model in PyTorch: problem
container, eq. (1) objective and its kernel routing, the BB/Armijo PGD
engine, phase-1, multistart starts, greedy rounding, incremental adoption
and the controller state the fleet replay drives."""
from .catalog import Catalog, InstanceType, make_cloud_catalog
from .controller import ControllerStep, InfrastructureOptimizationController
from .api import problem_from_demand
from .incremental import (project_incremental, project_l1_ball,
                          solve_incremental_info)
from .metrics import AllocationMetrics, evaluate
from .multistart import make_starts
from .objective import (constraint_residuals, grad_objective, is_feasible,
                        objective_terms, project, value_and_grad)
from .objective import objective as objective_value
from .pgd import PGDConfig, pgd_minimize
from .problem import AllocationProblem, PenaltyParams
from .rounding import greedy_round, round_and_polish, scale_down
from .solver import SolverConfig, phase1_point
from .terms import BASE_TERMS, TERM_DEFS, TermDef, register_term

__all__ = [
    "Catalog", "InstanceType", "make_cloud_catalog",
    "ControllerStep", "InfrastructureOptimizationController",
    "problem_from_demand", "project_incremental", "project_l1_ball",
    "solve_incremental_info", "AllocationMetrics",
    "evaluate", "make_starts", "constraint_residuals", "grad_objective",
    "is_feasible", "objective_terms", "project", "value_and_grad",
    "objective_value", "PGDConfig", "pgd_minimize", "AllocationProblem",
    "PenaltyParams", "greedy_round", "round_and_polish", "scale_down",
    "SolverConfig", "phase1_point", "BASE_TERMS", "TERM_DEFS", "TermDef",
    "register_term",
]
