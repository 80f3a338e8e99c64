"""Solver configuration and the phase-1 feasibility point — the parts of
``repro.core.solver`` the batched fleet solver uses.

``solve_relaxation`` (the single-problem barrier solver behind the
reference's ``hot_loop="vmap"``) is not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import objective as obj
from .problem import AllocationProblem, lane, matvec, rmatvec


class SolverConfig(NamedTuple):
    """Solver knobs (see ``repro.core.solver.SolverConfig``): barrier
    continuation schedule, PGD iteration budget, and the Armijo ladder."""

    max_iters: int = 400           # inner PGD iterations per barrier round
    barrier_rounds: int = 4        # outer continuation rounds
    barrier_t0: float = 1.0        # initial barrier temperature
    barrier_kappa: float = 10.0    # t multiplier per round
    penalty_w: float = 1e3         # quadratic penalty weight (fallback mode)
    step0: float = 1.0             # top of the step ladder
    n_backtracks: int = 12         # ladder length
    backtrack: float = 0.5         # ladder ratio
    armijo_c: float = 1e-4
    tol: float = 1e-6              # stop when projected-gradient step is tiny


def phase1_point(prob: AllocationProblem, x0: torch.Tensor, steps: int = 200,
                 margin_frac: float = 0.02) -> torch.Tensor:
    """Drive constraint violation to ~0 by ``steps`` fixed projected-gradient
    steps on the violation alone, aiming a small margin INSIDE the
    [d - mu, d + g] band (strictly interior whenever the band has width).
    x0 is (..., n), or (B, ..., n) for a stacked problem."""
    margin = margin_frac * (prob.mu + prob.g)      # zero-width band -> 0
    lo_t = prob.d - prob.mu + margin
    hi_t = prob.d + prob.g - margin
    # Lipschitz-ish step from the squared entries of K, per problem
    L = 2.0 * (prob.K * prob.K).sum((-2, -1)) + 1e-6
    inv_L = 1.0 / L
    x = obj.project(prob, x0)
    lo_b, hi_b = lane(prob, lo_t, x), lane(prob, hi_t, x)
    step = lane(prob, inv_L, x)
    for _ in range(steps):
        Kx = matvec(prob, prob.K, x)
        lo_v = torch.clamp(lo_b - Kx, min=0.0)
        hi_v = torch.clamp(Kx - hi_b, min=0.0)
        grad = (-2.0 * rmatvec(prob, prob.K, lo_v)
                + 2.0 * rmatvec(prob, prob.K, hi_v))
        x = obj.project(prob, x - step * grad)
    return x
