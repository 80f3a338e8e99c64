"""Parameter tuning (paper §III.D) — port of ``repro.core.pareto``: grid
search over (alpha, beta1, beta2, beta3, gamma), the Pareto frontier over
(cost, fragmentation), and sensitivity analysis.

The reference ``vmap``s one relaxed solve over the grid. Here the grid is
a written-out batch dimension: one STACKED problem whose lanes share K, E,
c and d and differ only in ``PenaltyParams``, relaxed by one
``solve_relaxation`` call (a lane per grid point). On the card every
eq. (1) evaluation of the whole grid is one launch of the
``alloc_objective`` kernel's fleet form, which takes its params per lane.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np
import torch

from . import objective as obj
from .problem import AllocationProblem, PenaltyParams, matvec
from .rounding import greedy_round
from .solver import SolverConfig, solve_relaxation

PARAM_NAMES = PenaltyParams._fields


@dataclass
class GridPoint:
    """One penalty-parameter setting and its (cost, fragmentation,
    diversity) outcome; ``on_frontier`` marks Pareto-efficient points."""

    params: Dict[str, float]
    cost: float
    fragmentation: int
    diversity: int
    objective: float
    on_frontier: bool = False


def _grid_problem(prob: AllocationProblem, settings: Sequence[Sequence[float]]
                  ) -> AllocationProblem:
    """``prob`` repeated once per setting (a tuple in PenaltyParams' field
    order), each lane with its own params: a stacked problem of G lanes."""
    G = len(settings)
    rep = lambda a: a.expand(G, *a.shape).contiguous()
    cols = np.asarray(settings, np.float32).T
    params = PenaltyParams(*(torch.as_tensor(col, device=prob.device)
                             for col in cols))
    return prob._replace(
        K=rep(prob.K), E=rep(prob.E), c=rep(prob.c), d=rep(prob.d),
        mu=rep(prob.mu), g=rep(prob.g), params=params, lb=rep(prob.lb),
        ub=rep(prob.ub), mask=rep(prob.mask),
        terms=tuple(t.map(rep) for t in prob.terms))


def _eval_grid(prob: AllocationProblem, settings, cfg: SolverConfig,
               use_kernel: bool):
    """Relax every grid point from x0 = 0 in one stacked solve, round it
    greedily, and score it: (cost, fragmentation, diversity, eq. (1)),
    each (G,) on the host."""
    grid = _grid_problem(prob, settings)
    res = solve_relaxation(grid, torch.zeros_like(grid.c), cfg, use_kernel)
    x_int = greedy_round(grid, res.x)
    cost = (grid.c * x_int).sum(-1)
    used = (x_int > 0.5).to(torch.float32)
    frag = (matvec(grid, grid.E, used) > 0.5).sum(-1)
    div = used.sum(-1)
    f = obj.objective(grid, x_int, use_kernel)
    return tuple(a.cpu().numpy() for a in (cost, frag, div, f))


def pareto_mask(points: np.ndarray) -> np.ndarray:
    """points (N, k): smaller is better on every axis. Returns frontier mask."""
    N = points.shape[0]
    mask = np.ones(N, bool)
    for i in range(N):
        if not mask[i]:
            continue
        dominated = (np.all(points <= points[i], axis=1)
                     & np.any(points < points[i], axis=1))
        if dominated.any():
            mask[i] = False
    return mask


def grid_search(prob: AllocationProblem,
                alphas: Sequence[float] = (0.1, 1.0, 5.0),
                gammas: Sequence[float] = (0.05, 0.2, 1.0),
                beta1s: Sequence[float] = (0.5,),
                beta2s: Sequence[float] = (0.05,),
                beta3s: Sequence[float] = (50.0,),
                cfg: SolverConfig = SolverConfig(max_iters=200,
                                                 barrier_rounds=2),
                use_kernel: bool = True) -> List[GridPoint]:
    """Sweep the five penalty knobs over a grid (one stacked solve), score
    each rounded outcome, and mark the cost / fragmentation Pareto frontier
    — how the default PenaltyParams were tuned. ``use_kernel`` (default)
    evaluates eq. (1) with the CUDA kernel on the card, False with the
    plain PyTorch version."""
    combos = [(a, b1, b2, b3, g)
              for a in alphas for b1 in beta1s for b2 in beta2s
              for b3 in beta3s for g in gammas]
    cost, frag, div, fval = _eval_grid(prob, combos, cfg, use_kernel)
    pts = np.stack([cost, frag.astype(np.float64)], axis=1)
    frontier = pareto_mask(pts)
    return [GridPoint(params=dict(zip(PARAM_NAMES, combo)),
                      cost=float(cost[i]), fragmentation=int(frag[i]),
                      diversity=int(div[i]), objective=float(fval[i]),
                      on_frontier=bool(frontier[i]))
            for i, combo in enumerate(combos)]


def sensitivity(prob: AllocationProblem, base: PenaltyParams,
                rel_step: float = 0.1,
                cfg: SolverConfig = SolverConfig(max_iters=200,
                                                 barrier_rounds=2),
                use_kernel: bool = True) -> Dict[str, float]:
    """d(cost)/d(log param) by central differences — which knob matters
    most. The ten perturbed settings relax as the lanes of one stacked
    solve."""
    v = [float(a) for a in base]
    settings = []
    for i in range(len(PARAM_NAMES)):
        for scale in (1 + rel_step, 1 - rel_step):
            s = list(v)
            s[i] = float(np.float32(v[i] * scale))
            settings.append(s)
    cost = _eval_grid(prob, settings, cfg, use_kernel)[0]
    return {nm: float(cost[2 * i] - cost[2 * i + 1]) / (2 * rel_step)
            for i, nm in enumerate(PARAM_NAMES)}
