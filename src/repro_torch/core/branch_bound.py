"""Branch-and-bound / branch-and-cut search (paper §III.A, §III.D) — port of
``repro.core.branch_bound``.

Host-side best-first search; every node's continuous relaxation is solved
by ``solve_relaxation`` with per-variable box bounds (the projection
handles boxes exactly) from the incumbent, on the problem's device: on a
CUDA tensor every eq. (1) evaluation of a node solve is one launch of the
``alloc_objective`` kernel's single-problem form (``use_kernel=False``:
the plain version). The search state — bounds, heap, incumbent — stays on
the host in numpy, as in the reference; a node reads its solution and
value back once.

Nodes are solved one at a time, in the reference's order: a node's cost
cut depends on the incumbent that the node before it may have changed, so
solving open nodes together would explore another tree.

Honesty note (as in the reference): with the concave consolidation term the
relaxation value is not a certified global lower bound; as in the paper it
is taken as the node bound (the term's magnitude is <= alpha * p, so bounds
are widened by that constant to keep pruning conservative on near-convex
instances). Bound-tightening "cuts": cost-based upper bounds from the
incumbent (if c_i * x_i > U then x_i <= floor(U / c_i)).
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from . import objective as obj
from .problem import AllocationProblem
from .rounding import round_and_polish
from .solver import SolverConfig, solve_relaxation


@dataclass(order=True)
class _Node:
    bound: float
    tie: int = field(compare=True)
    lb: np.ndarray = field(compare=False, default=None)
    ub: np.ndarray = field(compare=False, default=None)


@dataclass
class BnBResult:
    """Best integer solution found, with search-effort provenance
    (``gap`` = relative distance between incumbent and best relaxed bound)."""

    x: np.ndarray
    fun: float
    nodes_explored: int
    incumbent_updates: int
    gap: float


def _on(prob: AllocationProblem, a) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=prob.device)


def _solve_node(prob: AllocationProblem, lb, ub, x0, cfg,
                use_kernel: bool = True) -> tuple[np.ndarray, float]:
    node_prob = prob._replace(lb=_on(prob, lb), ub=_on(prob, ub))
    res = solve_relaxation(node_prob, _on(prob, x0), cfg, use_kernel)
    return res.x.cpu().numpy(), float(res.fun)


def _cost_cuts(c: np.ndarray, ub: np.ndarray, incumbent_val: float
               ) -> np.ndarray:
    """Tighten per-variable upper bounds from the incumbent cost; ``c`` is
    the problem's cost vector on the host, as float32."""
    if not np.isfinite(incumbent_val):
        return ub
    cap = np.floor(np.maximum(incumbent_val, 0.0) / np.maximum(c, 1e-9)) + 1.0
    return np.minimum(ub, cap)


def branch_and_bound(
    prob: AllocationProblem,
    x_relaxed: Optional[np.ndarray] = None,
    max_nodes: int = 48,
    int_tol: float = 1e-3,
    cfg: Optional[SolverConfig] = None,
    use_kernel: bool = True,
) -> BnBResult:
    """Best-first branch-and-bound on fractional variables (paper §III.D):
    each node re-solves the relaxation under tightened box bounds, an
    incumbent prunes by cost cuts; bounded by ``max_nodes`` relaxed solves.
    ``use_kernel`` is ``solve_relaxation``'s."""
    cfg = cfg or SolverConfig()
    n = prob.n
    lb0 = prob.lb.cpu().numpy().astype(np.float64)
    ub0 = prob.ub.cpu().numpy().astype(np.float64)
    c = prob.c.cpu().numpy()

    def objective(x: np.ndarray) -> float:
        return float(obj.objective(prob, _on(prob, x), use_kernel))

    def feasible(x: np.ndarray) -> bool:
        return bool(obj.is_feasible(prob, _on(prob, x), 1e-3))

    def rounded(x: np.ndarray) -> np.ndarray:
        return round_and_polish(prob, _on(prob, x),
                                use_kernel=use_kernel).cpu().numpy()

    if x_relaxed is None:
        res = solve_relaxation(prob, torch.zeros(n, device=prob.device), cfg,
                               use_kernel)
        x_relaxed = res.x.cpu().numpy()

    # incumbent from greedy rounding (paper's fallback)
    x_inc = rounded(x_relaxed)
    f_inc = objective(x_inc)
    updates = 0

    # slack added to node bounds: the concave term can lower f by at most
    # alpha * p below its convex-ignored counterpart.
    bound_slack = float(prob.params.alpha) * prob.p

    tie = itertools.count()
    heap: list[_Node] = []
    _, root_f = _solve_node(prob, lb0, ub0, x_relaxed, cfg, use_kernel)
    heapq.heappush(heap, _Node(root_f, next(tie), lb0, ub0))
    explored = 0

    while heap and explored < max_nodes:
        node = heapq.heappop(heap)
        explored += 1
        if node.bound - bound_slack >= f_inc:
            continue  # pruned
        ub_cut = _cost_cuts(c, node.ub, f_inc)
        x_rel, f_rel = _solve_node(prob, node.lb, ub_cut, x_inc, cfg,
                                   use_kernel)
        if f_rel - bound_slack >= f_inc:
            continue
        frac = np.abs(x_rel - np.round(x_rel))
        if np.max(frac) <= int_tol:
            x_int = np.round(x_rel)
            if feasible(x_int):
                f_int = objective(x_int)
                if f_int < f_inc:
                    f_inc, x_inc = f_int, x_int
                    updates += 1
            continue
        # also round this node's solution — cheap incumbent candidates
        x_rnd = rounded(x_rel)
        f_rnd = objective(x_rnd)
        if f_rnd < f_inc and feasible(x_rnd):
            f_inc, x_inc = f_rnd, x_rnd
            updates += 1

        i = int(np.argmax(frac))
        v = x_rel[i]
        lo_child = node.lb.copy(); lo_child[i] = np.ceil(v)
        hi_child = node.ub.copy(); hi_child[i] = np.floor(v)
        if lo_child[i] <= node.ub[i]:
            heapq.heappush(heap, _Node(f_rel, next(tie), lo_child,
                                       node.ub.copy()))
        if hi_child[i] >= node.lb[i]:
            heapq.heappush(heap, _Node(f_rel, next(tie), node.lb.copy(),
                                       hi_child))

    best_bound = min([nd.bound for nd in heap], default=f_inc)
    gap = max(0.0, f_inc - (best_bound - bound_slack))
    return BnBResult(x=x_inc, fun=f_inc, nodes_explored=explored,
                     incumbent_updates=updates, gap=gap)
