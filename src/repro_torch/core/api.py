"""High-level allocation pipeline — port of ``repro.core.api``:
scenario -> problem -> multistart relaxed solves -> greedy rounding ->
optional branch-and-bound refinement -> metrics, the "optimization
approach" column of the paper's comparison methodology (§IV.B.2).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from . import objective as obj
from .branch_bound import branch_and_bound
from .catalog import Catalog
from .metrics import AllocationMetrics, evaluate
from .multistart import multistart_solve
from .problem import AllocationProblem, PenaltyParams
from .scenarios import Scenario
from .solver import SolverConfig
from .terms import with_terms


@dataclass
class OptimizeResult:
    """One-shot pipeline output: the deployed allocation and its provenance.

    ``counts`` is the integer allocation (float array of whole numbers),
    ``relaxed`` the best continuous solution, ``fun`` the eq. (1) objective
    at ``counts`` (solver units), ``metrics`` the raw-unit snapshot
    evaluation, and ``used_bnb`` whether branch-and-bound ran."""

    counts: np.ndarray
    relaxed: np.ndarray
    metrics: AllocationMetrics
    fun: float
    used_bnb: bool


def problem_from_demand(catalog: Catalog, demand: np.ndarray,
                        params: Optional[PenaltyParams] = None,
                        allowed_idx: Optional[np.ndarray] = None,
                        existing: Optional[np.ndarray] = None,
                        normalize: bool = True,
                        terms=(),
                        unavailable_idx: Optional[np.ndarray] = None,
                        device: DeviceLike = None) -> AllocationProblem:
    """Build the problem for a raw demand vector, as the reference does:
    with ``normalize`` each resource row of K is divided by d_r (so d == 1
    in solver units); ``allowed_idx`` restricts the usable types (existing
    nodes stay allowed); ``existing`` lower-bounds the allocation;
    ``unavailable_idx`` zeroes mask, ub and lb of the listed types for this
    tick (the spot-interruption overlay); ``terms`` attaches scenario
    terms (``repro_torch.core.terms.with_terms``), priced in solver units
    like every other objective quantity."""
    dev = resolve_device(device)
    K, E, c = catalog.matrices()
    d = np.asarray(demand, np.float32)
    if normalize:
        scale = 1.0 / np.maximum(d, 1e-9)
        K = K * scale[:, None]
        d = np.ones_like(d)
    prob = AllocationProblem.create(K, E, c, d, params=params, device=dev)
    if allowed_idx is not None:
        allowed = np.asarray(allowed_idx)
        if existing is not None:
            existing_idx = np.nonzero(existing > 0)[0]
            allowed = np.unique(np.concatenate([allowed, existing_idx]))
        prob = prob.restrict(allowed)
    if existing is not None and np.asarray(existing).any():
        prob = prob.with_existing(np.asarray(existing, np.float32))
    if unavailable_idx is not None and len(np.asarray(unavailable_idx)):
        keep = np.ones(prob.n, np.float32)
        keep[np.asarray(unavailable_idx, np.int64)] = 0.0
        keep_t = torch.as_tensor(keep, device=dev)
        # lb too: an interrupted spot node is gone even if it was deployed
        prob = prob._replace(mask=prob.mask * keep_t, ub=prob.ub * keep_t,
                             lb=prob.lb * keep_t)
    if terms:
        prob = with_terms(prob, terms)
    return prob


def problem_from_scenario(catalog: Catalog, scenario: Scenario,
                          params: Optional[PenaltyParams] = None,
                          normalize: bool = True,
                          device: DeviceLike = None) -> AllocationProblem:
    """``problem_from_demand`` with the scenario's approved-type list and
    existing deployment applied (paper §IV.B scenario setups)."""
    return problem_from_demand(catalog, scenario.demand, params=params,
                               allowed_idx=scenario.allowed_idx,
                               existing=scenario.existing,
                               normalize=normalize, device=device)


def optimize(catalog: Catalog, scenario: Scenario,
             params: Optional[PenaltyParams] = None,
             n_starts: int = 8, seed: int = 0,
             use_bnb: bool = False, bnb_nodes: int = 24,
             cfg: Optional[SolverConfig] = None,
             use_kernel: bool = True,
             device: DeviceLike = None) -> OptimizeResult:
    """The paper's "optimization approach" for one scenario: problem
    construction -> multistart relaxed solves -> greedy rounding (every
    start; the best feasible integer merit wins) -> optional
    branch-and-bound refinement from the best relaxed start (``use_bnb``,
    at most ``bnb_nodes`` nodes; the multistart incumbent is kept where it
    is better) -> raw-unit metrics. ``use_kernel`` (default) evaluates
    eq. (1) with the CUDA kernel on the card; False runs the plain PyTorch
    version."""
    prob = problem_from_scenario(catalog, scenario, params,
                                 device=resolve_device(device))
    ms = multistart_solve(prob, n_starts=n_starts, seed=seed, cfg=cfg,
                          use_kernel=use_kernel)
    x_rel = ms.best.x.cpu().numpy()
    x_int = ms.x_int.cpu().numpy()
    if use_bnb:
        bnb = branch_and_bound(prob, x_rel, max_nodes=bnb_nodes,
                               use_kernel=use_kernel)
        if not float(ms.fun_int) < bnb.fun:   # else keep the multistart's
            x_int = bnb.x
    fun = float(obj.objective(
        prob, torch.as_tensor(x_int, dtype=torch.float32, device=prob.device),
        use_kernel))
    return OptimizeResult(
        counts=np.asarray(x_int, np.float64),
        relaxed=x_rel.astype(np.float64),
        metrics=evaluate(catalog, x_int, scenario.demand),
        fun=fun, used_bnb=use_bnb)
