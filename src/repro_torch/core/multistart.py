"""Multi-start strategy (paper §III.C) — port of ``repro.core.multistart``:
solves from diverse starts, every start rounded, the best feasible integer
merit wins.

Start families: zeros, single-type covers of the most cost-efficient
types, and random scaled uniforms around a least-squares coverage level.
The random family is drawn with a ``torch.Generator`` seeded from ``seed``
(on the CPU, so every device sees the same starts); it differs from the
reference's ``jax.random`` draws, so parity tests feed both packages the
same starts. The reference ``vmap``s one start's solve; here the (S, n)
starts go through ``solve_relaxation`` and the rounding as one batch.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import objective as obj
from .problem import AllocationProblem
from .rounding import round_and_polish
from .solver import SolveResult, SolverConfig, solve_relaxation


class MultiStartResult(NamedTuple):
    """Winner (+ per-start diagnostics) of a multi-start solve; ``x_int`` is
    the best feasible ROUNDED solution across starts, ``best`` the relaxed
    solve with the best feasible merit. The per-start rounded candidates
    are kept so callers can re-score them against another merit."""

    best: SolveResult
    x_int: torch.Tensor         # (n,) best ROUNDED integer solution
    fun_int: torch.Tensor       # objective at x_int
    all_fun: torch.Tensor       # (S,) relaxed objective per start
    all_feasible: torch.Tensor  # (S,)
    x_all: torch.Tensor         # (S, n)
    x_int_all: torch.Tensor     # (S, n) rounded candidate per start
    fun_int_all: torch.Tensor   # (S,) objective per rounded candidate
    feas_int_all: torch.Tensor  # (S,) integer feasibility per candidate


def make_starts(prob: AllocationProblem, n_starts: int, seed: int = 0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(S, n) start matrix for a single problem, on the problem's device."""
    n = prob.n
    dev = prob.device
    K = prob.K
    # single-type covers: cover_i = max_r d_r / K_ri; efficiency = its cost
    safe_K = torch.where(K > 0, K, torch.full_like(K, 1e-9))
    per_type_cover = (prob.d[:, None] / safe_K).amax(0)                # (n,)
    covered = ((K > 0) | (prob.d[:, None] == 0)).all(0)                # (n,)
    cover_cost = torch.where(covered & (prob.mask > 0),
                             per_type_cover * prob.c,
                             torch.full_like(per_type_cover, float("inf")))
    n_single = min(n_starts // 2, 16)
    order = torch.argsort(cover_cost, stable=True)[:n_single]
    singles = torch.zeros((n_single, n), dtype=torch.float32, device=dev)
    singles[torch.arange(n_single, device=dev), order] = torch.clamp(
        per_type_cover[order], 0.0, 1e4)

    # random scaled starts: E[Kx] ~ d on average
    n_rand = n_starts - n_single - 1
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    u = torch.rand((max(n_rand, 1), n), generator=generator).to(dev)
    col_mean = torch.clamp(K.mean(1), min=1e-9)                        # (m,)
    scale = (prob.d / (col_mean * n)).amax()
    rand = 2.0 * scale * u * prob.mask

    zeros = torch.zeros((1, n), dtype=torch.float32, device=dev)
    return torch.cat([zeros, singles, rand[:n_rand]], 0)[:n_starts]


def _solve_batch(prob: AllocationProblem, starts: torch.Tensor,
                 cfg: SolverConfig, use_kernel: bool = True):
    """Relax from every start, then round EVERY start: relaxed merit is a
    poor predictor of the integer cost (two relaxations within 1% can round
    3x apart)."""
    res = solve_relaxation(prob, starts, cfg, use_kernel)
    x_int = round_and_polish(prob, res.x, use_kernel=use_kernel)
    f_int = obj.objective(prob, x_int, use_kernel)
    feas_int = obj.is_feasible(prob, x_int, 1e-3)
    return res, x_int, f_int, feas_int


def multistart_solve(prob: AllocationProblem, n_starts: int = 8,
                     seed: int = 0, cfg: Optional[SolverConfig] = None,
                     use_kernel: bool = True) -> MultiStartResult:
    """Solve the relaxation from ``n_starts`` diverse starts at once, round
    every start, and pick the best feasible integer merit (paper §III.C);
    ties go to the first start, as the reference's argmin."""
    cfg = cfg or SolverConfig()
    starts = make_starts(prob, n_starts, seed)
    res, x_int, f_int, feas_int = _solve_batch(prob, starts, cfg, use_kernel)
    j = torch.where(feas_int, f_int, f_int + 1e12).argmin()
    # the relaxed best, kept for diagnostics
    i = torch.where(res.feasible, res.fun, res.fun + 1e12).argmin()
    return MultiStartResult(best=SolveResult(*(a[i] for a in res)),
                            x_int=x_int[j], fun_int=f_int[j],
                            all_fun=res.fun, all_feasible=res.feasible,
                            x_all=res.x, x_int_all=x_int, fun_int_all=f_int,
                            feas_int_all=feas_int)
