"""The barrier/penalty relaxation solver — port of ``repro.core.solver``.

Per solve: a phase-1 point, then ``barrier_rounds`` rounds of the shared
BB/Armijo engine (``core.pgd.pgd_minimize``, ftol 0) on eq. (1) plus a
log-barrier (``barrier_t`` grows by ``barrier_kappa`` a round) or, where
the phase-1 point is not strictly inside the band, a quadratic penalty;
then a feasibility restoration. The reference ``vmap``s one start's solve
over the starts; here the start dimension is written out: x0 is (n,) or
(S, n), and every start is a lane of one ``pgd_minimize`` call under its
own ``done`` mask. On a CUDA tensor every eq. (1) evaluation is one launch
of the ``alloc_objective`` kernel for all starts (``use_kernel=False``:
the plain version).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import objective as obj
from .pgd import PGDConfig, pgd_minimize
from .problem import AllocationProblem, is_stacked, lane, matvec, rmatvec


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


class SolveResult(NamedTuple):
    """Relaxed solves, one per start (scalars for a single (n,) start):
    final iterate, objective, merit, effort, and whether the barrier (vs
    quadratic-penalty) path was taken."""

    x: torch.Tensor
    fun: torch.Tensor            # objective f(x) (WITHOUT barrier/penalty)
    composite: torch.Tensor      # final merit value
    iters: torch.Tensor
    feasible: torch.Tensor
    used_barrier: torch.Tensor


def _pgd(prob, x0, barrier_t, penalty_w, use_barrier, cfg: SolverConfig,
         use_kernel: bool = True):
    """Inner projected-gradient loop over the (S, n) lanes: merit = eq. (1)
    + barrier or quadratic penalty (per lane), projection = box ∩ mask.
    ftol = 0: only literal zero-progress cycling stops a lane early."""
    S = x0.shape[0]

    def F(X):
        """Merit per point; X is (S, n) or the (S, L, n) ladder."""
        ub = use_barrier.reshape(S, *(1,) * (X.dim() - 2))
        return obj.composite(prob, X, barrier_t, penalty_w, ub, use_kernel)

    def G(X):
        return obj.composite_grad(prob, X, barrier_t, penalty_w,
                                  use_barrier, use_kernel)

    pcfg = PGDConfig(max_iters=cfg.max_iters, step0=cfg.step0,
                     n_backtracks=cfg.n_backtracks, backtrack=cfg.backtrack,
                     armijo_c=cfg.armijo_c, tol=cfg.tol, ftol=0.0)
    return pgd_minimize(F, G, lambda X: obj.project(prob, X), x0, pcfg)


def solve_relaxation(prob: AllocationProblem, x0: torch.Tensor,
                     cfg: SolverConfig = SolverConfig(),
                     use_kernel: bool = True) -> SolveResult:
    """Solve the continuous relaxation from x0, every start a lane: a
    single problem takes one start (n,) or S starts (S, n); a stacked one
    (B lanes, e.g. a parameter grid) one start per lane, (B, n), and its
    eq. (1) evaluations go through the kernel's fleet form."""
    x0 = torch.as_tensor(x0, dtype=torch.float32, device=prob.device)
    lead = x0.shape[:-1]
    if is_stacked(prob):
        if tuple(x0.shape) != tuple(prob.c.shape):
            raise ValueError(f"a stacked problem takes one start per lane, "
                             f"{tuple(prob.c.shape)}; got {tuple(x0.shape)}")
        x = phase1_point(prob, x0)
    else:
        x = phase1_point(prob, x0.reshape(-1, prob.n))
    lo, hi = obj.constraint_residuals(prob, x)
    strict = (lo.amin(-1) > 1e-3) & (hi.amin(-1) > 1e-3)           # (S,)
    f32 = dict(dtype=torch.float32, device=x.device)
    penalty_w = torch.tensor(cfg.penalty_w, **f32)
    iters = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    for r in range(cfg.barrier_rounds):
        t = cfg.barrier_t0 * torch.tensor(cfg.barrier_kappa, **f32) ** float(r)
        x, _, it = _pgd(prob, x, t, penalty_w, strict, cfg, use_kernel)
        iters = iters + it
    # feasibility restoration: a no-op when feasible (the phase-1 gradient
    # is 0 at margin 0), else it walks the residual violation to ~0
    x = phase1_point(prob, x, steps=100, margin_frac=0.0)
    t0 = torch.tensor(cfg.barrier_t0, **f32)
    res = SolveResult(
        x=x, fun=obj.objective(prob, x, use_kernel),
        composite=obj.composite(prob, x, t0, penalty_w, strict, use_kernel),
        iters=iters, feasible=obj.is_feasible(prob, x, tol=1e-3),
        used_barrier=strict)
    return SolveResult(*(a.reshape(lead + a.shape[1:]) for a in res))
