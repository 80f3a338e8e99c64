"""Incremental adoption (paper §III.E): ||x - x_current||_1 <= delta_max —
port of ``repro.core.incremental`` (untraced, no anytime mode).

The exact Euclidean projection onto the L1 ball around ``x_current``
(Duchi et al. 2008) alternates with the box projection, and
``solve_incremental_info`` runs the shared BB/Armijo engine
(``repro_torch.core.pgd``) on the eq. (1) objective over that set: the
controller's warm tick, and — one lane per tenant — the batched fleet
tick ``solve_fleet_step``. On the card the engine's values and gradients
come from the ``alloc_objective`` kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import objective as obj
from .pgd import PGDConfig, pgd_minimize
from .problem import AllocationProblem, is_stacked, lane, unsqueeze_problem


def project_l1_ball(v: torch.Tensor, radius: torch.Tensor) -> torch.Tensor:
    """Euclidean projection of every row of v (..., n) onto
    {z : ||z||_1 <= radius}; ``radius`` broadcasts against v[..., 0]."""
    radius = torch.as_tensor(radius, dtype=v.dtype, device=v.device)
    abs_v = v.abs()
    inside = abs_v.sum(-1) <= radius
    u = torch.sort(abs_v, dim=-1, descending=True).values
    css = torch.cumsum(u, -1)
    ks = torch.arange(1, v.shape[-1] + 1, dtype=v.dtype, device=v.device)
    cond = u * ks > (css - radius[..., None])
    rho = torch.where(cond, ks, torch.zeros_like(ks)).amax(-1)
    rho = torch.clamp(rho, min=1.0)
    theta = (torch.where(ks <= rho[..., None], u, torch.zeros_like(u)).sum(-1)
             - radius) / rho
    w = torch.sign(v) * torch.clamp(abs_v - theta[..., None], min=0.0)
    return torch.where(inside[..., None], v, w)


def project_incremental(prob: AllocationProblem, x: torch.Tensor,
                        x_current: torch.Tensor, delta_max,
                        n_alternations: int = 8) -> torch.Tensor:
    """Project onto box ∩ {||x - x_current||_1 <= delta_max} by alternating
    exact projections (the last box-feasible iterate). For a stacked
    problem x is (B, ..., n), x_current (B, n) and delta_max (B,)."""
    xc = lane(prob, x_current, x)
    dm = lane(prob, torch.as_tensor(delta_max, dtype=x.dtype,
                                    device=x.device), x[..., 0])
    z = obj.project(prob, x)
    for _ in range(n_alternations):
        z = xc + project_l1_ball(z - xc, dm)
        z = obj.project(prob, z)
    return z


def solve_incremental_info(
    prob: AllocationProblem,
    x_current: torch.Tensor,
    delta_max,
    x_init: Optional[torch.Tensor] = None,
    steps: int = 600,
    cfg: Optional[PGDConfig] = None,
    use_kernel: bool = True,
):
    """Adaptive PGD on f over the incremental-adoption set, warm-started
    from the current allocation (or ``x_init``). Returns ``(x, iters)``.

    A single problem takes x_current (n,) and a scalar delta_max; a stacked
    one solves every lane at once, x_current (B, n) and delta_max (B,)."""
    single = not is_stacked(prob)
    if single:
        prob = unsqueeze_problem(prob)
    dev = prob.device
    xc = torch.as_tensor(x_current, dtype=torch.float32, device=dev)
    xc = xc[None] if single else xc
    dm = torch.as_tensor(delta_max, dtype=torch.float32, device=dev)
    dm = dm.reshape(1) if single else torch.broadcast_to(dm, xc.shape[:1])
    x0 = xc if x_init is None else torch.as_tensor(
        x_init, dtype=torch.float32, device=dev).reshape(xc.shape)
    if cfg is None:
        cfg = PGDConfig(max_iters=int(steps))
    x, _, iters = pgd_minimize(
        lambda X: obj.objective(prob, X, use_kernel),
        lambda X: obj.grad_objective(prob, X, use_kernel),
        lambda X: project_incremental(prob, X, xc, dm),
        x0, cfg)
    return (x[0], iters[0]) if single else (x, iters)

