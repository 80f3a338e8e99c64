"""Incremental adoption (paper §III.E): ||x - x_current||_1 <= delta_max —
port of ``repro.core.incremental``.

The exact Euclidean projection onto the L1 ball around ``x_current``
(Duchi et al. 2008) alternates with the box projection, and
``solve_incremental_info`` runs the shared BB/Armijo engine
(``repro_torch.core.pgd``) on the eq. (1) objective over that set: the
controller's warm tick, and — one lane per tenant — the batched fleet
tick ``solve_fleet_step``. On the card the engine's values and gradients
come from the ``alloc_objective`` kernel. The same merit triple feeds the
traced engine (``capture_trace=True``) and the chunked anytime engine
(``anytime=AnytimeConfig(deadline_ms=...)``), so all three walk one
trajectory.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import objective as obj
from .pgd import (AnytimeConfig, PGDConfig, pgd_chunk_init, pgd_chunk_run,
                  pgd_minimize, pgd_minimize_traced, run_anytime)
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


def _incremental_merit_fns(prob: AllocationProblem, x_current, delta_max,
                           use_kernel: bool):
    """The warm tick's ``(value, grad, project)`` triple over every lane of
    a stacked problem: eq. (1) over box ∩ L1 churn ball. One triple for
    the monolithic, traced and chunked engines."""
    return (lambda X: obj.objective(prob, X, use_kernel),
            lambda X: obj.grad_objective(prob, X, use_kernel),
            lambda X: project_incremental(prob, X, x_current, delta_max))


def incremental_anytime_init(prob: AllocationProblem, x_current, delta_max,
                             x0, cfg: PGDConfig, use_kernel: bool = True):
    """Chunk-state init of the warm tick's anytime mode, every lane of the
    stacked ``prob`` at once (x_current, x0 (B, n), delta_max (B,))."""
    return pgd_chunk_init(*_incremental_merit_fns(prob, x_current, delta_max,
                                                  use_kernel), x0, cfg)


def incremental_anytime_chunk(prob: AllocationProblem, x_current, delta_max,
                              state, it_end: int, cfg: PGDConfig,
                              use_kernel: bool = True):
    """Advance the warm tick's anytime state to the cap ``it_end``."""
    return pgd_chunk_run(*_incremental_merit_fns(prob, x_current, delta_max,
                                                 use_kernel),
                         state, it_end, cfg)


def solve_incremental_info(
    prob: AllocationProblem,
    x_current: torch.Tensor,
    delta_max,
    x_init: Optional[torch.Tensor] = None,
    steps: int = 600,
    cfg: Optional[PGDConfig] = None,
    use_kernel: bool = True,
    capture_trace: bool = False,
    anytime: Optional[AnytimeConfig] = None,
):
    """Adaptive PGD on f over the incremental-adoption set, warm-started
    from the current allocation (or ``x_init``). Returns ``(x, iters)``.

    A single problem takes x_current (n,) and a scalar delta_max; a stacked
    one solves every lane at once, x_current (B, n) and delta_max (B,).

    ``capture_trace=True`` returns ``(x, iters, trace)``, ``trace`` the
    engine's :class:`~repro_torch.core.pgd.PGDTrace` (rows (steps,) for a
    single problem, (B, steps) for a stacked one); ``x`` and ``iters`` equal
    the untraced call's. An enabled ``anytime`` config runs the solve in
    chunks against ``anytime.clock`` and returns ``(x_best, iters,
    AnytimeReport)``: the best-so-far feasible iterate by merit when the
    budget expires. ``anytime=None`` or a disabled config takes the
    untruncated path. Anytime and ``capture_trace`` exclude each other."""
    if anytime is not None and anytime.enabled and capture_trace:
        raise ValueError("anytime deadlines and capture_trace are mutually "
                         "exclusive (truncated traces would be "
                         "misleading); drop one")
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
    first = (lambda t: t[0]) if single else (lambda t: t)
    if anytime is not None and anytime.enabled:
        state, report = run_anytime(
            lambda: incremental_anytime_init(prob, xc, dm, x0, cfg,
                                             use_kernel),
            lambda s, e: incremental_anytime_chunk(prob, xc, dm, s, e, cfg,
                                                   use_kernel),
            cfg, anytime)
        return first(state.x_best), first(state.it), report
    fns = _incremental_merit_fns(prob, xc, dm, use_kernel)
    if capture_trace:
        x, _, iters, tr = pgd_minimize_traced(*fns, x0, cfg)
        return first(x), first(iters), type(tr)(*(first(f) for f in tr))
    x, _, iters = pgd_minimize(*fns, x0, cfg)
    return first(x), first(iters)
