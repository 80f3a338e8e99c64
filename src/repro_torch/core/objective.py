"""The eq. (1) objective, its analytic gradient, and the constraint
machinery — port of ``repro.core.objective``.

x is (..., n) for a single problem and (B, ..., n) for a stacked one; the
value is per point and the gradient is shaped like x. On a CUDA tensor the
four base terms come from the hand-written ``alloc_objective`` kernel (one
launch for all points), as the Pallas kernel computes them, and the
attached scenario terms are added in plain PyTorch
(``terms.active_value`` / ``active_grad``), as the reference's fleet
solver adds them around its kernel; on a CPU tensor f is the registry sum
of ``repro_torch.core.terms`` over base and attached terms, as in the
reference. ``use_kernel=False`` asks for the registry sum on any device:
the plain path a run can be compared with, never a fallback.

The barrier and penalty terms are written once, for single and stacked
problems alike: the single-problem relaxation (``core.solver``) adds them
to ``objective`` in ``composite``, and the fleet solver adds them to its
kernel's values through ``barrier_or_penalty`` and its gradient.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..kernels.alloc_objective import ops
from . import terms as _terms
from .problem import AllocationProblem, is_stacked, lane, matvec, rmatvec


def _kernel_route(x: torch.Tensor, use_kernel: bool) -> bool:
    return use_kernel and x.is_cuda


def kernel_value_and_grad(prob: AllocationProblem, x: torch.Tensor,
                          need_grad: bool, use_kernel: bool = True):
    """eq. (1) over every point of x as the hand-batched hot loops compute
    it: the four base terms from one launch of the ``alloc_objective``
    kernel (its plain version where ``use_kernel`` is False or x lies on
    the CPU), plus the attached scenario terms in plain PyTorch, as the
    reference adds them around its Pallas kernel: (f (...), g or None)."""
    n = x.shape[-1]
    if is_stacked(prob):
        X = x.reshape(x.shape[0], -1, n).contiguous()
        if need_grad:
            f, g = ops.fleet_value_and_grad(prob, X, use_kernel=use_kernel)
            f, g = f.reshape(x.shape[:-1]), g.reshape(x.shape)
        else:
            f = ops.fleet_value(prob, X, use_kernel=use_kernel)
            f, g = f.reshape(x.shape[:-1]), None
    else:
        f, g = ops.batched_value_and_grad(prob, x.reshape(-1, n).contiguous(),
                                          use_kernel=use_kernel)
        f, g = f.reshape(x.shape[:-1]), g.reshape(x.shape)
    if prob.terms:
        f = f + _terms.active_value(prob, x)
        if g is not None:
            g = g + _terms.active_grad(prob, x)
    return f, g


def objective_terms(prob: AllocationProblem, x: torch.Tensor
                    ) -> Dict[str, torch.Tensor]:
    """Each named term of f(x), one K@x / E@x pair shared by all."""
    return _terms.term_values(prob, x, matvec(prob, prob.K, x),
                              matvec(prob, prob.E, x))


def objective(prob: AllocationProblem, x: torch.Tensor,
              use_kernel: bool = True) -> torch.Tensor:
    """f(x), one value per point."""
    if _kernel_route(x, use_kernel):
        return kernel_value_and_grad(prob, x, need_grad=False)[0]
    return _terms.sum_terms(objective_terms(prob, x))


def grad_objective(prob: AllocationProblem, x: torch.Tensor,
                   use_kernel: bool = True) -> torch.Tensor:
    """Analytic gradient (eq. 6/8):
    c + a*b1*E^T e^{-b1 Ex} - g*b2*E^T 1/(1+b2 Ex) - 2*b3*K^T max(d-Kx, 0)."""
    if _kernel_route(x, use_kernel):
        return value_and_grad(prob, x, use_kernel)[1]
    return _terms.sum_terms(_terms.term_grads(
        prob, x, matvec(prob, prob.K, x), matvec(prob, prob.E, x)))


def value_and_grad(prob: AllocationProblem, x: torch.Tensor,
                   use_kernel: bool = True):
    """(f(x), grad f(x)) from one K@x / E@x pair (one kernel launch)."""
    if _kernel_route(x, use_kernel):
        return kernel_value_and_grad(prob, x, need_grad=True)
    Kx = matvec(prob, prob.K, x)
    Ex = matvec(prob, prob.E, x)
    return (_terms.sum_terms(_terms.term_values(prob, x, Kx, Ex)),
            _terms.sum_terms(_terms.term_grads(prob, x, Kx, Ex)))


def constraint_residuals(prob: AllocationProblem, x: torch.Tensor):
    """Positive residual == satisfied. Returns (lower (..., m), upper)."""
    Kx = matvec(prob, prob.K, x)
    return (Kx - lane(prob, prob.d - prob.mu, Kx),
            lane(prob, prob.d + prob.g, Kx) - Kx)


def _violation(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    return ((torch.clamp(-lo, min=0.0) ** 2).sum(-1)
            + (torch.clamp(-hi, min=0.0) ** 2).sum(-1))


def _barrier_value(lo: torch.Tensor, hi: torch.Tensor, t) -> torch.Tensor:
    safe = (lo > 0).all(-1) & (hi > 0).all(-1)
    one = torch.ones_like(lo)
    val = -(1.0 / t) * (torch.log(torch.where(lo > 0, lo, one)).sum(-1)
                        + torch.log(torch.where(hi > 0, hi, one)).sum(-1))
    return torch.where(safe, val, torch.full_like(val, float("inf")))


def _barrier_grad(prob, lo, hi, t) -> torch.Tensor:
    lo = torch.clamp(lo, min=1e-9)
    hi = torch.clamp(hi, min=1e-9)
    return (1.0 / t) * (rmatvec(prob, prob.K, 1.0 / hi)
                        - rmatvec(prob, prob.K, 1.0 / lo))


def _penalty_grad(prob, lo, hi, w) -> torch.Tensor:
    return w * 2.0 * (rmatvec(prob, prob.K, torch.clamp(-hi, min=0.0))
                      - rmatvec(prob, prob.K, torch.clamp(-lo, min=0.0)))


def constraint_violation(prob: AllocationProblem, x: torch.Tensor
                         ) -> torch.Tensor:
    """Squared violation of the two-sided band (0 iff band-feasible)."""
    return _violation(*constraint_residuals(prob, x))


def barrier(prob: AllocationProblem, x: torch.Tensor, t) -> torch.Tensor:
    """Log-barrier for the two-sided Kx constraint; +inf outside the strict
    interior (the line search rejects such points)."""
    return _barrier_value(*constraint_residuals(prob, x), t)


def barrier_grad(prob: AllocationProblem, x: torch.Tensor, t
                 ) -> torch.Tensor:
    """Gradient of the log-barrier (residuals clamped away from 0)."""
    return _barrier_grad(prob, *constraint_residuals(prob, x), t)


def penalty(prob: AllocationProblem, x: torch.Tensor, w) -> torch.Tensor:
    """Smooth quadratic penalty, used when no strict interior exists."""
    return w * constraint_violation(prob, x)


def penalty_grad(prob: AllocationProblem, x: torch.Tensor, w
                 ) -> torch.Tensor:
    """Gradient of the quadratic penalty."""
    return _penalty_grad(prob, *constraint_residuals(prob, x), w)


def barrier_or_penalty(prob: AllocationProblem, x: torch.Tensor, barrier_t,
                       penalty_w, use_barrier: torch.Tensor) -> torch.Tensor:
    """Per point, the barrier where ``use_barrier`` (a bool broadcastable
    against x.shape[:-1]) holds, else the penalty; one K@x for both."""
    lo, hi = constraint_residuals(prob, x)
    return torch.where(use_barrier, _barrier_value(lo, hi, barrier_t),
                       penalty_w * _violation(lo, hi))


def barrier_or_penalty_grad(prob: AllocationProblem, x: torch.Tensor,
                            barrier_t, penalty_w, use_barrier: torch.Tensor
                            ) -> torch.Tensor:
    """Gradient of :func:`barrier_or_penalty`, shaped like x."""
    lo, hi = constraint_residuals(prob, x)
    return torch.where(use_barrier[..., None],
                       _barrier_grad(prob, lo, hi, barrier_t),
                       _penalty_grad(prob, lo, hi, penalty_w))


def composite(prob: AllocationProblem, x: torch.Tensor, barrier_t,
              penalty_w, use_barrier: torch.Tensor, use_kernel: bool = True
              ) -> torch.Tensor:
    """f(x) + (barrier | penalty), one value per point."""
    return (objective(prob, x, use_kernel)
            + barrier_or_penalty(prob, x, barrier_t, penalty_w, use_barrier))


def composite_grad(prob: AllocationProblem, x: torch.Tensor, barrier_t,
                   penalty_w, use_barrier: torch.Tensor,
                   use_kernel: bool = True) -> torch.Tensor:
    """Gradient of :func:`composite` — the relaxation's per-iteration
    gradient (one kernel launch for eq. (1) on the card)."""
    return (grad_objective(prob, x, use_kernel)
            + barrier_or_penalty_grad(prob, x, barrier_t, penalty_w,
                                      use_barrier))


def is_feasible(prob: AllocationProblem, x: torch.Tensor, tol: float = 1e-4
                ) -> torch.Tensor:
    """Band + box feasibility within ``tol``, one flag per point."""
    lo, hi = constraint_residuals(prob, x)
    box = ((x >= lane(prob, prob.lb, x) - tol).all(-1)
           & (x <= lane(prob, prob.ub, x) + tol).all(-1))
    return (lo >= -tol).all(-1) & (hi >= -tol).all(-1) & box


def project(prob: AllocationProblem, x: torch.Tensor) -> torch.Tensor:
    """Project onto the box [lb, ub] intersected with the mask support."""
    return (torch.minimum(torch.maximum(x, lane(prob, prob.lb, x)),
                          lane(prob, prob.ub, x))
            * lane(prob, prob.mask, x))
