"""KKT conditions (paper §II.C, eq. 8-11): residuals and multiplier
recovery — port of ``repro.core.kkt``.

Given a primal candidate x, the multipliers (lambda, nu, omega) are
recovered by non-negative least squares on the stationarity equation
restricted to the active sets, and the four KKT residual groups are
reported. The stationarity gradient is ``core.objective.grad_objective``,
so on a CUDA tensor it is one launch of the ``alloc_objective`` kernel's
single-problem form; the NNLS fit is plain matrix products, as in the
reference (no Pallas kernel there either).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import objective as obj
from .problem import AllocationProblem


class KKTReport(NamedTuple):
    """KKT residual groups + recovered multipliers for a primal candidate."""

    stationarity: torch.Tensor       # ||grad L||_inf after multiplier fit
    primal_lo: torch.Tensor          # max violation of Kx >= d - mu
    primal_hi: torch.Tensor          # max violation of Kx <= d + g
    primal_box: torch.Tensor         # max violation of x >= lb (box)
    dual: torch.Tensor               # max negative multiplier (>=0 by constr.)
    comp_slack: torch.Tensor         # max |multiplier * slack|
    lam: torch.Tensor                # (m,)
    nu: torch.Tensor                 # (m,)
    omega: torch.Tensor              # (n,)


def _nnls_pgd(A: torch.Tensor, b: torch.Tensor, iters: int = 500
              ) -> torch.Tensor:
    """min ||A theta - b||^2 s.t. theta >= 0 via projected gradient."""
    AtA = A.T @ A
    Atb = A.T @ b
    # ||AtA||_2 as the reference takes it; AtA is symmetric PSD, so it is
    # its largest eigenvalue, which eigvalsh finds without an SVD
    L = torch.linalg.eigvalsh(AtA)[-1] + 1e-6
    th = torch.zeros(A.shape[1], dtype=A.dtype, device=A.device)
    for _ in range(iters):
        th = torch.clamp(th - (AtA @ th - Atb) / L, min=0.0)
    return th


def kkt_report(prob: AllocationProblem, x: torch.Tensor,
               active_tol: float = 1e-2,
               barrier_t: Optional[torch.Tensor] = None,
               use_kernel: bool = True) -> KKTReport:
    """Recover multipliers for a primal candidate ``x`` (n,) of a single
    problem and report the four KKT residual groups (eq. 8-11). With
    ``barrier_t`` the interior-point estimates lam = 1/(t lo), nu = 1/(t hi)
    replace the NNLS fit. ``use_kernel`` routes the gradient as
    ``core.objective`` does."""
    m, n = prob.m, prob.n
    x = torch.as_tensor(x, dtype=torch.float32, device=prob.device)
    gf = obj.grad_objective(prob, x, use_kernel)
    lo, hi = obj.constraint_residuals(prob, x)
    KT = prob.K.T

    act_lo = (lo <= active_tol).to(torch.float32)          # lambda support
    act_hi = (hi <= active_tol).to(torch.float32)          # nu support
    act_x = (x <= prob.lb + active_tol).to(torch.float32)  # omega support

    if barrier_t is not None:
        lam = 1.0 / (barrier_t * torch.clamp(lo, min=1e-9))
        nu = 1.0 / (barrier_t * torch.clamp(hi, min=1e-9))
        resid = gf - KT @ lam + KT @ nu
        omega = torch.clamp(resid, min=0.0) * act_x
    else:
        # stationarity: gf - K^T lam + K^T nu - omega = 0
        #   => [-K^T diag(act_lo) | K^T diag(act_hi) | -diag(act_x)] theta = -gf
        eye = torch.eye(n, dtype=torch.float32, device=x.device)
        A = torch.cat([-KT * act_lo[None, :], KT * act_hi[None, :],
                       -eye * act_x[None, :]], dim=1)          # (n, 2m+n)
        theta = _nnls_pgd(A, -gf)
        lam, nu, omega = (theta[:m] * act_lo, theta[m:2 * m] * act_hi,
                          theta[2 * m:] * act_x)

    stat = (gf - KT @ lam + KT @ nu - omega).abs().max()
    comp = torch.maximum((lam * lo).abs().max(), (nu * hi).abs().max())
    comp = torch.maximum(comp, (omega * (x - prob.lb)).abs().max())
    return KKTReport(
        stationarity=stat,
        primal_lo=torch.clamp(-lo, min=0.0).max(),
        primal_hi=torch.clamp(-hi, min=0.0).max(),
        primal_box=torch.clamp(prob.lb - x, min=0.0).max(),
        dual=torch.maximum((-lam).max(),
                           torch.maximum((-nu).max(), (-omega).max())),
        comp_slack=comp,
        lam=lam, nu=nu, omega=omega,
    )
