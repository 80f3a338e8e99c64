"""Consensus ADMM (operator splitting) for the time-expanded horizon
program — port of ``repro.horizon.admm``.

    min_X  F(X) + g(Z)   s.t.  X = Z                    (consensus)

    F(X) = Σ_h [ f_h(X_h) + band_h(X_h) ] + Ind_C(X)    per-tick blocks
    g(Z)  = coupling(Z) + commit_coupling(Z_0, x_cur) + churn_bound(Z)

with the scaled-dual iteration of Boyd et al. 2011, §3, over-relaxed by
``ADMM_ALPHA`` (§3.4.3):

    X^{k+1}_h = argmin_{x∈C_h} f_h(x) + band_h(x) + ρ/2 ||x − (Z_h − U_h)||²
    Z^{k+1}   = argmin_Z g(Z) + ρ/2 ||X̂^{k+1} + U^k − Z||²
    U^{k+1}   = U^k + X̂^{k+1} − Z^{k+1},   X̂ = α X^{k+1} + (1 − α) Z^k

Every outer iteration makes two calls of the shared BB/Armijo engine
(``core.pgd``), each over many lanes at once: the committed-tick prox of
the B windows (box ∩ the L1 churn ball, exact ``project_incremental``),
and the planned-tick proxes of all B·(H−1) planned ticks as ONE batched
call — lane (b, h) is tick h of window b, a stacked problem of B·(H−1)
rows. On the card each call's eq. (1) values and gradients are
``alloc_objective`` fleet launches (B and B·(H−1) problems). The Z-update
stays branch-free, as in the reference: ``inner_steps`` fixed gradient
steps with the analytic step 1/(ρ + L̂), no line search, so a lane's
trajectory does not depend on the other lanes.

The outer loop is a Python loop over the B windows at once with a per-lane
``done`` mask (Boyd §3.3's relative residual rule): a lane that stopped
keeps its state exactly, so it follows the trajectory it would follow
alone. The host reads the mask once per outer iteration (k = 1); the
inner engine reads its own every ``core.pgd.SYNC_EVERY`` iterations.

H = 1 has nothing to split: ``repro_torch.horizon.solver`` dispatches it
to the ``solve_incremental`` merit triple.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..core import objective as obj
from ..core.incremental import project_incremental
from ..core.pgd import PGDConfig, pgd_minimize
from .problem import _lanes_like, smoothed_churn


class ADMMDiag(NamedTuple):
    """Convergence certificate of one ADMM solve, per lane ((B,) leaves):
    the final scaled residual pair and the outer iterations taken."""

    primal_res: torch.Tensor    # ||X - Z||_F at the final iterate
    dual_res: torch.Tensor      # rho * ||Z - Z_prev||_F at the final iterate
    admm_iters: torch.Tensor    # outer (consensus) iterations actually taken


class ADMMTrace(NamedTuple):
    """Per-outer-iteration residual rows of a traced ADMM solve: (B, L)
    tensors, L = ``admm_iters``. Rows at indices >= a lane's outer
    iteration count were never written and hold NaN / NaN / -1.

    * ``primal`` — primal residual ``||X − Z||_F`` after the iteration.
    * ``dual``   — dual residual ``ρ·||Z − Z_prev||_F`` after it.
    * ``inner``  — inner PGD iterations of that sweep (committed prox +
      planned prox blocks + Z-update)."""

    primal: torch.Tensor     # (B, L) float32
    dual: torch.Tensor       # (B, L) float32
    inner: torch.Tensor      # (B, L) int32


def _empty_admm_trace(B: int, L: int, device) -> ADMMTrace:
    nan = lambda: torch.full((B, L), float("nan"), dtype=torch.float32,
                             device=device)
    return ADMMTrace(primal=nan(), dual=nan(),
                     inner=torch.full((B, L), -1, dtype=torch.int32,
                                      device=device))


#: Over-relaxation factor (Boyd et al. 2011, §3.4.3 recommend 1.5–1.8).
ADMM_ALPHA = 1.6


def _sqnorm(a: torch.Tensor) -> torch.Tensor:
    """<a, a> per lane over every non-lane axis."""
    return (a * a).flatten(1).sum(-1)


def admm_solve_plan(W, x_current: torch.Tensor, delta_max: torch.Tensor,
                    x_init: torch.Tensor, *, rho: float, admm_iters: int,
                    inner_steps: int, admm_tol: float, penalty_w: float,
                    delta_penalty_w: float, inner_cfg: PGDConfig,
                    use_kernel: bool = True, trace: bool = False):
    """One consensus-ADMM solve of B windows at once (H >= 2).

    ``W`` is the solver's window (``repro_torch.horizon.solver._Window``:
    the B·H tick problems, tick 0's and the planned ticks' stacks, the
    coupling terms), x_current (B, n), delta_max (B,), x_init (B, H, n).
    Returns ``(X, total_inner_iters, ADMMDiag)``, and the
    :class:`ADMMTrace` last with ``trace=True``: X (B, H, n) is the
    feasible per-tick-block plan (row 0 inside the hard churn ball),
    ``total_inner_iters`` (B,) every inner PGD iteration of its sweeps."""
    B, H, n = x_init.shape
    if H < 2:
        raise ValueError("admm_solve_plan needs a real window; H = 1 runs "
                         "the solve_incremental triple")
    dev = x_init.device
    f32 = dict(dtype=torch.float32, device=dev)
    pw = torch.as_tensor(penalty_w, **f32)
    rho_ = torch.as_tensor(rho, **f32)
    tol = torch.as_tensor(admm_tol, **f32)
    P0, rest = W.P0, W.rest
    R = B * (H - 1)

    def prox_committed(v, x0):
        # tick-0 blocks: eq. (1) + rho/2||x - v||^2 over box ∩ churn ball
        def val(x):
            d = x - _lanes_like(v, x)
            return obj.objective(P0, x, use_kernel) + 0.5 * rho_ * (
                d * d).sum(-1)

        def grd(x):
            return obj.grad_objective(P0, x, use_kernel) + rho_ * (x - v)

        def prj(x):
            return project_incremental(P0, x, x_current, delta_max)

        return pgd_minimize(val, grd, prj, x0, inner_cfg)

    def prox_planned(v, x0):
        # the B·(H-1) planned blocks, one lane each: eq. (1) + band
        # penalty + rho/2||x - v||^2 over the box
        def val(x):
            d = x - _lanes_like(v, x)
            return (obj.objective(rest, x, use_kernel)
                    + obj.penalty(rest, x, pw) + 0.5 * rho_ * (d * d).sum(-1))

        def grd(x):
            return (obj.grad_objective(rest, x, use_kernel)
                    + obj.penalty_grad(rest, x, pw) + rho_ * (x - v))

        def prj(x):
            return obj.project(rest, x)

        return pgd_minimize(val, grd, prj, x0, inner_cfg)

    tdefs = W.term_defs(x_current, delta_max, delta_penalty_w)

    def z_grad(Z, Wt):
        g = tdefs[0].grad(Z)
        for td in tdefs[1:]:
            g = g + td.grad(Z)
        return g + rho_ * (Z - Wt)

    inv_seps = 1.0 / torch.sqrt(W.coupling_eps)
    dpw = torch.as_tensor(delta_penalty_w, **f32)

    def z_update(Wt, z):
        # inner_steps fixed gradient steps of 1/(rho + L̂(z)), L̂ the
        # reference's analytic curvature bound at the current iterate
        # (data-dependent, branch-free: no accept/reject decision)
        for _ in range(inner_steps):
            sc = smoothed_churn(z, W.coupling_eps)
            e = torch.clamp(sc - delta_max[:, None], min=0.0).amax(-1)
            act = (e > 0.0).to(torch.float32)
            L_hat = (2.0 * W.coupling_w * inv_seps
                     + 2.0 * dpw * (2.0 * n * act + e * inv_seps))
            z = z - (1.0 / (rho_ + L_hat))[:, None, None] * z_grad(z, Wt)
        return z

    # init: the warm start projected into the per-tick feasible sets; the
    # consensus copy starts in agreement and the dual at rest
    x0 = project_incremental(P0, x_init[:, 0], x_current, delta_max)
    X = torch.cat([x0[:, None], W.box(x_init)[:, 1:]], 1)
    Z, U = X, torch.zeros_like(X)
    it = torch.zeros(B, dtype=torch.int64, device=dev)
    inner = torch.zeros(B, dtype=torch.int64, device=dev)
    r = torch.full((B,), float("inf"), **f32)
    s = torch.full((B,), float("inf"), **f32)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    tr = _empty_admm_trace(B, admm_iters, dev) if trace else None
    cols = torch.arange(admm_iters, device=dev)
    for k in range(admm_iters):
        if bool(done.all()):
            break
        V = Z - U
        x0_new, _, it0 = prox_committed(V[:, 0], X[:, 0])
        xr, _, itr = prox_planned(V[:, 1:].reshape(R, n),
                                  X[:, 1:].reshape(R, n))
        X_new = torch.cat([x0_new[:, None], xr.reshape(B, H - 1, n)], 1)
        X_hat = ADMM_ALPHA * X_new + (1.0 - ADMM_ALPHA) * Z
        Z_new = z_update(X_hat + U, Z)
        U_new = U + X_hat - Z_new
        r_new = torch.sqrt(_sqnorm(X_new - Z_new))
        s_new = rho_ * torch.sqrt(_sqnorm(Z_new - Z))
        # Boyd §3.3 stopping: residuals relative to the iterate scale
        scale_p = 1.0 + torch.maximum(torch.sqrt(_sqnorm(X_new)),
                                      torch.sqrt(_sqnorm(Z_new)))
        scale_d = 1.0 + rho_ * torch.sqrt(_sqnorm(U_new))
        done_new = (r_new <= tol * scale_p) & (s_new <= tol * scale_d)
        step_inner = it0 + itr.reshape(B, H - 1).sum(1) + inner_steps
        live = ~done
        lx = live[:, None, None]
        X = torch.where(lx, X_new, X)
        Z = torch.where(lx, Z_new, Z)
        U = torch.where(lx, U_new, U)
        r = torch.where(live, r_new, r)
        s = torch.where(live, s_new, s)
        if tr is not None:
            at = live[:, None] & (cols == k)
            tr = ADMMTrace(
                primal=torch.where(at, r_new[:, None], tr.primal),
                dual=torch.where(at, s_new[:, None], tr.dual),
                inner=torch.where(at, step_inner.to(torch.int32)[:, None],
                                  tr.inner))
        inner = inner + torch.where(live, step_inner,
                                    torch.zeros_like(step_inner))
        it = it + live
        done = done | (live & done_new)
    diag = ADMMDiag(primal_res=r, dual_res=s, admm_iters=it)
    if trace:
        return X, inner, diag, tr
    return X, inner, diag


def admm_residual_history(tr: ADMMTrace) -> Tuple[np.ndarray, np.ndarray]:
    """The valid (written) rows of a single-lane trace's residual pair —
    ``(primal, dual)`` trimmed of the NaN sentinel tail (host numpy)."""
    host = lambda a: (a.detach().cpu().numpy() if torch.is_tensor(a)
                      else np.asarray(a))
    primal = host(tr.primal)
    valid = ~np.isnan(primal)
    return primal[valid], host(tr.dual)[valid]
