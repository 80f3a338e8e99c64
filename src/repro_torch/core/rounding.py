"""Greedy rounding (paper §III.B) and the polish passes — port of
``repro.core.rounding``.

  1. x_hat = floor(x*)
  2. delta = d - K x_hat
  3. while delta has positive components:
       pick i maximizing  sum_{r: delta_r>0} K_ri * delta_r / c_i
       x_hat_i += 1; recompute delta

Every function rounds all lanes at once: x is (..., n) for a single
problem and (B, ..., n) for a stacked one, each point its own lane. The
reference's ``lax.while_loop`` becomes a Python loop in which a lane that
needs no more adds (or removes) stops changing; the host reads the lanes'
"still working" mask only every ``SYNC_EVERY`` adds (one device sync each),
so the loop may run a few frozen no-op steps past the last lane's end.
"""
from __future__ import annotations

import torch

from . import objective as obj
from .problem import AllocationProblem, is_stacked, lane, matvec, rmatvec

SYNC_EVERY = 16   # adds (or removes) between host reads of the lane mask


def _clip(prob: AllocationProblem, x: torch.Tensor) -> torch.Tensor:
    return torch.minimum(torch.maximum(x, lane(prob, prob.lb, x)),
                         lane(prob, prob.ub, x))


def greedy_round(prob: AllocationProblem, x_star: torch.Tensor,
                 max_adds: int = 4096) -> torch.Tensor:
    """Round fractional points to integer allocations covering d - mu."""
    x = torch.floor(_clip(prob, x_star)) * lane(prob, prob.mask, x_star)
    # deficits are measured against the hard lower bound d - mu
    target = lane(prob, prob.d - prob.mu, x)
    c_safe = lane(prob, torch.clamp(prob.c, min=1e-9), x)
    allowed = lane(prob, prob.mask, x) > 0
    ub = lane(prob, prob.ub, x)
    for k in range(max_adds):
        delta = target - matvec(prob, prob.K, x)
        need = (delta > 1e-6).any(-1)
        if k % SYNC_EVERY == 0 and not bool(need.any()):
            break
        score = rmatvec(prob, prob.K, torch.clamp(delta, min=0.0)) / c_safe
        # never pick masked-out or at-upper-bound types
        score = torch.where(allowed & (x < ub), score,
                            torch.full_like(score, float("-inf")))
        i = score.argmax(-1, keepdim=True)
        x = x.scatter_add(-1, i, need.unsqueeze(-1).to(x.dtype))
    return x


def scale_down(prob: AllocationProblem, x: torch.Tensor,
               max_removes: int = 4096) -> torch.Tensor:
    """Drop units whose removal keeps Kx >= d - mu, most-expensive first —
    the polish mirroring the Cluster Autoscaler's scale-down."""
    target = lane(prob, prob.d - prob.mu, x)
    K = lane(prob, prob.K, x[..., None])                 # (.., m, n)
    c = lane(prob, prob.c, x)
    lb = lane(prob, prob.lb, x)
    for k in range(max_removes):
        Kx = matvec(prob, prob.K, x)
        slack_ok = ((Kx[..., :, None] - K)
                    >= target[..., :, None] - 1e-6).all(-2)
        can = slack_ok & (x >= 1.0) & (x - 1.0 >= lb)
        removable = torch.where(can, c, torch.full_like(c, float("-inf")))
        need = (torch.isfinite(removable) & (removable > 0)).any(-1)
        if k % SYNC_EVERY == 0 and not bool(need.any()):
            break
        i = removable.argmax(-1, keepdim=True)
        x = x.scatter_add(-1, i, -need.unsqueeze(-1).to(x.dtype))
    return x


def round_and_polish(prob: AllocationProblem, x_star: torch.Tensor,
                     max_adds: int = 4096, use_kernel: bool = True
                     ) -> torch.Tensor:
    """The paper's greedy rounding plus the reference's two polish passes:
    also try the ceil() candidate, scale both down, and keep the feasible
    one with the lower objective. Both candidates round as extra lanes of
    one loop; their objectives come from one kernel launch on the card."""
    ceil_start = torch.ceil(_clip(prob, x_star)) * lane(prob, prob.mask, x_star)
    # tiny fractions should not force a whole node: drop < 0.05 before ceil
    ceil_start = torch.where(x_star - torch.floor(x_star) < 0.05,
                             torch.floor(x_star), ceil_start)
    axis = 1 if is_stacked(prob) else 0
    pair = torch.stack([x_star, ceil_start], axis)
    ab = scale_down(prob, greedy_round(prob, pair, max_adds=max_adds))
    f = obj.objective(prob, ab, use_kernel=use_kernel)
    feas = obj.is_feasible(prob, ab, 1e-3)
    a, b = ab.unbind(axis)
    fa, fb = f.unbind(axis)
    feas_a, feas_b = feas.unbind(axis)
    pick_a = torch.where(feas_a == feas_b, fa <= fb, feas_a)
    return torch.where(pick_a.unsqueeze(-1), a, b)
