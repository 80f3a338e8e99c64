"""Problem container for the paper's allocation model (§II.A).

Port of ``repro.core.problem``. Every leaf is a float32 tensor and all
leaves of one problem lie on one device. A problem is either single
(K (m, n), c (n,), scalar params) or STACKED: every leaf carries a leading
(B,) tenant axis (``repro_torch.fleet.batching.stack_problems``). The
helpers at the bottom evaluate ``K @ x`` and friends for both forms, with
x of shape (..., n) for a single problem and (B, ..., n) for a stack —
the batch dimension the reference gets from ``vmap``, written out.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

F32 = torch.float32


def _as_f32(v, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v, np.float32) if not torch.is_tensor(v)
                           else v, dtype=F32, device=device)


class PenaltyParams(NamedTuple):
    """The five scalar knobs of eq. (1); 0-d tensors, or (B,) when stacked."""

    alpha: torch.Tensor   # provider-consolidation weight
    beta1: torch.Tensor   # sharpness of the 1 - e^{-b1 z} indicator approx
    beta2: torch.Tensor   # volume-discount curvature
    beta3: torch.Tensor   # shortage-penalty weight
    gamma: torch.Tensor   # volume-discount weight

    @classmethod
    def create(cls, alpha=0.02, beta1=1.0, beta2=0.1, beta3=10.0, gamma=0.005,
               device: DeviceLike = None):
        # the reference's defaults (tuned with pareto.grid_search there)
        dev = resolve_device(device)
        return cls(*(_as_f32(v, dev) for v in (alpha, beta1, beta2, beta3,
                                               gamma)))


class AllocationProblem(NamedTuple):
    """Paper §II.A: min f(x) s.t. d - mu <= Kx <= d + g, x >= 0 (int relaxed).

    Shapes: K (m, n), E (p, n), c (n,), d/mu/g (m,), lb/ub/mask (n,), each
    with a leading (B,) axis when stacked. ``terms`` holds the attached
    scenario terms (``repro_torch.core.terms.PricedTerm``s: SLO pricing,
    priority eviction, spot risk), whose params lie on the problem's
    device; the default ``()`` sums eq. (1)'s base terms only."""

    K: torch.Tensor
    E: torch.Tensor
    c: torch.Tensor
    d: torch.Tensor
    mu: torch.Tensor
    g: torch.Tensor
    params: PenaltyParams
    lb: torch.Tensor
    ub: torch.Tensor
    mask: torch.Tensor  # 1.0 = allowed, 0.0 = forbidden
    terms: tuple = ()

    @property
    def n(self) -> int:
        return self.c.shape[-1]

    @property
    def m(self) -> int:
        return self.d.shape[-1]

    @property
    def p(self) -> int:
        return self.E.shape[-2]

    @property
    def device(self) -> torch.device:
        return self.c.device

    @classmethod
    def create(cls, K, E, c, d, mu=None, g=None,
               params: Optional[PenaltyParams] = None, lb=None, ub=None,
               mask=None, ub_default: float = 1e4, terms: tuple = (),
               device: DeviceLike = None) -> "AllocationProblem":
        dev = resolve_device(device)
        K, E, c, d = (_as_f32(a, dev) for a in (K, E, c, d))
        m, n = K.shape
        mu = torch.zeros(m, dtype=F32, device=dev) if mu is None else _as_f32(mu, dev)
        # the reference's generous default waste cap (20x demand)
        g = 19.0 * d if g is None else _as_f32(g, dev)
        params = (PenaltyParams.create(device=dev) if params is None
                  else PenaltyParams(*(p.to(dev) for p in params)))
        lb = torch.zeros(n, dtype=F32, device=dev) if lb is None else _as_f32(lb, dev)
        ub = (torch.full((n,), ub_default, dtype=F32, device=dev) if ub is None
              else _as_f32(ub, dev))
        mask = torch.ones(n, dtype=F32, device=dev) if mask is None else _as_f32(mask, dev)
        prob = cls(K, E, c, d, mu, g, params, lb, ub, mask)
        if terms:
            from .terms import with_terms   # terms imports this module
            prob = with_terms(prob, terms)
        return prob

    def restrict(self, allowed_idx) -> "AllocationProblem":
        """Only ``allowed_idx`` instance types may be used (others get
        mask 0 and ub 0)."""
        mask = torch.zeros(self.n, dtype=F32, device=self.device)
        mask[torch.as_tensor(np.asarray(allowed_idx), device=self.device)] = 1.0
        return self._replace(mask=mask, ub=self.ub * mask)

    def with_existing(self, x_existing) -> "AllocationProblem":
        """Lower-bound the allocation by an existing deployment."""
        x_existing = _as_f32(x_existing, self.device)
        return self._replace(lb=torch.maximum(self.lb, x_existing))


def problem_to(prob: AllocationProblem, device) -> AllocationProblem:
    """The same problem with every leaf on ``device``."""
    if prob.device == torch.device(device):
        return prob
    mv = lambda a: a.to(device)
    return prob._replace(
        K=mv(prob.K), E=mv(prob.E), c=mv(prob.c), d=mv(prob.d),
        mu=mv(prob.mu), g=mv(prob.g),
        params=PenaltyParams(*(mv(p) for p in prob.params)),
        lb=mv(prob.lb), ub=mv(prob.ub), mask=mv(prob.mask),
        terms=tuple(t.to(device) for t in prob.terms))


def unsqueeze_problem(prob: AllocationProblem) -> AllocationProblem:
    """A single problem as a stack of one (B = 1)."""
    u = lambda a: a.unsqueeze(0)
    return prob._replace(
        K=u(prob.K), E=u(prob.E), c=u(prob.c), d=u(prob.d), mu=u(prob.mu),
        g=u(prob.g), params=PenaltyParams(*(u(p) for p in prob.params)),
        lb=u(prob.lb), ub=u(prob.ub), mask=u(prob.mask),
        terms=tuple(t.map(u) for t in prob.terms))


# ---------------------------------------------------------------------------
# single-or-stacked linear algebra (x is (..., n), or (B, ..., n) stacked)
# ---------------------------------------------------------------------------


def is_stacked(prob: AllocationProblem) -> bool:
    return prob.K.dim() == 3


def lane(prob: AllocationProblem, a: torch.Tensor, x: torch.Tensor
         ) -> torch.Tensor:
    """Broadcast a problem leaf (k,) / (B, k), or a param () / (B,), against
    x (..., k) / (B, ..., k) or a per-point value (...) / (B, ...)."""
    if not is_stacked(prob) or x.dim() <= a.dim():
        return a
    return a.reshape(a.shape[0], *([1] * (x.dim() - a.dim())), *a.shape[1:])


def matvec(prob: AllocationProblem, A: torch.Tensor, x: torch.Tensor
           ) -> torch.Tensor:
    """A @ x for A = prob.K or prob.E: (..., rows)."""
    if is_stacked(prob):
        return torch.einsum("brn,b...n->b...r", A, x)
    return x @ A.T


def rmatvec(prob: AllocationProblem, A: torch.Tensor, v: torch.Tensor
            ) -> torch.Tensor:
    """A^T @ v for A = prob.K or prob.E and v (..., rows): (..., n)."""
    if is_stacked(prob):
        return torch.einsum("brn,b...r->b...n", A, v)
    return v @ A
