"""The priced-term objective registry — port of ``repro.core.terms``.

Every term of eq. (1) is one registered :class:`TermDef`: a
``(name, value_fn, grad_fn, param_axes)`` record whose value and gradient
share the precomputed ``K@x`` / ``E@x`` products. The four paper terms are
ported; the scenario terms (``slo_penalty``, ``priority_eviction``,
``spot_risk``) are not yet, so a problem that carries attached terms
raises ``NotImplementedError``.

Term functions take x of shape (..., n) for a single problem and
(B, ..., n) for a stacked one, and return per-point values (...) /
(B, ...) or gradients shaped like x. This module is the plain PyTorch
math; ``repro_torch.core.objective`` sends CUDA tensors to the kernel.
"""
from __future__ import annotations

import operator
from functools import reduce
from typing import Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from .problem import AllocationProblem, lane, rmatvec

TermFn = Callable[..., torch.Tensor]

NOT_PORTED = "scenario terms are not ported yet"


class TermDef(NamedTuple):
    """One registered objective term (see ``repro.core.terms.TermDef``)."""

    name: str
    value: TermFn
    grad: TermFn
    param_axes: Mapping[str, str]


def _base_cost_value(prob, params, x, Kx, Ex):
    return (x * lane(prob, prob.c, x)).sum(-1)


def _base_cost_grad(prob, params, x, Kx, Ex):
    return lane(prob, prob.c, x).expand_as(x)


def _consolidation_value(prob, params, x, Kx, Ex):
    P = prob.params
    return lane(prob, P.alpha, Kx[..., 0]) * (
        1.0 - torch.exp(-lane(prob, P.beta1, Ex) * Ex)).sum(-1)


def _consolidation_grad(prob, params, x, Kx, Ex):
    P = prob.params
    w = torch.exp(-lane(prob, P.beta1, Ex) * Ex)
    return lane(prob, P.alpha * P.beta1, x) * rmatvec(prob, prob.E, w)


def _volume_discount_value(prob, params, x, Kx, Ex):
    P = prob.params
    return -lane(prob, P.gamma, Kx[..., 0]) * torch.log1p(
        lane(prob, P.beta2, Ex) * Ex).sum(-1)


def _volume_discount_grad(prob, params, x, Kx, Ex):
    P = prob.params
    w = 1.0 / (1.0 + lane(prob, P.beta2, Ex) * Ex)
    return -lane(prob, P.gamma * P.beta2, x) * rmatvec(prob, prob.E, w)


def _shortage(prob, Kx):
    return torch.clamp(lane(prob, prob.d, Kx) - Kx, min=0.0)


def _shortage_value(prob, params, x, Kx, Ex):
    return lane(prob, prob.params.beta3, Kx[..., 0]) * (
        _shortage(prob, Kx) ** 2).sum(-1)


def _shortage_grad(prob, params, x, Kx, Ex):
    return -2.0 * lane(prob, prob.params.beta3, x) * rmatvec(
        prob, prob.K, _shortage(prob, Kx))


# Order is the reference's: base terms sum in this order.
BASE_TERMS: Tuple[str, ...] = (
    "base_cost", "consolidation", "volume_discount", "shortage")

TERM_DEFS: Dict[str, TermDef] = {}


def register_term(name: str, value: TermFn, grad: TermFn,
                  param_axes: Optional[Mapping[str, str]] = None) -> TermDef:
    """Register a term definition (axes "", "n" or "m", as the reference)."""
    axes = dict(param_axes or {})
    bad = {k: ax for k, ax in axes.items() if ax not in ("", "n", "m")}
    if bad:
        raise ValueError(f"invalid param axes for term {name!r}: {bad}")
    if name in TERM_DEFS:
        raise ValueError(f"term {name!r} already registered")
    td = TermDef(name, value, grad, axes)
    TERM_DEFS[name] = td
    return td


register_term("base_cost", _base_cost_value, _base_cost_grad)
register_term("consolidation", _consolidation_value, _consolidation_grad)
register_term("volume_discount", _volume_discount_value, _volume_discount_grad)
register_term("shortage", _shortage_value, _shortage_grad)


def require_no_terms(prob: AllocationProblem) -> None:
    """Raise on attached scenario terms (not ported yet)."""
    if prob.terms:
        raise NotImplementedError(NOT_PORTED)


def term_values(prob: AllocationProblem, x: torch.Tensor, Kx: torch.Tensor,
                Ex: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Every active term's value, base terms in the reference's order."""
    require_no_terms(prob)
    return {name: TERM_DEFS[name].value(prob, None, x, Kx, Ex)
            for name in BASE_TERMS}


def term_grads(prob: AllocationProblem, x: torch.Tensor, Kx: torch.Tensor,
               Ex: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Every active term's analytic gradient, same order as term_values."""
    require_no_terms(prob)
    return {name: TERM_DEFS[name].grad(prob, None, x, Kx, Ex)
            for name in BASE_TERMS}


def sum_terms(terms: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Left-associated sum in dict order, as the reference."""
    return reduce(operator.add, terms.values())


def active_value(prob: AllocationProblem, x: torch.Tensor) -> torch.Tensor:
    """Sum of the attached scenario terms only: zero until they are ported
    (a problem that carries any raises)."""
    require_no_terms(prob)
    return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)


def active_grad(prob: AllocationProblem, x: torch.Tensor) -> torch.Tensor:
    """Gradient counterpart of :func:`active_value`."""
    require_no_terms(prob)
    return torch.zeros_like(x)
