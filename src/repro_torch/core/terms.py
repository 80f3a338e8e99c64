"""The priced-term objective registry — port of ``repro.core.terms``.

Every term of the allocation objective — the four paper eq. (1) terms and
the three scenario terms (SLO pricing, priority eviction, spot risk) — is
one registered :class:`TermDef`: a ``(name, value_fn, grad_fn,
param_axes)`` record whose value and gradient share the precomputed
``K@x`` / ``E@x`` products. Scenario terms are attached to a problem as
:class:`PricedTerm` instances in ``AllocationProblem.terms``; a problem
without them sums the base terms only.

Term functions take x of shape (..., n) for a single problem and
(B, ..., n) for a stacked one, and return per-point values (...) /
(B, ...) or gradients shaped like x. A stacked problem's term params carry
the leading (B,) axis too. This module is the plain PyTorch math;
``repro_torch.core.objective`` sends the four base terms of a CUDA tensor
to the ``alloc_objective`` kernel and adds :func:`active_value` /
:func:`active_grad` for the attached ones, as the reference's fleet
solver does around its Pallas kernel.

Padding exactness, as in the reference: every attachable term is linear
in its params, so zero params give exactly 0.0 and a zero gradient, and
ragged fleet stacking zero-fills a tenant that lacks a kind. Param axes
say how a param pads and slices under stacking: ``""`` per-tenant scalar,
``"n"`` per instance type, ``"m"`` per resource.
"""
from __future__ import annotations

import operator
from functools import reduce
from typing import Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .problem import AllocationProblem, lane, matvec, rmatvec

TermFn = Callable[..., torch.Tensor]


class TermDef(NamedTuple):
    """One registered objective term (see ``repro.core.terms.TermDef``):
    ``param_axes`` maps each param name to its stacking axis; base terms
    have none and are always active."""

    name: str
    value: TermFn
    grad: TermFn
    param_axes: Mapping[str, str]


class PricedTerm:
    """A scenario term attached to a problem: a registry kind and its
    priced params, float32 tensors (scalars, (n,) or (m,) vectors; with a
    leading (B,) axis when stacked)."""

    __slots__ = ("kind", "params")

    def __init__(self, kind: str, params: Mapping[str, torch.Tensor]):
        self.kind = str(kind)
        self.params = dict(params)

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "PricedTerm":
        """The same kind with ``fn`` applied to every param."""
        return PricedTerm(self.kind,
                          {k: fn(v) for k, v in self.params.items()})

    def to(self, device) -> "PricedTerm":
        """The same term with every param on ``device``."""
        return self.map(lambda v: v.to(device))

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        inner = ", ".join(f"{k}={v!r}" for k, v in sorted(self.params.items()))
        return f"PricedTerm({self.kind!r}, {inner})"


# ---------------------------------------------------------------------------
# Base terms (paper eq. 1) — implicit, always active
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# Scenario terms — attachable, priced, zero at zero params
# ---------------------------------------------------------------------------


def _slo_penalty_value(prob, params, x, Kx, Ex):
    # price * sum max(d - Kx, 0): the linear SLO cost in $ per unit of
    # normalized shortage, on top of eq. (1)'s quadratic shortage term
    return lane(prob, params["price"], Kx[..., 0]) * _shortage(
        prob, Kx).sum(-1)


def _slo_penalty_grad(prob, params, x, Kx, Ex):
    # the subgradient that takes 0 at the hinge, as the reference
    live = (lane(prob, prob.d, Kx) - Kx > 0.0).to(x.dtype)
    return -lane(prob, params["price"], x) * rmatvec(prob, prob.K, live)


def _priority_eviction_value(prob, params, x, Kx, Ex):
    # price @ x: eviction exposure per node held
    return (x * lane(prob, params["price"], x)).sum(-1)


def _priority_eviction_grad(prob, params, x, Kx, Ex):
    return lane(prob, params["price"], x).expand_as(x)


def _spot_risk_value(prob, params, x, Kx, Ex):
    # risk @ x: the interruption surcharge on spot twins, kept out of c
    return (x * lane(prob, params["risk"], x)).sum(-1)


def _spot_risk_grad(prob, params, x, Kx, Ex):
    return lane(prob, params["risk"], x).expand_as(x)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

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

register_term("slo_penalty", _slo_penalty_value, _slo_penalty_grad,
              {"price": ""})
register_term("priority_eviction", _priority_eviction_value,
              _priority_eviction_grad, {"price": "n"})
register_term("spot_risk", _spot_risk_value, _spot_risk_grad,
              {"risk": "n"})

#: Attachable (scenario) kinds, in registration order.
SCENARIO_TERMS: Tuple[str, ...] = tuple(
    k for k in TERM_DEFS if TERM_DEFS[k].param_axes)


def _f32(v) -> torch.Tensor:
    if torch.is_tensor(v):
        return v.detach().to(torch.float32)
    return torch.as_tensor(np.asarray(v, np.float32))


def make_term(kind: str, **params) -> PricedTerm:
    """A :class:`PricedTerm` of a registered attachable kind, its params as
    float32 tensors (on the host unless given as tensors elsewhere;
    :func:`with_terms` moves them to the problem's device). Rejects
    unknown kinds, base kinds, and unknown or missing params."""
    td = TERM_DEFS.get(kind)
    if td is None:
        raise ValueError(
            f"unknown term kind {kind!r}; known: {sorted(TERM_DEFS)}")
    if not td.param_axes:
        raise ValueError(
            f"term {kind!r} is implicit (always active via prob.params) "
            "and cannot be attached")
    expected, got = set(td.param_axes), set(params)
    if got != expected:
        raise ValueError(
            f"term {kind!r} expects params {sorted(expected)}, got "
            f"{sorted(got)}")
    return PricedTerm(kind, {k: _f32(v) for k, v in params.items()})


def normalize_terms(terms) -> Tuple[PricedTerm, ...]:
    """PricedTerms and/or ``(kind, params)`` pairs -> a validated tuple
    with unique kinds."""
    out = []
    for t in terms or ():
        if isinstance(t, PricedTerm):
            t = make_term(t.kind, **t.params)
        else:
            kind, params = t
            t = make_term(kind, **dict(params))
        out.append(t)
    kinds = [t.kind for t in out]
    if len(set(kinds)) != len(kinds):
        raise ValueError(f"duplicate term kinds: {kinds}")
    return tuple(out)


def _axis_size(prob: AllocationProblem, axis: str) -> Tuple[int, ...]:
    return {"": (), "n": (prob.n,), "m": (prob.m,)}[axis]


def with_terms(prob: AllocationProblem, terms) -> AllocationProblem:
    """Attach a validated terms tuple to the single problem ``prob``
    (shape-checked against its n / m), params on the problem's device."""
    tup = normalize_terms(terms)
    for t in tup:
        for k, ax in TERM_DEFS[t.kind].param_axes.items():
            want = _axis_size(prob, ax)
            got = tuple(t.params[k].shape)
            if got != want:
                raise ValueError(
                    f"term {t.kind!r} param {k!r}: expected shape {want} "
                    f"(axis {ax!r}), got {got}")
    return prob._replace(terms=tuple(t.to(prob.device) for t in tup))


def term_signature(prob: AllocationProblem) -> Tuple[str, ...]:
    """The kind tuple of a problem's attached terms."""
    return tuple(t.kind for t in prob.terms)


# ---------------------------------------------------------------------------
# Registry sums — the one place term math is combined
# ---------------------------------------------------------------------------


def term_values(prob: AllocationProblem, x: torch.Tensor, Kx: torch.Tensor,
                Ex: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Every active term's value: base terms in the reference's order,
    then the attached terms in attachment order."""
    out = {name: TERM_DEFS[name].value(prob, None, x, Kx, Ex)
           for name in BASE_TERMS}
    for t in prob.terms:
        out[t.kind] = TERM_DEFS[t.kind].value(prob, t.params, x, Kx, Ex)
    return out


def term_grads(prob: AllocationProblem, x: torch.Tensor, Kx: torch.Tensor,
               Ex: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Every active term's analytic gradient, same order as term_values."""
    out = {name: TERM_DEFS[name].grad(prob, None, x, Kx, Ex)
           for name in BASE_TERMS}
    for t in prob.terms:
        out[t.kind] = TERM_DEFS[t.kind].grad(prob, t.params, x, Kx, Ex)
    return out


def sum_terms(terms: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Left-associated sum in dict order, as the reference."""
    return reduce(operator.add, terms.values())


def _active_products(prob: AllocationProblem, x: torch.Tensor):
    """(K@x, E@x) for the attached terms, one per point of x. The built-in
    scenario kinds read x and K@x only, so E@x is formed only for a kind
    registered later with ``register_term``, which may read it."""
    Kx = matvec(prob, prob.K, x)
    if all(t.kind in SCENARIO_TERMS for t in prob.terms):
        return Kx, None
    return Kx, matvec(prob, prob.E, x)


def active_value(prob: AllocationProblem, x: torch.Tensor) -> torch.Tensor:
    """Sum of the ATTACHED scenario terms only (no base terms): what the
    kernel route adds to the kernel's eq. (1), each point of x (every
    ladder candidate too) from its own K@x."""
    if not prob.terms:
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    Kx, Ex = _active_products(prob, x)
    return reduce(operator.add,
                  (TERM_DEFS[t.kind].value(prob, t.params, x, Kx, Ex)
                   for t in prob.terms))


def active_grad(prob: AllocationProblem, x: torch.Tensor) -> torch.Tensor:
    """Gradient counterpart of :func:`active_value`, shaped like x."""
    if not prob.terms:
        return torch.zeros_like(x)
    Kx, Ex = _active_products(prob, x)
    return reduce(operator.add,
                  (TERM_DEFS[t.kind].grad(prob, t.params, x, Kx, Ex)
                   for t in prob.terms))
