"""Time-expanded convex program over a lookahead window of H ticks — port
of ``repro.horizon.problem``.

The MPC controller stacks the next H ticks' problems (the observed demand
and H-1 forecast ticks, each built by the same ``make_problem``) into one
program over the plan ``X (H, n)``:

    min_X  Σ_h f_h(X_h)  +  w · Σ_{h=1..H-1} Σ_i s_eps((X_h - X_{h-1})_i)
                         +  w · Σ_i s_eps((X_0 - x_current)_i)
    s.t.   X_h ∈ box_h ∩ mask_h                          (every tick)
           ||X_0 - x_current||_1 <= delta_max            (committed tick)

with f_h tick h's eq. (1) and s_eps(u) = sqrt(u² + eps) - sqrt(eps) the
smoothed |u| (s_eps(0) = 0, so an unchanged plan and every padded column
add nothing). See ``repro.horizon.problem`` and docs/horizon.md for the
formulation; the solver (``repro_torch.horizon.solver``) assembles the
committed-transition and churn-bound terms.

Representation: ``HorizonProblem.problem`` is a stacked
``AllocationProblem`` whose leading axis indexes the window's ticks
(``repro_torch.fleet.batching.stack_problems``). A fleet of B windows —
``solve_horizon_fleet_step``'s input — carries leaves with two leading
axes (B, H, ...), lane b's H ticks contiguous (lane-major), so the B·H
tick problems are one stacked problem of B·H rows without a copy
(:func:`flatten_lanes`).

The window route of eq. (1). Per-tick values and gradients of every lane
and tick go through ONE ``core.objective`` call on that B·H stack
(:func:`tick_values`, :func:`tick_grads`); on a CUDA tensor that is one
``alloc_objective`` fleet launch. The gradient's iterate X (B, H, n)
reshapes to (B·H, 1, n) without a copy. The Armijo ladder's candidates
arrive as (B, L, H, n) from ``core.pgd``; the kernel wants each tick's L
candidates together, (B·H, L, n), so they are permuted and copied once per
ladder (B·L·H·n floats, the size of the candidates themselves), and the
(B·H, L) values are summed back over H into (B, L).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from ..core import objective as obj
from ..core.problem import AllocationProblem, PenaltyParams
from ..device import DeviceLike
from ..fleet.batching import stack_problems

# defaults tuned on the horizon_bench diurnal/flash-crowd fleets (see the
# reference): the coupling sits on the scale of per-node hourly prices
DEFAULT_COUPLING_W = 0.3
DEFAULT_COUPLING_EPS = 1e-4


class HorizonProblem(NamedTuple):
    """The time-expanded program: H stacked per-tick problems + coupling.

    ``problem``'s leaves carry a leading (H,) axis (tick h is slice
    ``[h]``), or (B, H) for a fleet of windows; ``coupling_w`` and
    ``coupling_eps`` are 0-d float32 tensors on the problem's device."""

    problem: AllocationProblem
    coupling_w: torch.Tensor
    coupling_eps: torch.Tensor

    @property
    def H(self) -> int:
        """Number of lookahead ticks (leading axis of every problem leaf)."""
        return self.problem.d.shape[0]

    @property
    def n(self) -> int:
        """Variable count per tick (padded, when bucketed by the fleet)."""
        return self.problem.c.shape[-1]


def map_problem(prob: AllocationProblem,
                fn: Callable[[torch.Tensor], torch.Tensor]
                ) -> AllocationProblem:
    """``fn`` applied to every leaf of ``prob``: data, params and the
    attached terms' params."""
    return prob._replace(
        K=fn(prob.K), E=fn(prob.E), c=fn(prob.c), d=fn(prob.d),
        mu=fn(prob.mu), g=fn(prob.g),
        params=PenaltyParams(*(fn(p) for p in prob.params)),
        lb=fn(prob.lb), ub=fn(prob.ub), mask=fn(prob.mask),
        terms=tuple(t.map(fn) for t in prob.terms))


def flatten_lanes(prob: AllocationProblem) -> AllocationProblem:
    """A (B, H, ...) fleet of windows as one stacked problem of B·H tick
    problems, lane-major (a view where the leaves are contiguous)."""
    return map_problem(prob, lambda a: a.reshape(a.shape[0] * a.shape[1],
                                                 *a.shape[2:]))


def unflatten_lanes(prob: AllocationProblem, B: int) -> AllocationProblem:
    """Inverse of :func:`flatten_lanes`: B·H stacked rows as (B, H, ...)."""
    return map_problem(prob, lambda a: a.reshape(B, a.shape[0] // B,
                                                 *a.shape[1:]))


def _coupling_tensors(w, eps, device) -> Tuple[torch.Tensor, torch.Tensor]:
    f32 = dict(dtype=torch.float32, device=device)
    return torch.as_tensor(w, **f32), torch.as_tensor(eps, **f32)


def expand_problems(problems: Sequence[AllocationProblem],
                    coupling_w: float = DEFAULT_COUPLING_W,
                    coupling_eps: float = DEFAULT_COUPLING_EPS,
                    n_max: Optional[int] = None,
                    m_max: Optional[int] = None,
                    p_max: Optional[int] = None,
                    term_kinds: Optional[Tuple[str, ...]] = None,
                    device: DeviceLike = None) -> HorizonProblem:
    """Stack per-tick problems (tick 0 first) into a HorizonProblem on
    ``device`` (default: the first problem's). ``n_max`` / ``m_max`` /
    ``p_max`` pad the window to a shape bucket and ``term_kinds`` forces
    its term signature, with ``stack_problems``'s exact padding."""
    if len(problems) == 0:
        raise ValueError("empty horizon window")
    batch = stack_problems(list(problems), n_max=n_max, m_max=m_max,
                           p_max=p_max, term_kinds=term_kinds, device=device)
    w, eps = _coupling_tensors(coupling_w, coupling_eps,
                               batch.problem.device)
    return HorizonProblem(problem=batch.problem, coupling_w=w,
                          coupling_eps=eps)


def stack_windows(windows: Sequence[Sequence[AllocationProblem]],
                  coupling_w: float = DEFAULT_COUPLING_W,
                  coupling_eps: float = DEFAULT_COUPLING_EPS,
                  n_max: Optional[int] = None,
                  m_max: Optional[int] = None,
                  p_max: Optional[int] = None,
                  term_kinds: Optional[Tuple[str, ...]] = None,
                  device: DeviceLike = None) -> HorizonProblem:
    """B windows of H per-tick problems each as one fleet HorizonProblem
    with (B, H, ...) leaves: the B·H problems stacked lane-major in one
    ``stack_problems`` call (one host-to-device copy per leaf), padded to
    the given dims and the term signature (default: their union)."""
    H = len(windows[0])
    if any(len(w) != H for w in windows):
        raise ValueError("windows of different lengths")
    flat = [pb for w in windows for pb in w]
    batch = stack_problems(flat, n_max=n_max, m_max=m_max, p_max=p_max,
                           term_kinds=term_kinds, device=device)
    w, eps = _coupling_tensors(coupling_w, coupling_eps,
                               batch.problem.device)
    return HorizonProblem(problem=unflatten_lanes(batch.problem,
                                                  len(windows)),
                          coupling_w=w, coupling_eps=eps)


def tick_problem(hp: HorizonProblem, h: int) -> AllocationProblem:
    """Slice tick ``h``'s AllocationProblem back out of the stack."""
    return map_problem(hp.problem, lambda a: a[h])


def _lanes_like(a: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-lane (B, k) tensor broadcast against ``like`` (B, ..., k): the
    lane axis first, singleton axes for the rest. A tensor with no lane
    axis broadcasts as it is."""
    if a.dim() < 2 or like.dim() <= a.dim():
        return a
    return a.reshape(a.shape[0], *([1] * (like.dim() - a.dim())),
                     *a.shape[1:])


def _lane_scalars(a, like: torch.Tensor) -> torch.Tensor:
    """A scalar or per-lane (B,) value broadcast against ``like`` (B, ...)."""
    a = torch.as_tensor(a, dtype=like.dtype, device=like.device)
    if a.dim() == 0 or like.dim() <= 1:
        return a
    return a.reshape(a.shape[0], *([1] * (like.dim() - 1)))


def _smooth_abs(D: torch.Tensor, eps) -> torch.Tensor:
    return torch.sqrt(D * D + eps) - torch.sqrt(torch.as_tensor(eps))


def coupling_penalty(X: torch.Tensor, w, eps) -> torch.Tensor:
    """w · Σ_h Σ_i [sqrt((X_h - X_{h-1})_i² + eps) - sqrt(eps)] of a plan X
    (..., H, n): one value per plan. Zero at H = 1 and on a constant plan
    (s(0) = 0 exactly)."""
    D = X[..., 1:, :] - X[..., :-1, :]
    return w * _smooth_abs(D, eps).sum((-2, -1))


def coupling_grad(X: torch.Tensor, w, eps) -> torch.Tensor:
    """Analytic gradient of :func:`coupling_penalty` wrt the plan X: row h
    receives +s(D_h) and -s(D_{h+1}), s(u) = w·u/sqrt(u²+eps)."""
    D = X[..., 1:, :] - X[..., :-1, :]
    S = w * D / torch.sqrt(D * D + eps)
    Z = torch.zeros_like(X[..., :1, :])
    return torch.cat([Z, S], -2) - torch.cat([S, Z], -2)


def commit_coupling_penalty(X: torch.Tensor, x_current: torch.Tensor,
                            w, eps) -> torch.Tensor:
    """w · Σ_i s_eps((X_0 − x_current)_i): the committed transition's churn,
    priced like every other transition of the window. ``x_current`` is
    (n,), or (B, n) for plans (B, ..., H, n)."""
    X0 = X[..., 0, :]
    D = X0 - _lanes_like(x_current, X0)
    return w * _smooth_abs(D, eps).sum(-1)


def commit_coupling_grad(X: torch.Tensor, x_current: torch.Tensor,
                         w, eps) -> torch.Tensor:
    """Analytic gradient of :func:`commit_coupling_penalty` wrt the plan X
    (only row 0 is touched; ``x_current`` is a constant)."""
    X0 = X[..., 0, :]
    D = X0 - _lanes_like(x_current, X0)
    S = w * D / torch.sqrt(D * D + eps)
    return torch.cat([S.unsqueeze(-2), torch.zeros_like(X[..., 1:, :])], -2)


def smoothed_churn(X: torch.Tensor, eps) -> torch.Tensor:
    """Per-transition smoothed L1 churn of a plan: (..., H-1) of
    Σ_i s_eps((X_h - X_{h-1})_i)."""
    D = X[..., 1:, :] - X[..., :-1, :]
    return _smooth_abs(D, eps).sum(-1)


def _churn_excess(X: torch.Tensor, delta_max, eps) -> torch.Tensor:
    sc = smoothed_churn(X, eps)
    return torch.clamp(sc - _lane_scalars(delta_max, sc), min=0.0)


def churn_bound_penalty(X: torch.Tensor, delta_max, w, eps) -> torch.Tensor:
    """w · Σ_h max(smoothed_churn_h − delta_max, 0)²: the soft churn bound
    on planned transitions. ``delta_max`` is a scalar, or (B,) for plans
    (B, ..., H, n)."""
    excess = _churn_excess(X, delta_max, eps)
    return w * (excess * excess).sum(-1)


def churn_bound_grad(X: torch.Tensor, delta_max, w, eps) -> torch.Tensor:
    """Analytic gradient of :func:`churn_bound_penalty` wrt the plan X."""
    D = X[..., 1:, :] - X[..., :-1, :]
    S = D / torch.sqrt(D * D + eps)
    excess = _churn_excess(X, delta_max, eps)
    G = (2.0 * w * excess)[..., None] * S
    Z = torch.zeros_like(X[..., :1, :])
    return torch.cat([Z, G], -2) - torch.cat([G, Z], -2)


def tick_values(P: AllocationProblem, X: torch.Tensor,
                use_kernel: bool = True) -> torch.Tensor:
    """eq. (1) of every tick of every plan: ``P`` the B·H tick problems
    stacked lane-major (:func:`flatten_lanes`), X (B, ..., H, n); returns
    (B, ..., H). One ``core.objective`` call (one kernel launch on the
    card) with the ladder axis, if any, as the kernel's point axis."""
    B, H, n = X.shape[0], X.shape[-2], X.shape[-1]
    lead = X.shape[1:-2]
    if not lead:
        return obj.objective(P, X.reshape(B * H, n), use_kernel
                             ).reshape(B, H)
    # (B, ..., H, n) -> (B, H, ..., n) -> (B·H, ..., n): one copy
    Xf = X.movedim(-2, 1).reshape(B * H, *lead, n)
    f = obj.objective(P, Xf, use_kernel)
    return f.reshape(B, H, *lead).movedim(1, -1)


def tick_grads(P: AllocationProblem, X: torch.Tensor,
               use_kernel: bool = True) -> torch.Tensor:
    """Per-tick eq. (1) gradients of plans X (B, H, n), shaped like X: the
    B·H ticks as (B·H, 1, n), one kernel launch on the card."""
    B, H, n = X.shape
    return obj.grad_objective(P, X.reshape(B * H, n), use_kernel
                              ).reshape(B, H, n)


def horizon_objective(hp: HorizonProblem, X: torch.Tensor,
                      use_kernel: bool = True) -> torch.Tensor:
    """The relaxed time-expanded objective at a plan X (H, n): per-tick
    eq. (1) objectives summed, plus the smoothed churn coupling. With
    ``coupling_w == 0`` this is Σ_h objective(prob_h, X_h)."""
    per_tick = tick_values(hp.problem, X[None], use_kernel)[0]
    return per_tick.sum() + coupling_penalty(X, hp.coupling_w,
                                             hp.coupling_eps)


def horizon_objective_terms(hp: HorizonProblem, X: torch.Tensor,
                            use_kernel: bool = True) -> dict:
    """Diagnostic split: {"per_tick": (H,) objectives, "coupling": scalar}
    (the per-tick objectives include attached scenario terms)."""
    return {"per_tick": tick_values(hp.problem, X[None], use_kernel)[0],
            "coupling": coupling_penalty(X, hp.coupling_w, hp.coupling_eps)}


# ---------------------------------------------------------------------------
# Horizon-level term registry
# ---------------------------------------------------------------------------


class HorizonTermDef(NamedTuple):
    """One window-level (inter-tick) objective term: a name plus matched
    value/grad closures over the plan X (..., H, n) (see
    ``repro.horizon.problem.HorizonTermDef``)."""

    name: str
    value: object   # Callable[[X], (...)]
    grad: object    # Callable[[X], (..., H, n)]


def coupling_term_defs(hp: HorizonProblem, x_current: torch.Tensor,
                       delta_max, delta_penalty_w):
    """The window-level term list for an H>1 solve, in the reference's
    accumulation order (coupling, commit_coupling, churn_bound); consumers
    add them to their value / gradient in list order. ``x_current`` is
    (n,) or (B, n), ``delta_max`` a scalar or (B,), for plans (H, n) or
    (B, ..., H, n)."""
    w, eps = hp.coupling_w, hp.coupling_eps
    dpw = torch.as_tensor(delta_penalty_w, dtype=torch.float32,
                          device=w.device)
    return (
        HorizonTermDef("coupling",
                       lambda X: coupling_penalty(X, w, eps),
                       lambda X: coupling_grad(X, w, eps)),
        HorizonTermDef("commit_coupling",
                       lambda X: commit_coupling_penalty(X, x_current, w, eps),
                       lambda X: commit_coupling_grad(X, x_current, w, eps)),
        HorizonTermDef("churn_bound",
                       lambda X: churn_bound_penalty(X, delta_max, dpw, eps),
                       lambda X: churn_bound_grad(X, delta_max, dpw, eps)),
    )
