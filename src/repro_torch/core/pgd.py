"""Shared projected-gradient engine: Barzilai-Borwein step + Armijo ladder —
port of ``repro.core.pgd`` (``PGDConfig``, ``pgd_minimize``).

The reference runs one ``lax.while_loop`` per problem and ``vmap``s it over
lanes; the batching rule freezes finished lanes in place. Here the lane
axis is written out: the iterate is (B, ...), one lane per leading index,
and a Python loop runs every lane at once under a per-lane ``done`` mask —
a lane that is done (or out of budget) keeps its state exactly, so each
lane follows the trajectory it would follow alone.

The host reads the mask only every ``SYNC_EVERY`` iterations (one device
sync each): the loop may run up to ``SYNC_EVERY - 1`` iterations past the
moment every lane finished, all of them frozen no-ops, so results and
iteration counts do not depend on it.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

SYNC_EVERY = 16   # iterations between host reads of the done mask


class PGDConfig(NamedTuple):
    """Knobs of the shared BB/Armijo engine (see ``repro.core.pgd``)."""

    max_iters: int = 600           # iteration budget (early-stops on tol)
    step0: float = 1.0             # initial / fallback BB step
    n_backtracks: int = 12         # Armijo ladder length
    backtrack: float = 0.5         # ladder ratio
    armijo_c: float = 1e-4         # sufficient-decrease constant
    tol: float = 1e-6              # stop when the accepted move is tiny
    ftol: float = 1e-4             # relative progress of a "flat" step ...
    max_flat: int = 10             # ... and the flat streak that stops


def ladder_ratios(cfg, device) -> torch.Tensor:
    """backtrack ** (-1 .. n_backtracks-2) in float32: one upscale."""
    return (torch.tensor(cfg.backtrack, dtype=torch.float32, device=device)
            ** torch.arange(-1, cfg.n_backtracks - 1, dtype=torch.float32,
                            device=device))


def _flat_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """<a, b> per lane over every non-lane axis."""
    return (a * b).flatten(1).sum(-1)


def _pgd_iteration(value_fn, grad_fn, project_fn, cfg, ratios,
                   x, fx, g, bb, flat):
    """One BB/Armijo iteration for every lane — the reference's op sequence
    (``repro.core.pgd._pgd_iteration``) with the lane axis written out.
    Returns ``(x, f, g, bb, flat, done)`` for every lane; the caller keeps
    the old state on lanes that were already done."""
    B = x.shape[0]
    tail = (1,) * (x.dim() - 1)
    steps = bb[:, None] * ratios                               # (B, L)
    cands = project_fn(x[:, None] - steps.reshape(B, -1, *tail) * g[:, None])
    fcands = value_fn(cands)                                   # (B, L)
    # Armijo on the projected step: F(x+) <= F(x) + c * <g, x+ - x>
    diff = cands - x[:, None]
    dec = fcands - (fx[:, None] + cfg.armijo_c
                    * (diff * g[:, None]).flatten(2).sum(-1))
    ok = (dec <= 0.0) & torch.isfinite(fcands)
    idx = ok.to(torch.float32).argmax(1)     # first (largest) accepting step
    any_ok = ok.any(1)
    lanes = torch.arange(B, device=x.device)
    x_new = torch.where(any_ok.reshape(B, *tail), cands[lanes, idx], x)
    f_new = torch.where(any_ok, fcands[lanes, idx], fx)
    g_new = grad_fn(x_new)
    # BB1 step from the accepted move (safeguarded into [1e-8, 1e4])
    dx = x_new - x
    dg = g_new - g
    denom = _flat_dot(dx, dg)
    bb_new = torch.where(denom.abs() > 1e-12,
                         (_flat_dot(dx, dx) / denom).abs(),
                         torch.full_like(denom, cfg.step0))
    bb_new = bb_new.clamp(1e-8, 1e4)
    bb_new = torch.where(any_ok, bb_new, bb * cfg.backtrack ** cfg.n_backtracks)
    move = dx.abs().flatten(1).amax(-1)
    # converged when an ACCEPTED step barely moves, or after max_flat
    # consecutive accepted steps that barely improved the merit
    is_flat = any_ok & (f_new >= fx - cfg.ftol * (1.0 + fx.abs()))
    flat_new = torch.where(is_flat, flat + 1,
                           torch.where(any_ok, torch.zeros_like(flat), flat))
    done = (((~any_ok) & (bb < 1e-7)) | (any_ok & (move < cfg.tol))
            | (flat_new >= cfg.max_flat))
    return x_new, f_new, g_new, bb_new, flat_new, done


def pgd_minimize(
    value_fn: Callable[[torch.Tensor], torch.Tensor],
    grad_fn: Callable[[torch.Tensor], torch.Tensor],
    project_fn: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    cfg: PGDConfig = PGDConfig(),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Minimize every lane of ``x0`` (B, ...) over the set ``project_fn``
    projects onto.

    ``value_fn`` maps points (B, ..., *iterate) to values (B, ...) — it is
    called on the lanes' current iterates and on the (B, L) ladder of
    candidates; ``grad_fn`` and ``project_fn`` keep the shape. Returns
    ``(x, value, iters)`` per lane, ``iters`` being the iterations each lane
    actually took."""
    B = x0.shape[0]
    tail = (1,) * (x0.dim() - 1)
    ratios = ladder_ratios(cfg, x0.device)
    x = project_fn(x0)
    fx = value_fn(x)
    g = grad_fn(x)
    bb = torch.full((B,), cfg.step0, dtype=torch.float32, device=x0.device)
    it = torch.zeros(B, dtype=torch.int64, device=x0.device)
    flat = torch.zeros(B, dtype=torch.int64, device=x0.device)
    done = torch.zeros(B, dtype=torch.bool, device=x0.device)
    for k in range(cfg.max_iters):
        if k % SYNC_EVERY == 0 and k > 0 and bool(done.all()):
            break
        x_n, f_n, g_n, bb_n, flat_n, done_n = _pgd_iteration(
            value_fn, grad_fn, project_fn, cfg, ratios, x, fx, g, bb, flat)
        live = ~done
        lx = live.reshape(B, *tail)
        x = torch.where(lx, x_n, x)
        fx = torch.where(live, f_n, fx)
        g = torch.where(lx, g_n, g)
        bb = torch.where(live, bb_n, bb)
        flat = torch.where(live, flat_n, flat)
        it = it + live
        done = done | (live & done_n)
    return x, fx, it
