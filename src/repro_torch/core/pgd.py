"""Shared projected-gradient engine: Barzilai-Borwein step + Armijo ladder —
port of ``repro.core.pgd``: the monolithic engine (``pgd_minimize``), its
traced twin (``pgd_minimize_traced``, ``PGDTrace``) and the chunked
*anytime* engine (``pgd_chunk_init`` / ``pgd_chunk_run`` driven by
``run_anytime`` against a wall clock). All three run the one op sequence
of ``_pgd_iteration``, so a traced or chunked trajectory is bit for bit the
monolithic one.

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

import time
from typing import Callable, NamedTuple, Optional, Tuple

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
    Returns ``(x, f, g, bb, flat, done, any_ok, idx, move)`` for every
    lane — the first six are the loop state, the last three feed the
    optional trace row; the caller keeps the old state on lanes that were
    already done."""
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
    return x_new, f_new, g_new, bb_new, flat_new, done, any_ok, idx, move


class PGDTrace(NamedTuple):
    """Per-iteration convergence rows of :func:`pgd_minimize_traced`, one row
    per lane: fixed-size (B, max_iters) tensors (see
    ``repro.core.pgd.PGDTrace``). Rows at indices >= a lane's ``iters`` were
    never written: ``merit`` / ``step`` / ``move`` hold NaN, ``accepted``
    False and ``rung`` -1 there."""

    merit: torch.Tensor     # (B, L) float32 merit after each iteration
    step: torch.Tensor      # (B, L) float32 proposed BB base step
    accepted: torch.Tensor  # (B, L) bool   Armijo ladder found a candidate
    rung: torch.Tensor      # (B, L) int32  accepted ladder index (-1: none)
    move: torch.Tensor      # (B, L) float32 max|dx| of the accepted step


def _empty_trace(B: int, L: int, device) -> PGDTrace:
    nan = lambda: torch.full((B, L), float("nan"), dtype=torch.float32,
                             device=device)
    return PGDTrace(merit=nan(), step=nan(),
                    accepted=torch.zeros((B, L), dtype=torch.bool,
                                         device=device),
                    rung=torch.full((B, L), -1, dtype=torch.int32,
                                    device=device),
                    move=nan())


def _write_row(tr: PGDTrace, live, it, f_new, bb, any_ok, idx, move
               ) -> PGDTrace:
    """Row ``it`` of every live lane: written on the device, no host read."""
    at = live[:, None] & (torch.arange(tr.merit.shape[1], device=it.device)
                          == it[:, None])
    put = lambda old, v: torch.where(at, v.to(old.dtype)[:, None], old)
    return PGDTrace(
        merit=put(tr.merit, f_new), step=put(tr.step, bb),
        accepted=put(tr.accepted, any_ok),
        rung=put(tr.rung, torch.where(any_ok, idx, torch.full_like(idx, -1))),
        move=put(tr.move, torch.where(any_ok, move, torch.zeros_like(move))))


def _iterate(value_fn, grad_fn, project_fn, cfg, state, it_cap: int,
             trace: Optional[PGDTrace] = None, track_best: bool = False):
    """The one BB/Armijo loop behind the three engines: advance every lane
    of ``state`` (a :class:`PGDChunkState`) until its ``it`` reaches
    ``it_cap`` or it converges, lane by lane under the ``~done & (it <
    it_cap)`` mask. Lanes still running share one iteration count, read
    once here; the done mask is read every ``SYNC_EVERY`` iterations.
    ``trace`` gets a row per live lane and iteration, written on the
    device; ``track_best`` keeps ``(x_best, f_best)`` at the accepted
    iterate of strictly lowest merit. Neither changes the iterates.
    Returns ``(state, trace)``."""
    x, fx, g, bb, it, flat, done, x_best, f_best = state
    B = x.shape[0]
    tail = (1,) * (x.dim() - 1)
    ratios = ladder_ratios(cfg, x.device)
    for k in range(max(0, it_cap - int(it.max()))):
        if k % SYNC_EVERY == 0 and k > 0 and bool(done.all()):
            break
        (x_n, f_n, g_n, bb_n, flat_n, done_n,
         any_ok, idx, move) = _pgd_iteration(
            value_fn, grad_fn, project_fn, cfg, ratios, x, fx, g, bb, flat)
        live = ~done & (it < it_cap)
        if trace is not None:
            trace = _write_row(trace, live, it, f_n, bb, any_ok, idx, move)
        if track_best:
            better = live & (f_n < f_best)
            x_best = torch.where(better.reshape(B, *tail), x_n, x_best)
            f_best = torch.where(better, f_n, f_best)
        lx = live.reshape(B, *tail)
        x = torch.where(lx, x_n, x)
        fx = torch.where(live, f_n, fx)
        g = torch.where(lx, g_n, g)
        bb = torch.where(live, bb_n, bb)
        flat = torch.where(live, flat_n, flat)
        it = it + live
        done = done | (live & done_n)
    return (PGDChunkState(x, fx, g, bb, it, flat, done, x_best, f_best),
            trace)


def _pgd_minimize_impl(value_fn, grad_fn, project_fn, x0, cfg, trace: bool):
    """The monolithic engine: one :func:`_iterate` run from the projected
    start to ``max_iters``, with or without trace rows."""
    state = pgd_chunk_init(value_fn, grad_fn, project_fn, x0, cfg)
    tr = (_empty_trace(x0.shape[0], cfg.max_iters, x0.device) if trace
          else None)
    state, tr = _iterate(value_fn, grad_fn, project_fn, cfg, state,
                         cfg.max_iters, trace=tr)
    return state.x, state.fx, state.it, tr


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
    actually took. :func:`pgd_minimize_traced` also captures the
    per-iteration convergence rows."""
    x, fx, it, _ = _pgd_minimize_impl(value_fn, grad_fn, project_fn, x0, cfg,
                                      trace=False)
    return x, fx, it


def pgd_minimize_traced(
    value_fn: Callable[[torch.Tensor], torch.Tensor],
    grad_fn: Callable[[torch.Tensor], torch.Tensor],
    project_fn: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    cfg: PGDConfig = PGDConfig(),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, PGDTrace]:
    """:func:`pgd_minimize` with per-iteration convergence capture: returns
    ``(x, value, iters, trace)``, ``trace`` a :class:`PGDTrace` of
    (B, max_iters) rows written on the device. ``(x, value, iters)`` equal
    the untraced engine's bit for bit, and ``trace.merit[b, iters[b]-1]``
    is lane b's value whenever it took an iteration."""
    return _pgd_minimize_impl(value_fn, grad_fn, project_fn, x0, cfg,
                              trace=True)


class AnytimeConfig(NamedTuple):
    """Host-side knobs of the chunked-budget *anytime* mode (see
    ``repro.core.pgd.AnytimeConfig``): the engine runs in ``chunk_iters``-
    iteration chunks and the host loop reads ``clock`` (monotonic seconds,
    injectable) between chunks; once ``deadline_ms`` have elapsed the
    caller deploys the best-so-far iterate by merit. ``deadline_ms=None``
    disables the mode: every consumer then takes its untruncated path."""

    deadline_ms: Optional[float] = None   # wall budget; None = disabled
    chunk_iters: int = 32                 # iterations per clock check
    clock: Callable[[], float] = time.perf_counter   # injectable, host-only

    @property
    def enabled(self) -> bool:
        """Whether this config enforces a budget (``deadline_ms`` set)."""
        return self.deadline_ms is not None


class AnytimeReport(NamedTuple):
    """Host-side outcome of one :func:`run_anytime` drive: ``deadline_hit``
    iff the clock expired while iterations remained; ``chunks`` counts
    chunk launches (0 when the budget was spent before the first)."""

    deadline_hit: bool
    elapsed_ms: float
    chunks: int


class PGDChunkState(NamedTuple):
    """Resumable state of the chunked anytime engine, one entry per lane:
    the monolithic loop's state plus the best-so-far pair ``(x_best,
    f_best)``. ``x_best`` is always a projected (feasible) point: it starts
    at the projected warm start and moves only to an accepted iterate of
    strictly lower merit."""

    x: torch.Tensor        # (B, ...) current iterate
    fx: torch.Tensor       # (B,) merit at x
    g: torch.Tensor        # (B, ...) gradient at x
    bb: torch.Tensor       # (B,) BB step
    it: torch.Tensor       # (B,) iterations taken
    flat: torch.Tensor     # (B,) consecutive flat-step counter
    done: torch.Tensor     # (B,) converged / stalled flag
    x_best: torch.Tensor   # (B, ...) best-merit iterate so far (feasible)
    f_best: torch.Tensor   # (B,) merit at x_best


def pgd_chunk_init(value_fn, grad_fn, project_fn, x0: torch.Tensor,
                   cfg: PGDConfig) -> PGDChunkState:
    """The iteration-0 :class:`PGDChunkState`: ``x0`` projected first,
    exactly as the monolithic loop does, so a zero-budget answer is
    already feasible."""
    B = x0.shape[0]
    dev = x0.device
    x = project_fn(x0)
    fx = value_fn(x)
    zeros = lambda dt: torch.zeros(B, dtype=dt, device=dev)
    return PGDChunkState(
        x=x, fx=fx, g=grad_fn(x),
        bb=torch.full((B,), cfg.step0, dtype=torch.float32, device=dev),
        it=zeros(torch.int64), flat=zeros(torch.int64), done=zeros(torch.bool),
        x_best=x, f_best=fx)


def pgd_chunk_run(value_fn, grad_fn, project_fn, state: PGDChunkState,
                  it_end: int, cfg: PGDConfig) -> PGDChunkState:
    """Advance every lane until its ``it`` reaches ``min(it_end,
    max_iters)`` or it converges, tracking the best-so-far iterate. Each
    iteration is the monolithic loop's (:func:`_iterate`), so chunks back
    to back walk the monolithic trajectory iterate for iterate."""
    return _iterate(value_fn, grad_fn, project_fn, cfg, state,
                    min(int(it_end), cfg.max_iters), track_best=True)[0]


def run_anytime(init_fn, chunk_fn, cfg: PGDConfig, anytime: AnytimeConfig):
    """Drive a chunked solve against the wall clock — the host loop behind
    every anytime consumer (see ``repro.core.pgd.run_anytime``).

    ``init_fn()`` returns the initial state (with ``done`` / ``it`` /
    ``x_best`` / ``f_best``); ``chunk_fn(state, it_end)`` advances it to the
    iteration cap. Before each clock check the loop reads ``state.done``
    on the host, which waits for the previous chunk's device work, so the
    clock measures work done, not launches queued. It stops when every
    lane converged, ``cfg.max_iters`` is reached or ``deadline_ms`` has
    passed, and calls ``anytime.clock`` exactly where the reference does:
    once at the start, once before each chunk, once at the end. Returns
    ``(state, AnytimeReport)``."""
    if anytime.deadline_ms is None:
        raise ValueError("run_anytime requires AnytimeConfig.deadline_ms; "
                         "branch to the untruncated engine when it is None")
    clock = anytime.clock
    chunk = max(1, int(anytime.chunk_iters))
    deadline = float(anytime.deadline_ms)
    t0 = clock()
    state = init_fn()
    it_end = 0
    deadline_hit = False
    chunks = 0
    max_iters = int(cfg.max_iters)
    while it_end < max_iters and not bool(state.done.all()):
        if (clock() - t0) * 1e3 >= deadline:
            deadline_hit = True
            break
        it_end = min(it_end + chunk, max_iters)
        state = chunk_fn(state, it_end)
        chunks += 1
    elapsed_ms = (clock() - t0) * 1e3
    return state, AnytimeReport(deadline_hit=deadline_hit,
                                elapsed_ms=elapsed_ms, chunks=chunks)
