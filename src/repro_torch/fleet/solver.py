"""solve_fleet, solve_fleet_bucketed and solve_fleet_step — port of
``repro.fleet.solver``.

``solve_fleet`` mirrors the reference's hand-batched hot loop: phase-1 ->
barrier/penalty PGD with a Barzilai-Borwein step and an Armijo ladder ->
feasibility restoration -> rounding, carrying the full (B tenants,
S starts) state through every step. ``solve_fleet_step`` is the warm tick:
the incremental solve and rounding for every tenant at once.

Every eq. (1) evaluation goes through ``repro_torch.kernels.
alloc_objective``: the iterate's value and gradient (the reference's
Pallas call, ``fleet/solver.py:179`` there), the ladder's B*S*L candidate
values, the per-start relaxed objective, the objectives after rounding,
and the warm tick's values and gradients. In the reference the last four
are plain jnp; here, on the card, they are launches of the kernel (its
value-only form where no gradient is needed), so no plain eq. (1) runs
on a CUDA tensor in ``hot_loop="kernel"``. ``hot_loop="ref"`` runs the
plain PyTorch versions instead, on any device — the path a run is
compared with. On a CPU tensor both run the plain versions. The kernel
computes the four base terms only, as the Pallas kernel does; attached
scenario terms (``repro_torch.core.terms``) are added to every value and
gradient in plain PyTorch, each ladder candidate from its own K@x.

``solve_fleet_bucketed`` groups a ragged fleet into power-of-two shape
buckets (``batching.bucket_problems``), solves each bucket with
``solve_fleet`` and scatters the results back into fleet order, padded to
the fleet's true n_max.

``hot_loop="vmap"`` is the reference's "each lane runs the unmodified
single-problem solver": a Python loop over the tenants, each solved alone
at its true shape (cold: ``core.multistart``'s relax-and-round of its
starts; warm: ``solve_incremental_info`` and ``round_and_polish``) with
the kernel's single-problem form, then embedded in the padded result. It
commits exactly what the sequential controller commits — the equivalence
mode, not a fast one.

``solve_fleet_step`` also runs traced (``capture_trace=True``: per-lane
PGD convergence rows in ``FleetStepResult.trace``) or under an anytime
deadline (``anytime=AnytimeConfig(deadline_ms=...)``: the whole fleet's
lanes in one chunked solve against one clock, each lane deploying its
best-so-far feasible iterate when the budget expires, and
``FleetStepResult.deadline_hit`` reporting the truncation).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from ..core import objective as obj
from ..core.incremental import (incremental_anytime_chunk,
                                incremental_anytime_init,
                                solve_incremental_info)
from ..core.multistart import _solve_batch, make_starts
from ..core.pgd import (SYNC_EVERY, AnytimeConfig, PGDConfig, PGDTrace,
                        _empty_trace, ladder_ratios, run_anytime)
from ..core.problem import AllocationProblem, problem_to, unsqueeze_problem
from ..core.rounding import round_and_polish
from ..core.solver import SolverConfig, phase1_point
from ..device import DeviceLike, resolve_device
from .batching import (BucketedFleet, FleetBatch, bucket_problems,
                       stack_problems, tenant_problem)

HOT_LOOPS = ("kernel", "ref", "vmap")


class FleetSolveResult(NamedTuple):
    """Per-tenant outputs of a batched fleet solve (leading axis = tenant)."""

    x: torch.Tensor            # (B, n) best relaxed solution per tenant
    fun: torch.Tensor          # (B,) objective at x
    x_int: torch.Tensor        # (B, n) best rounded integer solution
    fun_int: torch.Tensor      # (B,) objective at x_int
    feasible: torch.Tensor     # (B,) integer-solution feasibility
    used_barrier: torch.Tensor  # (B, S)
    all_fun: torch.Tensor      # (B, S) relaxed objective per start
    iters: torch.Tensor        # total PGD iterations (fleet-wide)
    x_int_all: torch.Tensor    # (B, S, n) rounded candidate per start
    fun_int_all: torch.Tensor  # (B, S) objective per rounded candidate
    feas_int_all: torch.Tensor  # (B, S) integer feasibility per candidate


class FleetStepResult(NamedTuple):
    """One batched incremental tick over the whole fleet. ``trace`` is the
    per-lane :class:`~repro_torch.core.pgd.PGDTrace` of a
    ``capture_trace=True`` tick (else None); ``deadline_hit`` whether an
    anytime budget truncated the tick (None without one)."""

    x: torch.Tensor         # (B, n) relaxed incremental solution
    x_int: torch.Tensor     # (B, n) rounded allocation actually deployed
    fun_int: torch.Tensor   # (B,) objective at x_int
    feasible: torch.Tensor  # (B,) integer-solution feasibility
    iters: torch.Tensor     # (B,) adaptive-PGD iterations per lane
    trace: Optional[PGDTrace] = None     # (B, steps) per-lane rows
    deadline_hit: Optional[bool] = None  # anytime tick truncated (None: n/a)


def _use_kernel(hot_loop: str) -> bool:
    """Whether ``hot_loop`` evaluates eq. (1) with the kernel ("kernel" and
    "vmap") or with the plain version ("ref")."""
    if hot_loop not in HOT_LOOPS:
        raise ValueError(f"hot_loop must be one of {HOT_LOOPS}, "
                         f"got {hot_loop!r}")
    return hot_loop != "ref"


def _pgd_fleet(prob, X0, barrier_t, penalty_w, strict, cfg: SolverConfig,
               use_kernel: bool):
    """Batched inner PGD over (B, S) simultaneous solves.

    Per-element state mirrors the reference's ``_pgd_fleet``; elements that
    finished freeze in place while the rest iterate. ``it`` counts the
    iterations in which any element was still live, as the reference's
    global while-loop counter does; the host reads the done mask only every
    ``SYNC_EVERY`` iterations."""
    B, S, n = X0.shape
    L = cfg.n_backtracks

    def F_values(Xc):
        """Composite values (B, T) for Xc (B, T, n); T is S or S*L: every
        candidate's scenario terms from its own K@x."""
        f = obj.kernel_value_and_grad(prob, Xc, False, use_kernel)[0]
        s = strict.repeat_interleave(Xc.shape[1] // S, dim=1)
        return f + obj.barrier_or_penalty(prob, Xc, barrier_t, penalty_w, s)

    def G_at(Xc):
        """Composite gradient at the (B, S, n) iterate."""
        g = obj.kernel_value_and_grad(prob, Xc, True, use_kernel)[1]
        return g + obj.barrier_or_penalty_grad(prob, Xc, barrier_t,
                                               penalty_w, strict)

    ratios = ladder_ratios(cfg, X0.device)             # 1 upscale, as core
    x = obj.project(prob, X0)
    fx = F_values(x)
    g = G_at(x)
    bb = torch.full((B, S), cfg.step0, dtype=torch.float32, device=X0.device)
    it = torch.zeros((), dtype=torch.int64, device=X0.device)
    done = torch.zeros((B, S), dtype=torch.bool, device=X0.device)
    for k in range(cfg.max_iters):
        if k % SYNC_EVERY == 0 and k > 0 and bool(done.all()):
            break
        steps = bb[..., None] * ratios                                # (B,S,L)
        cands = obj.project(prob, x[:, :, None, :]
                            - steps[..., None] * g[:, :, None, :])    # (B,S,L,n)
        Fc = F_values(cands.reshape(B, S * L, n)).reshape(B, S, L)
        # Armijo on the projected step: F(x+) <= F(x) + c * g^T (x+ - x)
        dec = Fc - (fx[..., None] + cfg.armijo_c *
                    (g[:, :, None, :] * (cands - x[:, :, None, :])).sum(-1))
        ok = (dec <= 0.0) & torch.isfinite(Fc)
        idx = ok.to(torch.float32).argmax(-1)         # first (largest) step
        any_ok = ok.any(-1)
        x_sel = cands.gather(2, idx[..., None, None].expand(B, S, 1, n))
        x_new = torch.where(any_ok[..., None], x_sel.squeeze(2), x)
        f_new = torch.where(any_ok, Fc.gather(2, idx[..., None]).squeeze(2),
                            fx)
        g_new = G_at(x_new)
        # BB1 step from the accepted move (safeguarded into [1e-8, 1e4])
        dx = x_new - x
        dg = g_new - g
        denom = (dx * dg).sum(-1)
        bb_new = torch.where(denom.abs() > 1e-12,
                             ((dx * dx).sum(-1) / denom).abs(),
                             torch.full_like(denom, cfg.step0))
        bb_new = bb_new.clamp(1e-8, 1e4)
        bb_new = torch.where(any_ok, bb_new, bb * cfg.backtrack ** L)
        move = dx.abs().amax(-1)
        newly_done = ((~any_ok) & (bb < 1e-7)) | (any_ok & (move < cfg.tol))
        # freeze elements that were already done before this iteration
        x = torch.where(done[..., None], x, x_new)
        fx = torch.where(done, fx, f_new)
        g = torch.where(done[..., None], g, g_new)
        bb = torch.where(done, bb, bb_new)
        it = it + (~done).any()
        done = done | newly_done
    return x, fx, it


def _relax(prob, starts, cfg: SolverConfig, use_kernel: bool):
    """Hand-batched phase-1 -> barrier PGD -> feasibility restoration."""
    x = phase1_point(prob, starts)                                 # (B, S, n)
    lo, hi = obj.constraint_residuals(prob, x)
    strict = (lo.amin(-1) > 1e-3) & (hi.amin(-1) > 1e-3)           # (B, S)
    f32 = dict(dtype=torch.float32, device=starts.device)
    penalty_w = torch.tensor(cfg.penalty_w, **f32)
    iters = torch.zeros((), dtype=torch.int64, device=starts.device)
    for r in range(cfg.barrier_rounds):
        t = cfg.barrier_t0 * torch.tensor(cfg.barrier_kappa, **f32) ** float(r)
        x, _, it = _pgd_fleet(prob, x, t, penalty_w, strict, cfg, use_kernel)
        iters = iters + it
    # feasibility restoration (no-op when already feasible)
    x = phase1_point(prob, x, steps=100, margin_frac=0.0)
    fun = obj.kernel_value_and_grad(prob, x, False, use_kernel)[0]  # (B, S)
    feas = obj.is_feasible(prob, x, 1e-3)
    return x, fun, feas, strict, iters


def _solve_fleet_impl(prob, starts, cfg: SolverConfig, use_kernel: bool
                      ) -> FleetSolveResult:
    x, fun, feas_rel, strict, iters = _relax(prob, starts, cfg, use_kernel)
    # round EVERY start (relaxed merit predicts integer cost poorly)
    x_int = round_and_polish(prob, x, use_kernel=use_kernel)       # (B, S, n)
    f_int = obj.objective(prob, x_int, use_kernel=use_kernel)
    feas_int = obj.is_feasible(prob, x_int, 1e-3)
    return _best_per_tenant(x, fun, feas_rel, strict, iters, x_int, f_int,
                            feas_int)


def _solve_fleet_lanes(batch: FleetBatch, starts, cfg: SolverConfig
                       ) -> FleetSolveResult:
    """``hot_loop="vmap"``: every tenant's starts relaxed and rounded by
    the single-problem solver at the tenant's true shape (what
    ``multistart_solve`` does with the same starts), then zero-embedded
    into the padded (B, S, n_max) result."""
    B, S, n_max = starts.shape
    dev = starts.device
    f32 = dict(dtype=torch.float32, device=dev)
    x = torch.zeros((B, S, n_max), **f32)
    x_int = torch.zeros((B, S, n_max), **f32)
    fun, f_int = torch.zeros((B, S), **f32), torch.zeros((B, S), **f32)
    flags = lambda: torch.zeros((B, S), dtype=torch.bool, device=dev)
    feas_rel, strict, feas_int = flags(), flags(), flags()
    iters = torch.zeros((), dtype=torch.int64, device=dev)
    for b in range(B):
        n = int(batch.n_true[b])
        res, xi, fi, ok = _solve_batch(tenant_problem(batch, b),
                                       starts[b, :, :n].contiguous(), cfg)
        x[b, :, :n], x_int[b, :, :n] = res.x, xi
        fun[b], f_int[b], feas_int[b] = res.fun, fi, ok
        feas_rel[b], strict[b] = res.feasible, res.used_barrier
        iters = iters + res.iters.sum()
    return _best_per_tenant(x, fun, feas_rel, strict, iters, x_int, f_int,
                            feas_int)


def _best_per_tenant(x, fun, feas_rel, strict, iters, x_int, f_int,
                     feas_int) -> FleetSolveResult:
    """Each tenant's winner: the first best feasible integer merit, and the
    best feasible relaxed merit kept for diagnostics."""
    B = x.shape[0]
    rows = torch.arange(B, device=x.device)
    j = torch.where(feas_int, f_int, f_int + 1e12).argmin(1)       # (B,)
    i = torch.where(feas_rel, fun, fun + 1e12).argmin(1)
    return FleetSolveResult(
        x=x[rows, i], fun=fun[rows, i],
        x_int=x_int[rows, j], fun_int=f_int[rows, j],
        feasible=feas_int[rows, j],
        used_barrier=strict, all_fun=fun, iters=iters,
        x_int_all=x_int, fun_int_all=f_int, feas_int_all=feas_int)


def _as_batch(fleet, device: torch.device) -> FleetBatch:
    """A FleetBatch on ``device`` from any accepted fleet form."""
    if isinstance(fleet, FleetBatch):
        return fleet._replace(problem=problem_to(fleet.problem, device))
    if isinstance(fleet, AllocationProblem):       # already stacked
        B, m, n = fleet.K.shape
        full = lambda v: np.full(B, v, np.int64)
        return FleetBatch(problem_to(fleet, device), full(n), full(m),
                          full(fleet.E.shape[1]))
    return stack_problems(list(fleet), device=device)


def solve_fleet(
    fleet: Union[FleetBatch, Sequence[AllocationProblem], AllocationProblem],
    n_starts: int = 4,
    seed: int = 0,
    cfg: Optional[SolverConfig] = None,
    starts: Optional[torch.Tensor] = None,
    hot_loop: str = "kernel",
    device: DeviceLike = None,
) -> FleetSolveResult:
    """Solve every tenant problem in one batched pass on ``device``.

    ``fleet`` may be a FleetBatch, a list of (ragged) AllocationProblems, or
    an already-stacked AllocationProblem. ``starts`` overrides the generated
    (B, S, n) start points. ``hot_loop="kernel"`` (the default) evaluates
    eq. (1) with the CUDA kernel on the card; ``"ref"`` with the plain
    PyTorch version. The step acceptance is chaotic in the last ulps, so the
    two agree to solver tolerance, not bit for bit. ``"vmap"`` solves each
    tenant alone with the single-problem solver (module docstring): lane b
    is bit for bit ``multistart_solve`` of tenant b from the same starts."""
    use_kernel = _use_kernel(hot_loop)
    dev = resolve_device(device)
    batch = _as_batch(fleet, dev)
    cfg = cfg or SolverConfig()
    if starts is None:
        starts = make_fleet_starts(batch, n_starts, seed)
    starts = torch.as_tensor(starts, dtype=torch.float32, device=dev)
    if hot_loop == "vmap":
        return _solve_fleet_lanes(batch, starts, cfg)
    return _solve_fleet_impl(batch.problem, starts, cfg, use_kernel)


def make_fleet_starts(batch: FleetBatch, n_starts: int,
                      seed: int = 0) -> torch.Tensor:
    """(B, S, n_max) start points, drawn PER TENANT at its true shape (so
    the starts do not depend on the fleet's padding), zero-embedded, on the
    batch's device."""
    out = torch.zeros((batch.B, n_starts, batch.n_max), dtype=torch.float32,
                      device=batch.problem.device)
    for b in range(batch.B):
        out[b, :, : int(batch.n_true[b])] = make_starts(
            tenant_problem(batch, b), n_starts, seed)
    return out


def solve_fleet_bucketed(
    problems: Sequence[AllocationProblem],
    n_starts: int = 4,
    seed: int = 0,
    cfg: Optional[SolverConfig] = None,
    hot_loop: str = "kernel",
    bucketed: Optional[BucketedFleet] = None,
    device: DeviceLike = None,
) -> FleetSolveResult:
    """:func:`solve_fleet` with shape-bucketed stacking: one batched solve
    per power-of-two bucket, results scattered back into the ORIGINAL
    tenant order and padded to the fleet's true n_max, so the result reads
    like an unbucketed ``solve_fleet``'s. Starts are drawn per tenant at
    its true shape (:func:`make_fleet_starts`), so every tenant sees the
    starts a global pad would give it. ``bucketed`` reuses a precomputed
    layout."""
    problems = list(problems)
    dev = resolve_device(device)
    if bucketed is None:
        bucketed = bucket_problems(problems, device=dev)
    n_max = max(int(pb.n) for pb in problems)
    results = [solve_fleet(b, n_starts=n_starts, seed=seed, cfg=cfg,
                           hot_loop=hot_loop, device=dev)
               for b in bucketed.batches]
    # row i of the bucket-ordered concatenation is tenant flat[i]
    flat = np.concatenate(bucketed.tenant_idx)
    order = torch.as_tensor(np.argsort(flat), device=dev)

    def to_n_max(a: torch.Tensor) -> torch.Tensor:
        """A bucket's solution columns aligned to the fleet's true n_max:
        a power-of-two pad past it holds only pinned-zero padding."""
        if a.shape[-1] >= n_max:
            return a[..., :n_max]
        return torch.nn.functional.pad(a, (0, n_max - a.shape[-1]))

    def gather(field: str, is_solution: bool = False) -> torch.Tensor:
        rows = [getattr(r, field) for r in results]
        if is_solution:
            rows = [to_n_max(a) for a in rows]
        return torch.cat(rows)[order]

    return FleetSolveResult(
        x=gather("x", True), fun=gather("fun"),
        x_int=gather("x_int", True), fun_int=gather("fun_int"),
        feasible=gather("feasible"), used_barrier=gather("used_barrier"),
        all_fun=gather("all_fun"),
        iters=torch.stack([r.iters for r in results]).sum(),
        x_int_all=gather("x_int_all", True),
        fun_int_all=gather("fun_int_all"),
        feas_int_all=gather("feas_int_all"))


def solve_fleet_step(
    fleet: Union[FleetBatch, AllocationProblem],
    x_current,
    delta_max,
    x_init=None,
    steps: int = 600,
    active: Optional[np.ndarray] = None,
    hot_loop: str = "kernel",
    device: DeviceLike = None,
    capture_trace: bool = False,
    anytime: Optional[AnytimeConfig] = None,
) -> FleetStepResult:
    """One incremental-adoption tick for EVERY tenant at once: per lane, PGD
    on the objective inside the L1 churn ball ``||x - x_current||_1 <=
    delta_max`` (``repro_torch.core.incremental``), then greedy rounding.

    ``x_current`` is the (B, n) previous-tick allocation (also the warm
    start unless ``x_init`` is given); ``delta_max`` is scalar or (B,).
    ``active`` is the (B,) ragged-horizon liveness mask (default: the
    batch's own): frozen lanes come back with ``x == x_int == x_current``.
    ``hot_loop`` chooses the kernel or the plain eq. (1), as in
    :func:`solve_fleet`; ``"vmap"`` solves each live tenant alone at its
    true shape, as the sequential controller does.

    ``capture_trace=True`` also returns each lane's convergence rows in
    ``FleetStepResult.trace`` (the solves are the untraced ones). An
    enabled ``anytime`` config runs every lane in one chunked solve against
    the config's clock and returns each lane's best-so-far feasible
    iterate when the fleet-wide budget expires, with
    ``FleetStepResult.deadline_hit``; a disabled or absent config takes
    the untruncated path. The two exclude each other."""
    use_kernel = _use_kernel(hot_loop)
    timed = anytime is not None and anytime.enabled
    if timed and capture_trace:
        raise ValueError("anytime deadlines and capture_trace are mutually "
                         "exclusive; drop one")
    dev = resolve_device(device)
    batch = _as_batch(fleet, dev)
    if active is None:
        active = batch.active_mask
    prob = batch.problem
    B = prob.c.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    x_current = torch.as_tensor(x_current, **f32)
    delta_max = torch.broadcast_to(torch.as_tensor(delta_max, **f32), (B,))
    x_init = x_current if x_init is None else torch.as_tensor(x_init, **f32)
    active = np.asarray(active, bool)
    live = torch.as_tensor(active, device=dev)
    trace = hit = None
    if hot_loop == "vmap":
        x_rel, x_int, iters, trace, hit = _step_lanes(
            batch, x_current, delta_max, x_init, steps, active,
            capture_trace, anytime if timed else None)
    else:
        x_rel, iters, *extra = solve_incremental_info(
            prob, x_current, delta_max, x_init=x_init, steps=steps,
            use_kernel=use_kernel, capture_trace=capture_trace,
            anytime=anytime)
        if timed:
            hit = extra[0].deadline_hit
        elif capture_trace:
            trace = extra[0]
        x_int = round_and_polish(prob, x_rel, use_kernel=use_kernel)
    # frozen lanes keep their warm start as the answer
    x_rel = torch.where(live[:, None], x_rel, x_current)
    x_int = torch.where(live[:, None], x_int, x_current)
    return FleetStepResult(
        x=x_rel, x_int=x_int,
        fun_int=obj.objective(prob, x_int, use_kernel=use_kernel),
        feasible=obj.is_feasible(prob, x_int, 1e-3),
        iters=torch.where(live, iters, torch.zeros_like(iters)),
        trace=trace, deadline_hit=hit)


class _LaneStates(NamedTuple):
    """The anytime states of ``hot_loop="vmap"``'s live lanes, each solved
    at its true shape; ``done`` joins their masks for ``run_anytime``."""

    states: list

    @property
    def done(self) -> torch.Tensor:
        return torch.cat([st.done for st in self.states])


def _step_lanes(batch: FleetBatch, x_current, delta_max, x_init, steps: int,
                live: np.ndarray, capture_trace: bool = False,
                anytime: Optional[AnytimeConfig] = None):
    """``hot_loop="vmap"``'s warm tick: each live tenant's incremental solve
    and rounding alone at its true shape, zero-embedded; frozen lanes keep
    zeros (the caller puts their warm start back). Traced, each lane's rows
    land in its row of a (B, steps) trace; under ``anytime`` every live
    lane's chunked solve advances in one loop against one clock, as the
    batched engine's lanes do. Returns ``(x_rel, x_int, iters, trace,
    deadline_hit)``."""
    x_rel = torch.zeros_like(x_current)
    x_int = torch.zeros_like(x_current)
    dev = x_current.device
    iters = torch.zeros(batch.B, dtype=torch.int64, device=dev)
    lanes = [int(b) for b in np.nonzero(live)[0]]
    n = {b: int(batch.n_true[b]) for b in lanes}
    pbs = {b: tenant_problem(batch, b) for b in lanes}
    trace = _empty_trace(batch.B, int(steps), dev) if capture_trace else None
    hit = None
    if anytime is not None:
        cfg = PGDConfig(max_iters=int(steps))
        stacked = {b: unsqueeze_problem(pbs[b]) for b in lanes}
        args = {b: (x_current[b, :n[b]][None], delta_max[b:b + 1])
                for b in lanes}
        state, report = run_anytime(
            lambda: _LaneStates([incremental_anytime_init(
                stacked[b], *args[b], x_init[b, :n[b]][None], cfg)
                for b in lanes]),
            lambda s, e: _LaneStates([incremental_anytime_chunk(
                stacked[b], *args[b], st, e, cfg)
                for b, st in zip(lanes, s.states)]),
            cfg, anytime)
        hit = report.deadline_hit
        solved = {b: (st.x_best[0], st.it[0])
                  for b, st in zip(lanes, state.states)}
    else:
        solved = {}
        for b in lanes:
            out = solve_incremental_info(
                pbs[b], x_current[b, :n[b]], delta_max[b],
                x_init=x_init[b, :n[b]], steps=steps,
                capture_trace=capture_trace)
            solved[b] = out[:2]
            if capture_trace:
                for rows, row in zip(trace, out[2]):
                    rows[b] = row
    for b in lanes:
        xr, it = solved[b]
        x_rel[b, :n[b]], iters[b] = xr, it
        x_int[b, :n[b]] = round_and_polish(pbs[b], xr)
    return x_rel, x_int, iters, trace, hit
