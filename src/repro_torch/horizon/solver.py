"""Solver for the time-expanded receding-horizon program — port of
``repro.horizon.solver``.

Two entry points:

* :func:`solve_horizon` / :func:`solve_horizon_info` — one window
  (leaves (H, ...)): projected-gradient descent on the relaxed
  time-expanded objective over the plan ``X (H, n)``.
* :func:`solve_horizon_fleet_step` — B windows at once (leaves
  (B, H, ...)), the fleet analogue of ``fleet.solver.solve_fleet_step``:
  committed-tick rounding and ragged-horizon freezing, one call per shape
  bucket per tick in a batched MPC replay.

Both run B lanes of plans X (B, H, n) through one engine (a single window
is B = 1): the shared BB/Armijo loop of ``core.pgd`` on the merit

    F(X) = Σ_h f_h(X_h)                       per-tick eq. (1)
         + coupling(X)                        smoothed inter-tick churn
         + commit_coupling(X_0, x_current)    the committed churn, priced
         + churn_bound(X)                     hinge² excess over delta_max
         + Σ_{h≥1} penalty(prob_h, X_h)       planned-tick band penalty

over the projection that keeps row 0 in box ∩ the L1 churn ball around
``x_current`` (exact ``project_incremental``) and rows 1.. in their box.
Every per-tick eq. (1) value and gradient of all B·H ticks is one
``core.objective`` call on the B·H stack (``horizon.problem.tick_values``
/ ``tick_grads``): on the card one ``alloc_objective`` fleet launch at
T = 1 for the gradient and T = L (the ladder's rungs) for the values.
``use_kernel`` / ``hot_loop="ref"`` run the plain eq. (1) instead.

``HorizonSolverConfig(solver="fixed")`` keeps the reference's fixed-step
loop (``X ← Π(X - ∇F(X)/L)`` with per-tick Lipschitz-ish steps);
``solver="admm"`` runs ``horizon.admm``.

At H = 1 every window-level term is absent and the engine gets exactly
``core.incremental``'s merit triple on the (B, n) iterate of tick 0, the
shapes and ``use_kernel`` of ``solve_incremental_info`` — so H = 1 is the
myopic warm tick bit for bit (the ADMM config too: one block has nothing
to split). The committed tick is rounded plan-respectingly at H > 1
(:func:`round_committed`: lower bound lifted to floor(x_rel_0)), plainly
at H = 1.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from ..core import objective as obj
from ..core.incremental import _incremental_merit_fns, project_incremental
from ..core.pgd import (AnytimeConfig, PGDConfig, PGDTrace, pgd_chunk_init,
                        pgd_chunk_run, pgd_minimize, pgd_minimize_traced,
                        run_anytime)
from ..core.problem import AllocationProblem
from ..core.rounding import round_and_polish
from ..device import DeviceLike, resolve_device
from ..fleet.batching import FleetBatch, tenant_problem
from ..fleet.solver import _use_kernel
from ..obs.metrics import current_metrics
from ..obs.telemetry import current_recorder, gauge
from .admm import ADMMDiag, ADMMTrace, admm_solve_plan
from .problem import (HorizonProblem, coupling_term_defs, flatten_lanes,
                      map_problem, tick_grads, tick_values)

# planned-tick band-penalty weight (core.solver.SolverConfig's penalty_w)
DEFAULT_PENALTY_W = 1e3
# soft churn-bound weight on planned transitions, the reference's value
# retuned for the adaptive engine
DEFAULT_DELTA_PENALTY_W = 10.0


class HorizonSolverConfig(NamedTuple):
    """Horizon-solver knobs, one per replay (see
    ``repro.horizon.solver.HorizonSolverConfig``): ``solver`` picks the
    engine ("adaptive" BB/Armijo, "fixed" step, "admm"), ``steps`` is the
    per-tick iteration budget (600, the myopic warm tick's), the ladder's
    parameters are ``core.pgd.PGDConfig``'s, ``step_scale`` scales the
    fixed engine's step, ``penalty_w`` / ``delta_penalty_w`` weight the
    planned-tick band penalty and the soft churn bound (inert at H = 1),
    and ``rho`` / ``admm_iters`` / ``inner_steps`` / ``admm_tol`` are the
    ADMM engine's."""

    solver: str = "adaptive"       # "adaptive" (BB/Armijo) | "fixed" | "admm"
    steps: int = 600               # per-tick iteration budget
    tol: float = 1e-6              # adaptive: stop when the move is tiny
    ftol: float = 1e-4             # adaptive: ... or merit progress is flat
    max_flat: int = 10             # adaptive: consecutive flat steps to stop
    step0: float = 1.0             # adaptive: initial/fallback BB step
    n_backtracks: int = 12         # adaptive: Armijo ladder length
    backtrack: float = 0.5         # adaptive: ladder ratio
    armijo_c: float = 1e-4         # adaptive: sufficient-decrease slope
    step_scale: float = 1.0        # fixed: Lipschitz-step scale
    penalty_w: float = DEFAULT_PENALTY_W
    delta_penalty_w: float = DEFAULT_DELTA_PENALTY_W
    rho: float = 4.0               # admm: consensus penalty weight
    admm_iters: int = 30           # admm: outer (consensus) iteration budget
    inner_steps: int = 20          # admm: per-block inner PGD budget
    admm_tol: float = 1e-4         # admm: relative residual stop tolerance

    def pgd(self) -> PGDConfig:
        """The ``core.pgd.PGDConfig`` this config's adaptive fields map to."""
        return PGDConfig(max_iters=self.steps, step0=self.step0,
                         n_backtracks=self.n_backtracks,
                         backtrack=self.backtrack, armijo_c=self.armijo_c,
                         tol=self.tol, ftol=self.ftol,
                         max_flat=self.max_flat)

    def inner_pgd(self) -> PGDConfig:
        """The ADMM engine's inner-prox ``PGDConfig``: :meth:`pgd`'s ladder
        at the ``inner_steps`` budget, flat-merit stopping off."""
        return self.pgd()._replace(max_iters=self.inner_steps, ftol=0.0)


class HorizonSolveResult(NamedTuple):
    """One relaxed horizon solve: the plan and the iterations it took.
    ``trace`` is the engine's capture of a ``capture_trace=True`` solve
    (``PGDTrace`` rows (steps,), or an ``ADMMTrace`` of (admm_iters,) rows
    for ``solver="admm"`` at H > 1), ``diag`` the ADMM certificate (None
    for the other engines and at H = 1), ``deadline_hit`` whether an
    anytime budget truncated the solve (None without one)."""

    plan: torch.Tensor      # (H, n) relaxed time-expanded solution
    iters: torch.Tensor     # PGD iterations actually taken (== steps, fixed)
    trace: Optional[Union[PGDTrace, ADMMTrace]] = None
    diag: Optional[ADMMDiag] = None
    deadline_hit: Optional[bool] = None


class _Window(NamedTuple):
    """B windows of H ticks, as the engines use them: ``P`` the B·H tick
    problems stacked lane-major, ``P0`` tick 0 of each window (B stacked),
    ``rest`` the planned ticks (B·(H−1) stacked; None at H = 1), and the
    (B, H, n) box of every tick."""

    P: AllocationProblem
    P0: AllocationProblem
    rest: Optional[AllocationProblem]
    lb: torch.Tensor
    ub: torch.Tensor
    mask: torch.Tensor
    coupling_w: torch.Tensor
    coupling_eps: torch.Tensor
    B: int
    H: int

    def box(self, X: torch.Tensor) -> torch.Tensor:
        """Every row of plans X (B, ..., H, n) projected onto its tick's
        box ∩ mask support (``core.objective.project``'s op sequence)."""
        shape = (self.B, *([1] * (X.dim() - 3)), self.H, X.shape[-1])
        return (torch.minimum(torch.maximum(X, self.lb.reshape(shape)),
                              self.ub.reshape(shape))
                * self.mask.reshape(shape))

    def term_defs(self, x_current, delta_max, delta_penalty_w):
        return coupling_term_defs(
            HorizonProblem(self.P, self.coupling_w, self.coupling_eps),
            x_current, delta_max, delta_penalty_w)


def _window(problem: AllocationProblem, coupling_w, coupling_eps, B: int,
            H: int) -> _Window:
    """The engine's view of ``problem``, whose leaves are (B, H, ...)."""
    P = flatten_lanes(problem)
    P0 = map_problem(problem, lambda a: a[:, 0].contiguous())
    rest = (None if H == 1 else
            map_problem(problem, lambda a: a[:, 1:].reshape(
                B * (H - 1), *a.shape[2:]).contiguous()))
    return _Window(P=P, P0=P0, rest=rest, lb=problem.lb, ub=problem.ub,
                   mask=problem.mask, coupling_w=coupling_w,
                   coupling_eps=coupling_eps, B=B, H=H)


def _tick_lipschitz(prob: AllocationProblem) -> torch.Tensor:
    """Per-tick step denominator of the FIXED engine (the reference's
    pre-adaptive ``solve_incremental`` expression), one per stacked row."""
    return (2.0 * prob.params.beta3 * (prob.K * prob.K).sum((-2, -1))
            + torch.linalg.vector_norm(prob.c, dim=-1) + 1e-3)


def _horizon_merit_fns(W: _Window, x_current: torch.Tensor,
                       delta_max: torch.Tensor, penalty_w: float,
                       delta_penalty_w: float, use_kernel: bool = True):
    """The (value, grad, project) triple of the time-expanded program over
    plans (B, ..., H, n) — H > 1; H = 1 runs ``core.incremental``'s
    triple on tick 0 instead (:func:`_adaptive_problem`)."""
    B, H = W.B, W.H
    pw = torch.as_tensor(penalty_w, dtype=torch.float32,
                         device=x_current.device)
    tdefs = W.term_defs(x_current, delta_max, delta_penalty_w)

    def planned(X):
        # planned rows as B·(H-1) stacked points: (B·(H-1), ..., n)
        lead = X.shape[1:-2]
        Xr = X[..., 1:, :].movedim(-2, 1)
        return Xr.reshape(B * (H - 1), *lead, X.shape[-1])

    def value(X):
        val = tick_values(W.P, X, use_kernel).sum(-1)
        for td in tdefs:
            val = val + td.value(X)
        pen = obj.penalty(W.rest, planned(X), pw)        # (B·(H-1), ...)
        pen = pen.reshape(B, H - 1, *X.shape[1:-2]).movedim(1, -1)
        return val + pen.sum(-1)

    def grad(X):
        G = tick_grads(W.P, X, use_kernel)
        for td in tdefs:
            G = G + td.grad(X)
        Gp = obj.penalty_grad(W.rest, planned(X), pw).reshape(
            B, H - 1, X.shape[-1])
        return torch.cat([G[:, :1], G[:, 1:] + Gp], 1)

    def proj(X):
        x0 = project_incremental(W.P0, X[..., 0, :], x_current, delta_max)
        return torch.cat([x0.unsqueeze(-2), W.box(X)[..., 1:, :]], -2)

    return value, grad, proj


def _solve_horizon_fixed(W: _Window, x_current, delta_max, x_init,
                         steps: int, step_scale: float, penalty_w: float,
                         delta_penalty_w: float, use_kernel: bool = True):
    """The reference's fixed-step PGD loop over plans X (B, H, n), kept as
    the ``solver="fixed"`` baseline: ``steps`` iterations, no early stop
    (so no host read)."""
    B, H = W.B, W.H
    L = _tick_lipschitz(W.P).reshape(B, H)
    if H > 1:
        _, grad, proj = _horizon_merit_fns(W, x_current, delta_max,
                                           penalty_w, delta_penalty_w,
                                           use_kernel)
        # curvature of the smoothed |u| at 0, the churn-bound hinge, and
        # the planned rows' band penalty (the reference's estimate)
        L = (L + 2.0 * W.coupling_w / torch.sqrt(W.coupling_eps)
             + 4.0 * delta_penalty_w)
        pen_curv = 2.0 * penalty_w * (W.rest.K * W.rest.K).sum(
            (-2, -1)).reshape(B, H - 1)
        L = torch.cat([L[:, :1], L[:, 1:] + pen_curv], 1)
    else:
        grad = lambda X: tick_grads(W.P, X, use_kernel)
        proj = lambda X: project_incremental(W.P0, X[:, 0], x_current,
                                             delta_max)[:, None]
    X = proj(x_init)
    for _ in range(steps):
        X = proj(X - step_scale * grad(X) / L[..., None])
    return X


def _require_anytime_adaptive(cfg: HorizonSolverConfig,
                              capture_trace: bool) -> None:
    """The anytime contract is defined on the chunked BB/Armijo engine."""
    if cfg.solver != "adaptive":
        raise ValueError("anytime deadlines require solver='adaptive' "
                         f"(got {cfg.solver!r}): the fixed and admm "
                         "engines have no chunk-resumable state")
    if capture_trace:
        raise ValueError("anytime deadlines and capture_trace are "
                         "mutually exclusive; drop one")


def _resolve_cfg(cfg: Optional[HorizonSolverConfig]) -> HorizonSolverConfig:
    """``cfg``, or the default config; an unknown engine raises."""
    if cfg is None:
        return HorizonSolverConfig()
    if cfg.solver not in ("adaptive", "fixed", "admm"):
        raise ValueError(f"unknown horizon solver {cfg.solver!r}")
    return cfg


class _Solved(NamedTuple):
    plan: torch.Tensor                 # (B, H, n)
    iters: torch.Tensor                # (B,)
    trace: Optional[Union[PGDTrace, ADMMTrace]] = None
    diag: Optional[ADMMDiag] = None
    deadline_hit: Optional[bool] = None


def _adaptive_problem(W: _Window, x_current, delta_max, x_init,
                      cfg: HorizonSolverConfig, use_kernel: bool):
    """What the adaptive engine iterates: ``(fns, x0, lift)``, the merit
    triple, the start and the map of the engine's iterate back to plans
    (B, H, n). At H = 1 it is exactly the warm tick's triple on tick 0's
    (B, n) iterate."""
    if W.H == 1:
        return (_incremental_merit_fns(W.P0, x_current, delta_max,
                                       use_kernel),
                x_init[:, 0], lambda x: x[:, None])
    return (_horizon_merit_fns(W, x_current, delta_max, cfg.penalty_w,
                               cfg.delta_penalty_w, use_kernel),
            x_init, lambda x: x)


def _solve_lanes(W: _Window, x_current: torch.Tensor, delta_max: torch.Tensor,
                 x_init: torch.Tensor, cfg: HorizonSolverConfig,
                 use_kernel: bool, trace: bool = False,
                 anytime: Optional[AnytimeConfig] = None) -> _Solved:
    """Every lane's relaxed solve, dispatched on the engine: x_current
    (B, n), delta_max (B,), x_init (B, H, n)."""
    H = W.H
    if anytime is not None and anytime.enabled:
        _require_anytime_adaptive(cfg, trace)
    if cfg.solver == "fixed":
        X = _solve_horizon_fixed(W, x_current, delta_max, x_init, cfg.steps,
                                 cfg.step_scale, cfg.penalty_w,
                                 cfg.delta_penalty_w, use_kernel)
        return _Solved(X, torch.full((W.B,), cfg.steps, dtype=torch.int64,
                                     device=X.device))
    if cfg.solver == "admm" and H > 1:
        out = admm_solve_plan(W, x_current, delta_max, x_init, rho=cfg.rho,
                              admm_iters=cfg.admm_iters,
                              inner_steps=cfg.inner_steps,
                              admm_tol=cfg.admm_tol, penalty_w=cfg.penalty_w,
                              delta_penalty_w=cfg.delta_penalty_w,
                              inner_cfg=cfg.inner_pgd(),
                              use_kernel=use_kernel, trace=trace)
        return _Solved(out[0], out[1], out[3] if trace else None, out[2])
    # adaptive, and the admm H = 1 dispatch (one block: nothing to split)
    fns, x0, lift = _adaptive_problem(W, x_current, delta_max, x_init, cfg,
                                      use_kernel)
    pcfg = cfg.pgd()
    if anytime is not None and anytime.enabled:
        state, report = run_anytime(
            lambda: pgd_chunk_init(*fns, x0, pcfg),
            lambda s, e: pgd_chunk_run(*fns, s, e, pcfg), pcfg, anytime)
        return _Solved(lift(state.x_best), state.it,
                       deadline_hit=report.deadline_hit)
    if trace:
        X, _, iters, tr = pgd_minimize_traced(*fns, x0, pcfg)
        return _Solved(lift(X), iters, tr)
    X, _, iters = pgd_minimize(*fns, x0, pcfg)
    return _Solved(lift(X), iters)


def _gauge_admm(diag: Optional[ADMMDiag]) -> None:
    """An ADMM solve's certificate as ``horizon/admm_*`` telemetry gauges
    and, with a metrics registry installed, metrics: the worst lane's
    residuals. With neither sink installed nothing is read from the
    device."""
    reg = current_metrics()
    if diag is None or (current_recorder() is None and reg is None):
        return
    primal = float(diag.primal_res.max())
    dual = float(diag.dual_res.max())
    iters = float(diag.admm_iters.max())
    gauge("horizon/admm_primal_res", primal)
    gauge("horizon/admm_dual_res", dual)
    gauge("horizon/admm_iters", iters)
    if reg is not None:
        reg.histogram("horizon/admm_primal_res",
                      lo_exp=-30, hi_exp=10).observe(primal)
        reg.gauge("horizon/admm_dual_res").set(dual)
        reg.gauge("horizon/admm_iters").set(iters)


def _first(x):
    """Lane 0 of a per-lane result (tensor, NamedTuple of tensors, None)."""
    if x is None:
        return None
    if isinstance(x, tuple):
        return type(x)(*(f[0] for f in x))
    return x[0]


def solve_horizon_info(hp: HorizonProblem, x_current, delta_max,
                       x_init=None,
                       cfg: Optional[HorizonSolverConfig] = None,
                       capture_trace: bool = False,
                       anytime: Optional[AnytimeConfig] = None,
                       use_kernel: bool = True) -> HorizonSolveResult:
    """:func:`solve_horizon` returning the plan AND the iterations the
    engine spent, on ``hp``'s device (``use_kernel`` as
    ``solve_incremental_info``'s). ``capture_trace=True`` fills
    ``trace`` (the fixed engine raises ``ValueError``); an enabled
    ``anytime`` config (adaptive engine only) runs the solve in chunks
    against its clock and returns the best-so-far plan by merit when the
    budget expires, with ``deadline_hit``."""
    cfg = _resolve_cfg(cfg)
    if capture_trace and cfg.solver == "fixed":
        raise ValueError("capture_trace requires the adaptive or admm "
                         "engine; solver='fixed' records no convergence "
                         "trace")
    H, n = hp.H, hp.n
    dev = hp.problem.device
    f32 = dict(dtype=torch.float32, device=dev)
    xc = torch.as_tensor(x_current, **f32).reshape(1, n)
    dm = torch.as_tensor(delta_max, **f32).reshape(1)
    X0 = (xc[:, None].expand(1, H, n) if x_init is None
          else torch.as_tensor(x_init, **f32).reshape(1, H, n))
    W = _window(map_problem(hp.problem, lambda a: a[None]), hp.coupling_w,
                hp.coupling_eps, 1, H)
    out = _solve_lanes(W, xc, dm, X0, cfg, use_kernel, capture_trace,
                       anytime)
    _gauge_admm(out.diag)
    return HorizonSolveResult(plan=out.plan[0], iters=out.iters[0],
                              trace=_first(out.trace), diag=_first(out.diag),
                              deadline_hit=out.deadline_hit)


def solve_horizon(hp: HorizonProblem, x_current, delta_max, x_init=None,
                  cfg: Optional[HorizonSolverConfig] = None,
                  use_kernel: bool = True) -> torch.Tensor:
    """Solve the relaxed time-expanded program; returns the plan X (H, n).

    ``x_current`` (n,) is the deployed allocation the committed tick
    chains from (hard L1 ball of radius ``delta_max``); ``x_init``
    optionally warm-starts the whole plan; ``cfg`` selects and
    parameterizes the engine (default ``HorizonSolverConfig()``). Only row
    0 is committed — round it with :func:`round_committed`."""
    return solve_horizon_info(hp, x_current, delta_max, x_init=x_init,
                              cfg=cfg, use_kernel=use_kernel).plan


def round_committed(p0: AllocationProblem, x_rel0: torch.Tensor,
                    respect_plan: bool, use_kernel: bool = True
                    ) -> torch.Tensor:
    """Round the committed tick. With ``respect_plan`` (H > 1) the rounding
    problem's lower bound is lifted to ``floor(x_rel0)``, so the polish
    scale-down cannot strip capacity the plan holds for future ticks;
    without it this is plain ``round_and_polish``, the myopic commit.
    ``p0`` may be single or stacked (then x_rel0 is (B, n))."""
    if not respect_plan:
        return round_and_polish(p0, x_rel0, use_kernel=use_kernel)
    lb = torch.minimum(torch.maximum(torch.floor(x_rel0), p0.lb), p0.ub)
    return round_and_polish(p0._replace(lb=lb), x_rel0,
                            use_kernel=use_kernel)


# ---------------------------------------------------------------------------
# batched fleet tick (one call per shape bucket per tick, like solve_fleet)
# ---------------------------------------------------------------------------


class HorizonFleetStepResult(NamedTuple):
    """One batched receding-horizon tick over a fleet of windows. ``trace``
    holds per-lane rows ((B, L) leaves) of a ``capture_trace=True`` tick,
    ``diag`` the ADMM engine's per-lane certificate (frozen lanes carry
    the values of the discarded solve)."""

    plan: torch.Tensor      # (B, H, n) relaxed plans (frozen: x_current tiled)
    x_int: torch.Tensor     # (B, n) committed (rounded) tick-0 allocation
    fun_int: torch.Tensor   # (B,) tick-0 objective at x_int
    feasible: torch.Tensor  # (B,) tick-0 integer feasibility
    iters: torch.Tensor     # (B,) PGD iterations per lane (frozen lanes: 0)
    trace: Optional[Union[PGDTrace, ADMMTrace]] = None
    diag: Optional[ADMMDiag] = None
    deadline_hit: Optional[bool] = None


def _lane_window(hp: HorizonProblem, b: int, dims) -> HorizonProblem:
    """Window ``b`` of a fleet, cut to its true (n, m, p) from ``dims`` (or
    at the padded shape): the window a controller would stack for that
    tenant (``fleet.batching.tenant_problem``, which keeps the tick
    axis)."""
    B, H, n = hp.problem.c.shape
    if dims is None:
        dims = (n, hp.problem.d.shape[-1], hp.problem.E.shape[-2])
    full = lambda v: np.broadcast_to(np.asarray(v, np.int64), (B,))
    batch = FleetBatch(hp.problem, *(full(v) for v in dims))
    return HorizonProblem(tenant_problem(batch, b), hp.coupling_w,
                          hp.coupling_eps)


def _step_lanes(hp: HorizonProblem, x_current, delta_max, x_init,
                live: np.ndarray, cfg: HorizonSolverConfig, dims,
                capture_trace: bool, anytime: Optional[AnytimeConfig]):
    """``hot_loop="vmap"``: every live window solved alone at its true
    shape (``dims``) with the kernel — :func:`solve_horizon_info`'s solve
    of that window, rounded by :func:`round_committed` and zero-embedded:
    what the sequential MPC controller computes. Under ``anytime`` every
    live window's chunked solve advances in one loop against one clock,
    as the batched engine's lanes do. Returns ``(plan, x_int, iters,
    trace, diag, deadline_hit)``; frozen lanes hold zeros."""
    B, H, _ = x_init.shape
    plan = torch.zeros_like(x_init)
    x_int = torch.zeros_like(x_current)
    iters = torch.zeros(B, dtype=torch.int64, device=x_init.device)
    rows, diags, hit = [None] * B, [None] * B, None
    lanes = [int(b) for b in np.nonzero(live)[0]]
    wins = {b: _lane_window(hp, b, dims) for b in lanes}
    if anytime is not None:
        pcfg = cfg.pgd()
        probs = {}
        for b in lanes:
            n = wins[b].n
            W = _window(map_problem(wins[b].problem, lambda a: a[None]),
                        hp.coupling_w, hp.coupling_eps, 1, H)
            probs[b] = _adaptive_problem(
                W, x_current[b:b + 1, :n], delta_max[b:b + 1],
                x_init[b:b + 1, :, :n], cfg, True)
        state, report = run_anytime(
            lambda: _LaneStates([pgd_chunk_init(*probs[b][0], probs[b][1],
                                                pcfg) for b in lanes]),
            lambda s, e: _LaneStates([pgd_chunk_run(*probs[b][0], st, e,
                                                    pcfg)
                                      for b, st in zip(lanes, s.states)]),
            pcfg, anytime)
        hit = report.deadline_hit
        solved = {b: (probs[b][2](st.x_best)[0], st.it[0], None, None)
                  for b, st in zip(lanes, state.states)}
    else:
        solved = {}
        for b in lanes:
            n = wins[b].n
            res = solve_horizon_info(wins[b], x_current[b, :n], delta_max[b],
                                     x_init=x_init[b, :, :n], cfg=cfg,
                                     capture_trace=capture_trace)
            solved[b] = (res.plan, res.iters, res.trace, res.diag)
    for b in lanes:
        n = wins[b].n
        plan[b, :, :n], iters[b], rows[b], diags[b] = solved[b]
        x_int[b, :n] = round_committed(
            map_problem(wins[b].problem, lambda a: a[0]), plan[b, 0, :n],
            H > 1)
    stack = lambda recs: (None if all(r is None for r in recs) else
                          _stack_rows(recs, B))
    return plan, x_int, iters, stack(rows), stack(diags), hit


class _LaneStates(NamedTuple):
    """The anytime states of ``hot_loop="vmap"``'s live windows, each
    solved at its true shape; ``done`` joins their masks for
    ``run_anytime``."""

    states: list

    @property
    def done(self) -> torch.Tensor:
        return torch.cat([st.done for st in self.states])


def _stack_rows(recs: Sequence, B: int):
    """Per-lane NamedTuples (None on frozen lanes) as one with a leading
    (B,) axis; a frozen lane's row holds the trace sentinels (NaN, False,
    -1)."""
    ref = next(r for r in recs if r is not None)

    def blank(f):
        if f.dtype == torch.bool:
            return torch.zeros_like(f)
        return torch.full_like(f, float("nan") if f.is_floating_point()
                               else -1)

    return type(ref)(*(torch.stack([r[k] if r is not None else blank(f)
                                    for r in recs])
                       for k, f in enumerate(ref)))


def solve_horizon_fleet_step(hp: HorizonProblem, x_current, delta_max,
                             x_init=None,
                             active: Optional[np.ndarray] = None,
                             cfg: Optional[HorizonSolverConfig] = None,
                             capture_trace: bool = False,
                             anytime: Optional[AnytimeConfig] = None,
                             hot_loop: str = "kernel",
                             dims=None,
                             device: DeviceLike = None
                             ) -> HorizonFleetStepResult:
    """One receding-horizon tick for EVERY window lane at once, on
    ``device``.

    ``hp.problem`` leaves carry (B, H, ...) axes: B windows padded to one
    shape bucket (see ``horizon.problem.stack_windows``). ``x_current``
    (B, n) is the deployed allocation, ``delta_max`` scalar or (B,),
    ``x_init`` (B, H, n) the warm starts (default: x_current tiled).
    ``active`` is the ragged-horizon liveness mask: frozen lanes come back
    with ``x_int == x_current``, their plan pinned to it and ``iters ==
    0``. ``cfg`` selects the engine as in :func:`solve_horizon`.

    ``hot_loop="kernel"`` evaluates eq. (1) with the CUDA kernel on the
    card, ``"ref"`` with the plain PyTorch version; ``"vmap"`` solves each
    live window alone at its true shape — ``dims``, the per-lane
    ``(n_true, m_true, p_true)``, default the padded shape — as the
    sequential controller does (the equivalence mode). At H = 1 the tick
    is ``fleet.solver.solve_fleet_step``'s bit for bit.

    ``capture_trace=True`` returns per-lane convergence rows in ``trace``
    (``PGDTrace``, or ``ADMMTrace`` for admm at H > 1; the fixed engine
    raises ``ValueError``). An enabled ``anytime`` config (adaptive engine
    only) runs every lane in one chunked solve against its clock and
    commits each lane's best-so-far plan when the fleet-wide budget
    expires (``deadline_hit``)."""
    use_kernel = _use_kernel(hot_loop)
    cfg = _resolve_cfg(cfg)
    if capture_trace and cfg.solver == "fixed":
        raise ValueError("capture_trace requires the adaptive or admm "
                         "engine; solver='fixed' records no convergence "
                         "trace")
    timed = anytime is not None and anytime.enabled
    if timed:
        _require_anytime_adaptive(cfg, capture_trace)
    dev = resolve_device(device)
    if hp.problem.device != dev:
        hp = HorizonProblem(map_problem(hp.problem, lambda a: a.to(dev)),
                            hp.coupling_w.to(dev), hp.coupling_eps.to(dev))
    B, H, n = hp.problem.c.shape
    f32 = dict(dtype=torch.float32, device=dev)
    x_current = torch.as_tensor(x_current, **f32)
    delta_max = torch.broadcast_to(torch.as_tensor(delta_max, **f32), (B,))
    x_init = (x_current[:, None].expand(B, H, n) if x_init is None
              else torch.as_tensor(x_init, **f32))
    live_np = (np.ones(B, bool) if active is None
               else np.asarray(active, bool))
    live = torch.as_tensor(live_np, device=dev)
    W = _window(hp.problem, hp.coupling_w, hp.coupling_eps, B, H)
    if hot_loop == "vmap":
        plan, x_int, iters, tr, diag, hit = _step_lanes(
            hp, x_current, delta_max, x_init, live_np, cfg, dims,
            capture_trace, anytime if timed else None)
    else:
        out = _solve_lanes(W, x_current, delta_max, x_init, cfg, use_kernel,
                           capture_trace, anytime if timed else None)
        plan, iters, tr, diag, hit = out
        x_int = round_committed(W.P0, plan[:, 0], H > 1, use_kernel)
    # frozen lanes (expired traces) keep their current allocation
    plan = torch.where(live[:, None, None], plan,
                       x_current[:, None].expand(B, H, n))
    x_int = torch.where(live[:, None], x_int, x_current)
    _gauge_admm(diag)
    return HorizonFleetStepResult(
        plan=plan, x_int=x_int,
        fun_int=obj.objective(W.P0, x_int, use_kernel=use_kernel),
        feasible=obj.is_feasible(W.P0, x_int, 1e-3),
        iters=torch.where(live, iters, torch.zeros_like(iters)),
        trace=tr, diag=diag, deadline_hit=hit)
