"""Trace-driven fleet replay — port of ``repro.fleet.replay``'s two
engines, with the myopic and the receding-horizon (MPC) controllers.

``replay_mode="sequential"`` (the reference's default) steps each tenant's
``InfrastructureOptimizationController`` through its trace, one solve per
tenant per tick on the device (``replay_tenant`` replays one tenant).
``replay_mode="batched"`` steps every tenant with one batched solve per
shape bucket per tick: tick 0 is a cold ``solve_fleet`` (per-tenant
starts drawn at true shape, seed 0), every later tick a warm
``solve_fleet_step`` from the previous tick's allocation under each
tenant's L1 churn bound. Tenants are grouped once into power-of-two shape
buckets (``bucket_dims``) plus ``n_starts``. Ragged traces freeze a
finished tenant in its batch lane: its last allocation stays as a fixed
warm start and it records no more history. With ``hot_loop="vmap"`` the
batched engine solves each tenant alone and commits exactly the
sequential engine's allocations, ragged horizons included.

In the batched engine the controllers build each tick's per-tenant
problem on the host; ``stack_problems`` moves each bucket's stack to the
device in one copy per leaf, and the solve runs there. A tenant's
scenario terms (``TenantSpec.terms``, e.g. from ``repro_torch.fleet.
scenarios``) ride on its every tick's problem; a bucket stacks the union
of its tenants' kinds, zero-priced where a tenant lacks one.

The Cluster-Autoscaler baseline runs on the host (numpy, as in the
reference and the paper) over the same traces. Each tenant's node pools
are sized from its trace's PER-RESOURCE PEAK demand
(``trace.max(axis=0)``): pools sized from one tick could not schedule the
peak of a ramp or a flash crowd, and the baseline's phantom SLO misses
would inflate the savings. By default the whole baseline fleet steps
through ``simulate_cluster_autoscaler_batch``, one call per tick per
distinct catalog; ``ca_engine="sequential"`` loops the per-tenant oracle,
and the two agree tick for tick.

Both engines also take the reference's observers and budgets: a
``repro_torch.obs.HealthMonitor`` (``health=``) that observes every
committed (tenant, tick) and times every tick with its clock, per-warm-tick
solver traces (``capture_solver_trace=True``, returned as
``FleetReplayResult.solver_traces``), an anytime deadline on every warm
solve (``anytime=AnytimeConfig(...)``), and ``replay/*`` telemetry spans
and gauges (``repro_torch.obs.telemetry``). None of them changes an
allocation.

Both engines also drive the receding-horizon controller
(``controller="mpc"``, ``repro_torch.horizon``): each tick forecasts
``horizon`` ticks, solves one time-expanded program, and commits tick 0.
The batched engine's tick loop is the same for both controllers; with
MPC its warm tick issues one ``solve_horizon_fleet_step`` per shape
bucket on the bucket's windows (the B·H tick problems stacked
lane-major, at the bucket's union term signature); ``hot_loop`` acts on
it as on the myopic engines.
``run_oracle_baseline`` replays the same MPC fleet under the oracle
forecaster for ``FleetReplayMetrics.regret_vs_oracle``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.autoscaler import (default_pools_for,
                               simulate_cluster_autoscaler,
                               simulate_cluster_autoscaler_batch)
from ..core.catalog import Catalog
from ..core.catalog import M as RESOURCE_DIM
from ..core.controller import (ControllerStep,
                               InfrastructureOptimizationController)
from ..core.metrics import AllocationMetrics, evaluate
from ..core.pgd import AnytimeConfig
from ..core.problem import PenaltyParams, problem_to
from ..device import DeviceLike, resolve_device
from ..obs import metrics as obs_metrics
from ..obs.health import HealthMonitor
from ..obs.telemetry import gauge, span
from .batching import (bucket_dims, embed_solutions, stack_problems,
                       union_term_kinds)
from .metrics import FleetReplayMetrics, TenantReplayMetrics, tenant_metrics
from .solver import (_use_kernel, make_fleet_starts, solve_fleet,
                     solve_fleet_step)

HOST = torch.device("cpu")


@dataclass
class TenantSpec:
    """One tenant cluster: a demand trace plus its controller knobs (see
    ``repro.fleet.replay.TenantSpec``); validated at construction."""

    name: str
    trace: np.ndarray                            # (T, m) demand per tick
    delta_max: float = 8.0                       # max L1 churn per tick
    n_starts: int = 4
    params: Optional[PenaltyParams] = None
    allowed_idx: Optional[np.ndarray] = None     # approved instance types
    catalog: Optional[Catalog] = None            # overrides the fleet catalog
    ca_pool_idx: Optional[np.ndarray] = None     # CA node pools (default: the
                                                 # cheapest covering types)
    terms: tuple = ()
    spot_idx: Optional[np.ndarray] = None        # (S,) catalog spot-twin idx
    spot_availability: Optional[np.ndarray] = None   # (T', S) in {0, 1}

    def __post_init__(self) -> None:
        """Fail fast on malformed traces."""
        trace = np.asarray(self.trace)
        if trace.ndim != 2:
            raise ValueError(
                f"TenantSpec {self.name!r}: trace must be a 2-D (T, m) array "
                f"of per-tick demand, got shape {trace.shape}")
        if trace.shape[0] < 1:
            raise ValueError(
                f"TenantSpec {self.name!r}: trace must have at least one "
                f"tick, got shape {trace.shape}")
        m = (self.catalog.matrices()[0].shape[0]
             if self.catalog is not None else RESOURCE_DIM)
        if trace.shape[1] != m:
            raise ValueError(
                f"TenantSpec {self.name!r}: trace has {trace.shape[1]} "
                f"resource columns but the catalog's resource dim is {m}")
        if (self.spot_idx is None) != (self.spot_availability is None):
            raise ValueError(
                f"TenantSpec {self.name!r}: spot_idx and spot_availability "
                f"must be given together")
        if self.spot_availability is not None:
            avail = np.asarray(self.spot_availability)
            n_spot = len(np.asarray(self.spot_idx))
            if avail.ndim != 2 or avail.shape[1] != n_spot:
                raise ValueError(
                    f"TenantSpec {self.name!r}: spot_availability must be a "
                    f"2-D (T', S) array with S == len(spot_idx) == {n_spot}, "
                    f"got shape {avail.shape}")


@dataclass
class TenantReplay:
    """One tenant's replayed history plus its aggregated metrics."""

    spec: TenantSpec
    steps: List[ControllerStep]
    metrics: TenantReplayMetrics
    ca_metrics: Optional[TenantReplayMetrics] = None
    ca_counts: Optional[np.ndarray] = None       # final CA allocation


@dataclass
class FleetReplayResult:
    """Per-tenant histories + fleet rollup. ``solver_traces`` is None
    unless the replay ran with ``capture_solver_trace=True``: then one list
    per tenant of its per-WARM-tick ``PGDTrace`` rows (``ADMMTrace`` rows
    for an MPC replay with ``solver="admm"`` at H > 1; numpy leaves; cold
    ticks run the multistart solver, which is not traced)."""

    tenants: List[TenantReplay]
    metrics: FleetReplayMetrics
    solver_traces: Optional[List[List]] = None


def default_ca_pools(catalog: Catalog, demand: np.ndarray,
                     k: int = 8) -> np.ndarray:
    """The k most cost-efficient single-type covers of ``demand`` — the node
    pools an operator would plausibly configure for this workload. For a
    trace replay ``demand`` is the trace's per-resource peak."""
    K, _, c = catalog.matrices()
    d = np.asarray(demand, np.float64)
    safe_K = np.where(K > 0, K, 1e-9)
    cover = np.max(d[:, None] / safe_K, axis=0)          # units of each type
    covers_all = np.all((K > 0) | (d[:, None] == 0), axis=0)
    cost = np.where(covers_all, cover * c, np.inf)
    order = np.argsort(cost)
    return order[: min(k, int(np.isfinite(cost).sum()))]


def _replay_ca(catalog: Catalog, spec: TenantSpec, pool_idx: np.ndarray,
               expander: str, mode: str):
    """Carry the Cluster-Autoscaler baseline tick to tick over one trace."""
    counts_prev = np.zeros(catalog.n, np.float64)
    tick_metrics: List[AllocationMetrics] = []
    churns: List[float] = []
    for demand in np.asarray(spec.trace, np.float64):
        existing = {int(j): int(counts_prev[j])
                    for j in np.nonzero(counts_prev)[0]}
        pools = default_pools_for(catalog, pool_idx, existing=existing)
        res = simulate_cluster_autoscaler(catalog, pools, demand,
                                          expander=expander, mode=mode)
        churns.append(float(np.abs(res.counts - counts_prev).sum()))
        counts_prev = res.counts
        tick_metrics.append(evaluate(catalog, res.counts, demand))
    return tick_metrics, churns, counts_prev


def _ca_pool_idx(cat: Catalog, spec: TenantSpec) -> np.ndarray:
    """The tenant's CA node-pool types: explicit ``ca_pool_idx``, else pools
    sized from the trace's per-resource peak demand."""
    if spec.ca_pool_idx is not None:
        return spec.ca_pool_idx
    return default_ca_pools(cat, np.asarray(spec.trace, np.float64).max(axis=0))


def _ca_baseline(catalog: Catalog, spec: TenantSpec, ca_expander: str,
                 ca_mode: str):
    """The sequential-oracle CA baseline of one tenant:
    ``(metrics, final counts)``."""
    cat = spec.catalog or catalog
    tick_metrics, churns, ca_counts = _replay_ca(
        cat, spec, _ca_pool_idx(cat, spec), ca_expander, ca_mode)
    return tenant_metrics(f"{spec.name}/ca", tick_metrics, churns), ca_counts


def _replay_ca_fleet(catalog: Catalog, tenants: Sequence[TenantSpec],
                     expander: str, mode: str):
    """The CA baseline of ALL tenants, carried tick to tick at once: tenants
    are grouped by catalog (identity), and each group advances through one
    ``simulate_cluster_autoscaler_batch`` call per tick; a tenant leaves
    its group's active set when its trace ends. Tick-for-tick equal to
    :func:`_ca_baseline` per tenant. Returns one ``(metrics, final
    counts)`` pair per tenant."""
    cats = [spec.catalog or catalog for spec in tenants]
    groups: Dict[int, List[int]] = {}
    for i, cat in enumerate(cats):
        groups.setdefault(id(cat), []).append(i)
    out: List = [None] * len(tenants)
    for idx in groups.values():
        cat = cats[idx[0]]
        traces = [np.asarray(tenants[i].trace, np.float64) for i in idx]
        pool_idx = [_ca_pool_idx(cat, tenants[i]) for i in idx]
        counts = np.zeros((len(idx), cat.n), np.float64)
        tick_metrics: List[List[AllocationMetrics]] = [[] for _ in idx]
        churns: List[List[float]] = [[] for _ in idx]
        for t in range(max(tr.shape[0] for tr in traces)):
            act = [k for k, tr in enumerate(traces) if t < tr.shape[0]]
            demands = np.stack([traces[k][t] for k in act])
            pools_t = []
            for k in act:
                existing = {int(j): int(counts[k, j])
                            for j in np.nonzero(counts[k])[0]}
                pools_t.append(default_pools_for(cat, pool_idx[k],
                                                 existing=existing))
            res = simulate_cluster_autoscaler_batch(cat, pools_t, demands,
                                                    expander=expander,
                                                    mode=mode)
            for k, r in zip(act, res):
                churns[k].append(float(np.abs(r.counts - counts[k]).sum()))
                counts[k] = r.counts
                tick_metrics[k].append(evaluate(cat, r.counts, traces[k][t]))
        for pos, i in enumerate(idx):
            out[i] = (tenant_metrics(f"{tenants[i].name}/ca",
                                     tick_metrics[pos], churns[pos]),
                      counts[pos].copy())
    return out


def _make_controller(catalog: Catalog, spec: TenantSpec,
                     device: torch.device = HOST, use_kernel: bool = True
                     ) -> InfrastructureOptimizationController:
    """One tenant's controller; its problems are built on ``device`` (the
    host for the batched engine, which stacks them)."""
    return InfrastructureOptimizationController(
        catalog=spec.catalog or catalog, delta_max=spec.delta_max,
        params=spec.params, n_starts=spec.n_starts,
        allowed_idx=spec.allowed_idx, terms=spec.terms,
        spot_idx=spec.spot_idx, spot_availability=spec.spot_availability,
        device=device, use_kernel=use_kernel)


def _make_mpc_controller(catalog: Catalog, spec: TenantSpec, *, horizon: int,
                         forecaster: str, forecaster_kwargs: Optional[dict],
                         coupling_w: float, coupling_eps: float,
                         solver_config=None, cold_start: str = "myopic",
                         device: torch.device = HOST,
                         use_kernel: bool = True):
    """One tenant's receding-horizon controller (the MPC counterpart of
    :func:`_make_controller`); the forecaster gets the tenant's own trace
    so ``forecaster="oracle"`` reads that tenant's future. Imported here:
    ``repro_torch.horizon`` stacks its windows with ``fleet.batching``."""
    from ..horizon import ModelPredictiveController, make_forecaster
    fc = make_forecaster(forecaster,
                         trace=np.asarray(spec.trace, np.float64),
                         **(forecaster_kwargs or {}))
    return ModelPredictiveController(
        catalog=spec.catalog or catalog, delta_max=spec.delta_max,
        params=spec.params, n_starts=spec.n_starts,
        allowed_idx=spec.allowed_idx, terms=spec.terms,
        spot_idx=spec.spot_idx, spot_availability=spec.spot_availability,
        device=device, use_kernel=use_kernel,
        horizon=horizon, forecaster=fc,
        coupling_w=coupling_w, coupling_eps=coupling_eps,
        solver_config=solver_config, cold_start=cold_start)


def _assemble_replay(spec: TenantSpec, steps: List[ControllerStep],
                     ca: Optional[Tuple]) -> TenantReplay:
    """Roll one tenant's step history (plus its CA baseline's
    ``(metrics, counts)`` pair, or None) into a TenantReplay."""
    met = tenant_metrics(spec.name, [s.metrics for s in steps],
                         [s.churn for s in steps],
                         churn_violations=[s.churn_violation for s in steps],
                         solver_iters=[s.solver_iters for s in steps])
    ca_met, ca_counts = ca if ca is not None else (None, None)
    return TenantReplay(spec=spec, steps=steps, metrics=met,
                        ca_metrics=ca_met, ca_counts=ca_counts)


def replay_tenant(catalog: Catalog, spec: TenantSpec, *,
                  run_ca_baseline: bool = True,
                  ca_expander: str = "random",
                  ca_mode: str = "wave",
                  use_kernel: bool = True,
                  device: DeviceLike = None) -> TenantReplay:
    """Sequential replay of ONE tenant: a controller solve per tick on
    ``device`` (``use_kernel`` as the controller's) plus, optionally, the
    CA baseline on the same trace."""
    ctl = _make_controller(catalog, spec, resolve_device(device), use_kernel)
    steps = [ctl.step(demand) for demand in np.asarray(spec.trace, np.float64)]
    ca = (_ca_baseline(catalog, spec, ca_expander, ca_mode)
          if run_ca_baseline else None)
    return _assemble_replay(spec, steps, ca)


def _spot_unavailable(spec: TenantSpec, t: int) -> int:
    """Number of this tenant's spot twins interrupted at tick ``t`` (the
    same clamped-row convention the controller's spot overlay uses)."""
    if spec.spot_idx is None or spec.spot_availability is None:
        return 0
    avail = np.asarray(spec.spot_availability)
    return int((avail[min(t, len(avail) - 1)] <= 0.0).sum())


class _TickObserver:
    """Per-tick observation plumbing shared by the replay loops: decides
    once whether anything is watching (a :class:`HealthMonitor` and/or an
    installed ``repro_torch.obs.metrics`` registry), times ticks with the
    monitor's injectable clock, and fans each tick's duration and iteration
    count out to both. When nothing watches, every method is a no-op and no
    clock is read."""

    __slots__ = ("health", "reg", "clock", "active", "_t0")

    def __init__(self, health: Optional[HealthMonitor]):
        self.health = health
        self.reg = obs_metrics.current_metrics()
        self.clock = health.clock if health is not None else time.perf_counter
        self.active = health is not None or self.reg is not None
        self._t0 = 0.0

    def tick_start(self) -> None:
        """Stamp the tick's start time (no-op when nothing watches)."""
        if self.active:
            self._t0 = self.clock()

    def tick_end(self, t: int, solver_iters: int, compile_key=None) -> None:
        """Close the tick: duration to the latency histogram and the
        deadline budget, iteration count to the effort histogram."""
        if not self.active:
            return
        dur_ms = (self.clock() - self._t0) * 1e3
        if self.reg is not None:
            self.reg.histogram("replay/tick_ms").observe(dur_ms)
            self.reg.histogram("replay/solver_iters").observe(solver_iters)
        if self.health is not None:
            self.health.observe_tick(t, dur_ms, compile_key=compile_key)

    def step(self, **kw) -> None:
        """Forward one committed (tenant, tick) to the health monitor."""
        if self.health is not None:
            self.health.observe_step(**kw)


def _replay_sequential(ctls, tenants: Sequence[TenantSpec], controller: str,
                       capture_solver_trace: bool,
                       health: Optional[HealthMonitor] = None,
                       anytime: Optional[AnytimeConfig] = None):
    """The sequential loop: one ``replay/tick`` span per (tenant, tick),
    each tenant's controller stepping through its trace. Returns
    ``(histories, solver_traces)``. With a :class:`HealthMonitor` each
    (tenant, tick) is timed and observed: the tick's problem is built up
    front (``make_problem`` is pure and history has not advanced yet, so it
    is the problem ``step`` solves) and ``last_x_rel`` feeds the KKT
    gauge. ``controller`` ("myopic" or "mpc") names the loop in spans."""
    histories, solver_traces = [], []
    obs = _TickObserver(health)
    for ctl, spec in zip(ctls, tenants):
        ctl.capture_solver_trace = capture_solver_trace
        ctl.anytime = anytime
        steps = []
        for t, demand in enumerate(np.asarray(spec.trace, np.float64)):
            prob = ctl.make_problem(demand) if health is not None else None
            n_tr = len(ctl.solver_traces)
            obs.tick_start()
            tick_key = ("seq_tick", controller, ctl.catalog.n, t > 0,
                        capture_solver_trace,
                        anytime is not None and anytime.enabled)
            with span("replay/tick", cat="replay", tick=t,
                      engine="sequential", controller=controller,
                      tenant=spec.name, compile_key=tick_key):
                step = ctl.step(demand)
                steps.append(step)
            obs.tick_end(t, step.solver_iters, compile_key=tick_key)
            gauge("replay/solver_iters", step.solver_iters)
            solver = ("multistart" if step.replanned
                      else ctl.solver_config.solver if controller == "mpc"
                      else "adaptive")
            obs.step(tenant=spec.name, tick=t, step=step, solver=solver,
                     prob=prob, x_rel=ctl.last_x_rel,
                     trace=(ctl.solver_traces[-1]
                            if len(ctl.solver_traces) > n_tr else None),
                     spot_unavailable=_spot_unavailable(spec, t))
        histories.append(steps)
        solver_traces.append(list(ctl.solver_traces))
    return histories, solver_traces


def _replay_batch_groups(ctls: Sequence[InfrastructureOptimizationController],
                         tenants: Sequence[TenantSpec]
                         ) -> Dict[Tuple, List[int]]:
    """Group tenant indices by (shape bucket, n_starts), once per replay."""
    groups: Dict[Tuple, List[int]] = {}
    for b, (ctl, spec) in enumerate(zip(ctls, tenants)):
        cat = ctl.catalog
        key = bucket_dims(cat.n, len(cat.matrices()[0]),
                          len(cat.providers)) + (spec.n_starts,)
        groups.setdefault(key, []).append(b)
    return groups


class _MyopicLanes:
    """The myopic controller's part of :func:`_replay_fleet_batched`: each
    tick's problem, the warm tick's stack and solve (``solve_fleet_step``
    from the previous counts, or from the previous relaxed solution with
    ``warm_start="relaxed"``), and what a lane keeps after its commit."""

    controller = "myopic"

    def __init__(self, catalog: Catalog, tenants: Sequence[TenantSpec],
                 warm_start: str, solver_steps: int):
        self.ctls = [_make_controller(catalog, spec) for spec in tenants]
        self.relaxed = warm_start == "relaxed"
        self.solver_steps = solver_steps
        # previous tick's RELAXED solution per tenant (warm_start="relaxed")
        self.x_rel_prev: List[Optional[np.ndarray]] = [None] * len(tenants)

    def problem(self, b: int, demand: np.ndarray):
        """Tenant ``b``'s problem of this tick."""
        return self.ctls[b].make_problem(demand)

    def cold_counts(self, idx, res, X_int, n_true) -> List[np.ndarray]:
        """Each lane's cold commit: its best rounded start."""
        return [X_int[i, :n] for i, n in enumerate(n_true)]

    def warm(self, idx, key, probs, active, delta, need_rel, solve_kw):
        """Stack the bucket's tick problems and solve its warm tick:
        ``(res, X_rel)``, X_rel the relaxed solution on the host where a
        warm start or ``need_rel`` uses it (else None)."""
        n_pad, m_pad, p_pad, _ = key
        with span("replay/stack", cat="replay", bucket=str(key)):
            batch = stack_problems([probs[b] for b in idx], n_max=n_pad,
                                   m_max=m_pad, p_max=p_pad, active=active,
                                   device=solve_kw["device"])
        X_cur = embed_solutions(batch, [self.ctls[b].x_current for b in idx])
        X_init = None
        if self.relaxed and self.x_rel_prev[idx[0]] is not None:
            X_init = embed_solutions(batch, [self.x_rel_prev[b] for b in idx])
        with span("replay/solve", cat="replay", bucket=str(key),
                  compile_key=("solve_fleet_step", key, len(idx),
                               solve_kw["capture_trace"],
                               solve_kw["anytime"] is not None)) as sp:
            res = solve_fleet_step(batch, X_cur, delta, x_init=X_init,
                                   steps=self.solver_steps, **solve_kw)
            sp.fence(res.x_int)
        return res, (res.x.cpu().numpy() if self.relaxed or need_rel
                     else None)

    def committed(self, b: int, i: int, x: np.ndarray,
                  x_rel: Optional[np.ndarray], cold: bool) -> None:
        """Keep lane ``i`` (tenant ``b``)'s relaxed solution as its next
        warm start."""
        if self.relaxed:
            self.x_rel_prev[b] = x_rel

    def solver(self, cold: bool) -> str:
        """The engine the health monitor records for a commit."""
        return "multistart" if cold else "adaptive"


class _MPCLanes:
    """The receding-horizon controller's part of
    :func:`_replay_fleet_batched`. A tick's problem is tick 0 of the
    tenant's H-tick window (observed demand and forecasts, built on the
    host by its controller). The warm tick stacks the bucket's windows at
    its dims and union term signature, B·H problems lane-major in one
    ``stack_windows`` call, and solves them in one
    ``solve_horizon_fleet_step`` (engine and budget from
    ``solver_config``; ``hot_loop="vmap"`` solves every window alone at
    its true shape). Each lane keeps its relaxed plan for the next warm
    start. With ``cold_start="window"`` the cold tick's per-start rounded
    candidates are re-ranked by each tenant's whole window, as the
    sequential controller ranks them."""

    controller = "mpc"
    relaxed = False       # the warm start is the shifted plan

    def __init__(self, catalog: Catalog, tenants: Sequence[TenantSpec],
                 mpc_kwargs: dict, use_kernel: bool):
        self.ctls = [_make_mpc_controller(catalog, spec, **mpc_kwargs)
                     for spec in tenants]
        self.horizon = mpc_kwargs["horizon"]
        self.cold_start = mpc_kwargs["cold_start"]
        self.coupling = (mpc_kwargs["coupling_w"], mpc_kwargs["coupling_eps"])
        # every controller of the replay shares one config
        self.cfg = self.ctls[0].solver_config
        self.use_kernel = use_kernel
        self.windows: List = [None] * len(tenants)
        self.plans: Optional[np.ndarray] = None   # the last warm bucket's

    def problem(self, b: int, demand: np.ndarray):
        """Tenant ``b``'s window of this tick; returns its tick 0."""
        ctl = self.ctls[b]
        self.windows[b] = ctl.window_problems(ctl.window_demands(demand))
        return self.windows[b][0]

    def cold_counts(self, idx, res, X_int, n_true) -> List[np.ndarray]:
        """Each lane's cold commit: the best rounded start, or with
        ``cold_start="window"`` the start its window ranks first."""
        if self.cold_start != "window":
            return [X_int[i, :n] for i, n in enumerate(n_true)]
        from ..horizon import select_window_candidate, window_candidate_scores
        cand_all = res.x_int_all.cpu().numpy().astype(np.float64)
        feas_all = res.feas_int_all.cpu().numpy()
        out = []
        for i, (b, n) in enumerate(zip(idx, n_true)):
            cands = cand_all[i, :, :n]
            scores = window_candidate_scores(self.windows[b], cands,
                                             self.use_kernel,
                                             res.x_int.device)
            out.append(cands[select_window_candidate(scores, feas_all[i])])
        return out

    def warm(self, idx, key, probs, active, delta, need_rel, solve_kw):
        """Stack the bucket's windows and solve its warm tick: ``(res,
        X_rel)``, X_rel the committed tick's relaxed row of each lane's
        plan (the plans stay on ``self.plans``)."""
        from ..horizon import solve_horizon_fleet_step, stack_windows
        n_pad, m_pad, p_pad, _ = key
        H = self.horizon
        with span("replay/stack", cat="replay", bucket=str(key)):
            wins = [self.windows[b] for b in idx]
            hp = stack_windows(wins, coupling_w=self.coupling[0],
                               coupling_eps=self.coupling[1], n_max=n_pad,
                               m_max=m_pad, p_max=p_pad,
                               term_kinds=union_term_kinds(
                                   [w[0] for w in wins]),
                               device=solve_kw["device"])
            X_cur = np.zeros((len(idx), n_pad), np.float32)
            X_init = np.zeros((len(idx), H, n_pad), np.float32)
            for i, b in enumerate(idx):
                n_true = probs[b].n
                X_cur[i, :n_true] = self.ctls[b].x_current
                X_init[i, :, :n_true] = self.ctls[b].shifted_plan()
            dims = tuple(np.asarray([getattr(w[0], f) for w in wins],
                                    np.int64) for f in ("n", "m", "p"))
        with span("replay/solve", cat="replay", bucket=str(key),
                  compile_key=("solve_horizon_fleet_step", key, len(idx), H,
                               solve_kw["capture_trace"],
                               solve_kw["anytime"] is not None)) as sp:
            res = solve_horizon_fleet_step(hp, X_cur, delta, x_init=X_init,
                                           active=active, cfg=self.cfg,
                                           dims=dims, **solve_kw)
            sp.fence(res.x_int)
        self.plans = res.plan.cpu().numpy().astype(np.float64)
        return res, self.plans[:, 0]

    def committed(self, b: int, i: int, x: np.ndarray,
                  x_rel: Optional[np.ndarray], cold: bool) -> None:
        """Keep tenant ``b``'s plan: the cold counts held over the window,
        or lane ``i``'s relaxed plan."""
        self.ctls[b].plan = (np.tile(x, (self.horizon, 1)) if cold
                             else self.plans[i, :, :len(x)])

    def solver(self, cold: bool) -> str:
        """The engine the health monitor records for a commit."""
        return "multistart" if cold else self.cfg.solver


def _replay_fleet_batched(lanes, tenants: Sequence[TenantSpec], *,
                          hot_loop: str, device: torch.device,
                          capture_solver_trace: bool = False,
                          health: Optional[HealthMonitor] = None,
                          anytime: Optional[AnytimeConfig] = None):
    """Step ALL tenants through their traces with one batched solve per
    shape bucket per tick; ``lanes`` (:class:`_MyopicLanes` or
    :class:`_MPCLanes`) holds the controllers and their part of the tick.
    Returns ``(histories, solver_traces)``.

    Tick 0 is the cold ``solve_fleet`` from per-tenant starts at true
    shape (seed 0), every later tick the controller's warm solve. Frozen
    tenants keep their last problem so stacked shapes stay put (their
    results are discarded). Each tick is a ``replay/tick`` span over
    per-bucket ``replay/stack`` / ``replay/solve`` / ``replay/round``
    spans (solve spans fenced, with a compile key per program and bucket).
    A :class:`HealthMonitor` observes every committed (tenant, tick) —
    counts, the relaxed solution for the KKT gauge (certified on
    ``device``), the trace for stall detection — and the FLEET tick's
    duration against its deadline budget."""
    ctls = lanes.ctls
    traces = [np.asarray(spec.trace, np.float64) for spec in tenants]
    T_len = np.asarray([tr.shape[0] for tr in traces])
    groups = _replay_batch_groups(ctls, tenants)
    # each tenant's problem of the CURRENT tick
    probs: List = [None] * len(tenants)
    solver_traces: List[List] = [[] for _ in tenants]
    obs = _TickObserver(health)
    timed = anytime is not None and anytime.enabled
    solve_kw = dict(hot_loop=hot_loop, device=device,
                    capture_trace=capture_solver_trace,
                    anytime=anytime if timed else None)

    for t in range(int(T_len.max())):
        obs.tick_start()
        cold = t == 0
        # ticks 0 (the cold program) and 1 (the first warm one) are each
        # the first sighting of their key
        tick_key = ("tick", "batched", lanes.controller, min(t, 1))
        with span("replay/tick", cat="replay", tick=t, engine="batched",
                  controller=lanes.controller, compile_key=tick_key):
            tick_iters = 0
            for b in range(len(ctls)):
                if t < T_len[b]:
                    probs[b] = lanes.problem(b, traces[b][t])
            for key, idx in sorted(groups.items()):
                n_pad, m_pad, p_pad, n_starts = key
                active = T_len[idx] > t                 # (Bk,) liveness
                if not active.any():
                    continue    # whole bucket expired: nothing left to solve
                n_true = [probs[b].n for b in idx]
                if cold:
                    with span("replay/stack", cat="replay", bucket=str(key)):
                        batch = stack_problems([probs[b] for b in idx],
                                               n_max=n_pad, m_max=m_pad,
                                               p_max=p_pad, active=active,
                                               device=device)
                    # per-tenant starts at true shape, seed 0
                    with span("replay/solve", cat="replay", bucket=str(key),
                              compile_key=("solve_fleet", key, len(idx)),
                              cold=True) as sp:
                        starts = make_fleet_starts(batch, n_starts, seed=0)
                        res = solve_fleet(batch, starts=starts,
                                          hot_loop=hot_loop, device=device)
                        sp.fence(res.x_int)
                    lane_iters = np.zeros(len(idx), np.int64)
                    tick_iters += int(res.iters)
                    bucket_hit = False
                    # the relaxed solution crosses to the host only where
                    # it is used: the warm start or the KKT gauge
                    X_rel = (res.x.cpu().numpy()
                             if lanes.relaxed or health is not None
                             else None)
                else:
                    delta = np.asarray([tenants[b].delta_max for b in idx],
                                       np.float32)
                    res, X_rel = lanes.warm(idx, key, probs, active, delta,
                                            health is not None, solve_kw)
                    lane_iters = res.iters.cpu().numpy()
                    tick_iters += int(lane_iters.sum())
                    bucket_hit = bool(res.deadline_hit or False)
                X_int = res.x_int.cpu().numpy().astype(np.float64)
                xs = (lanes.cold_counts(idx, res, X_int, n_true) if cold
                      else [X_int[i, :n] for i, n in enumerate(n_true)])
                batch_tr = getattr(res, "trace", None)
                lane_tr = (None if batch_tr is None
                           else [f.cpu().numpy() for f in batch_tr])
                batch_diag = getattr(res, "diag", None)
                lane_diag = (None if batch_diag is None
                             else [f.cpu().numpy() for f in batch_diag])
                with span("replay/round", cat="replay", bucket=str(key)):
                    for i, b in enumerate(idx):
                        if not active[i]:
                            continue  # frozen: no churn, no metrics, no state
                        n = n_true[i]
                        x_rel = None if X_rel is None else X_rel[i, :n]
                        step = ctls[b].apply_counts(
                            traces[b][t], xs[i], replanned=cold,
                            solver_iters=int(lane_iters[i]),
                            deadline_hit=bucket_hit)
                        lanes.committed(b, i, xs[i], x_rel, cold)
                        tr_b = (None if lane_tr is None else
                                type(batch_tr)(*(f[i] for f in lane_tr)))
                        if tr_b is not None:
                            solver_traces[b].append(tr_b)
                        if health is not None:
                            obs.step(tenant=tenants[b].name, tick=t,
                                     step=step, solver=lanes.solver(cold),
                                     lane=i,
                                     prob=problem_to(probs[b], device),
                                     x_rel=x_rel, trace=tr_b,
                                     diag=(None if lane_diag is None else
                                           type(batch_diag)(
                                               *(f[i] for f in lane_diag))),
                                     spot_unavailable=_spot_unavailable(
                                         tenants[b], t))
            gauge("replay/solver_iters", tick_iters)
        obs.tick_end(t, tick_iters, compile_key=tick_key)
    return [ctl.history for ctl in ctls], solver_traces


def replay_fleet(catalog: Catalog, tenants: Sequence[TenantSpec], *,
                 replay_mode: str = "sequential",
                 controller: str = "myopic",
                 horizon: int = 8,
                 forecaster: str = "last_value",
                 forecaster_kwargs: Optional[dict] = None,
                 coupling_w: Optional[float] = None,
                 coupling_eps: Optional[float] = None,
                 solver_config=None,
                 cold_start: str = "myopic",
                 run_oracle_baseline: bool = False,
                 run_ca_baseline: bool = True,
                 ca_engine: str = "vectorized",
                 ca_expander: str = "random",
                 ca_mode: str = "wave",
                 warm_start: str = "counts",
                 solver_steps: int = 600,
                 hot_loop: str = "kernel",
                 capture_solver_trace: bool = False,
                 health: Optional[HealthMonitor] = None,
                 anytime: Optional[AnytimeConfig] = None,
                 device: DeviceLike = None) -> FleetReplayResult:
    """Replay every tenant; returns per-tenant histories + fleet aggregates.

    The defaults are the reference's. ``replay_mode="sequential"`` steps
    one controller per tenant, one solve per tenant per tick;
    ``"batched"`` one solve per shape bucket per tick (module docstring).

    ``controller="myopic"`` is the paper's loop (each tick solves for the
    current demand under the L1 churn bound); ``"mpc"`` the receding-
    horizon controller (``repro_torch.horizon``): each tick forecasts
    ``horizon`` ticks with ``forecaster`` (a ``horizon.forecast`` kind,
    ``forecaster_kwargs`` forwarded, the tenant's own trace supplied so
    ``"oracle"`` works), solves the time-expanded program with smoothed
    churn coupling (``coupling_w`` / ``coupling_eps``, default
    ``horizon.problem``'s), and commits tick 0; ``horizon=1`` commits the
    myopic controller's allocations exactly. ``solver_config`` (a
    ``horizon.HorizonSolverConfig``: "adaptive", "fixed" or "admm", its
    budget and weights; default one with ``solver_steps`` steps) and
    ``cold_start`` ("myopic" or "window") are MPC-only, and so is
    ``run_oracle_baseline``: the same fleet and controller replayed once
    more under the oracle forecaster, its metrics on
    ``FleetReplayMetrics.oracle`` for ``regret_vs_oracle``.
    ``run_ca_baseline`` also replays the Cluster-
    Autoscaler baseline on the same traces (``FleetReplayMetrics.baseline``):
    ``ca_engine="vectorized"`` steps every tenant at once per tick,
    ``"sequential"`` loops the per-tenant oracle; ``ca_expander`` and
    ``ca_mode`` are ``simulate_cluster_autoscaler``'s ``expander`` and
    ``mode``. ``warm_start`` picks the
    warm tick's start: the previous integer allocation (``"counts"``) or the
    previous relaxed solution (``"relaxed"``); ``solver_steps`` is each
    warm tick's PGD budget. Both are the batched engine's: the sequential
    controller warm-starts from its counts with the default 600 steps.
    ``hot_loop="kernel"`` evaluates eq. (1) with the CUDA kernel on the card
    at every tick; ``"ref"`` runs the plain PyTorch eq. (1) at every tick
    instead (in the reference it picks only the cold solve's engine), so a
    whole replay can be compared with the kernel's; ``"vmap"`` solves each
    tenant alone with the kernel, the batched engine's equivalence mode.
    In the sequential engine ``"ref"`` gives the controllers
    ``use_kernel=False`` and the other two ``use_kernel=True``.

    ``capture_solver_trace=True`` records every warm tick's PGD convergence
    rows (``FleetReplayResult.solver_traces``); the traced solves commit
    the same allocations. ``health`` (a ``repro_torch.obs.HealthMonitor``)
    observes the optimizer replay — breach counters, KKT residuals of the
    committed relaxed solutions, stalls, non-finite guards, tick times
    against its observe-only budget — and its report lands on
    ``FleetReplayMetrics.health``; run inside ``collect_metrics()`` to fill
    the ``replay/tick_ms`` and ``replay/solver_iters`` histograms too.
    ``anytime`` (an ``AnytimeConfig`` with ``deadline_ms``) truncates every
    WARM solve at its deadline and deploys the best-so-far feasible
    iterate, marking the step's ``deadline_hit`` (every lane of a truncated
    bucket solve); cold ticks are never truncated. Anytime and
    ``capture_solver_trace`` exclude each other, and an MPC replay under
    a deadline needs the adaptive engine. With MPC, ``hot_loop`` acts as
    with the myopic controller: "kernel" and "ref" pick eq. (1)'s route at
    every tick, "vmap" solves each tenant's window alone in the batched
    engine."""
    if len(tenants) == 0:
        raise ValueError("replay_fleet needs at least one TenantSpec; got an "
                         "empty tenant list")
    if replay_mode not in ("sequential", "batched"):
        raise ValueError(f"unknown replay_mode {replay_mode!r}")
    if controller not in ("myopic", "mpc"):
        raise ValueError(f"unknown controller {controller!r}")
    if warm_start not in ("counts", "relaxed"):
        raise ValueError(f"unknown warm_start {warm_start!r}")
    if ca_engine not in ("vectorized", "sequential"):
        raise ValueError(f"unknown ca_engine {ca_engine!r}")
    if anytime is not None and anytime.enabled and capture_solver_trace:
        raise ValueError("anytime deadlines and capture_solver_trace are "
                         "mutually exclusive; drop one")
    if run_oracle_baseline and controller != "mpc":
        raise ValueError("run_oracle_baseline compares a forecast-driven MPC "
                         "replay against its oracle-forecast twin; it "
                         'requires controller="mpc"')
    dev = resolve_device(device)
    use_kernel = _use_kernel(hot_loop)
    if controller == "mpc":
        from ..horizon import (DEFAULT_COUPLING_EPS, DEFAULT_COUPLING_W,
                               HorizonSolverConfig)
        coupling_w = DEFAULT_COUPLING_W if coupling_w is None else coupling_w
        coupling_eps = (DEFAULT_COUPLING_EPS if coupling_eps is None
                        else coupling_eps)
        if solver_config is None:
            solver_config = HorizonSolverConfig(steps=solver_steps)
        mpc_kwargs = dict(horizon=horizon, forecaster=forecaster,
                          forecaster_kwargs=forecaster_kwargs,
                          coupling_w=coupling_w, coupling_eps=coupling_eps,
                          solver_config=solver_config, cold_start=cold_start)
    if replay_mode == "sequential":
        ctls = [_make_mpc_controller(catalog, spec, device=dev,
                                     use_kernel=use_kernel, **mpc_kwargs)
                if controller == "mpc"
                else _make_controller(catalog, spec, dev, use_kernel)
                for spec in tenants]
        histories, traces_out = _replay_sequential(
            ctls, tenants, controller, capture_solver_trace, health=health,
            anytime=anytime)
    else:
        lanes = (_MPCLanes(catalog, tenants, mpc_kwargs, use_kernel)
                 if controller == "mpc"
                 else _MyopicLanes(catalog, tenants, warm_start, solver_steps))
        histories, traces_out = _replay_fleet_batched(
            lanes, tenants, hot_loop=hot_loop, device=dev,
            capture_solver_trace=capture_solver_trace, health=health,
            anytime=anytime)
    if not run_ca_baseline:
        cas = [None] * len(tenants)
    elif ca_engine == "vectorized":
        cas = _replay_ca_fleet(catalog, tenants, ca_expander, ca_mode)
    else:
        cas = [_ca_baseline(catalog, spec, ca_expander, ca_mode)
               for spec in tenants]
    oracle_metrics = None
    if run_oracle_baseline:  # the oracle twin is a baseline: never traced
        oracle = replay_fleet(catalog, tenants, replay_mode=replay_mode,
                              controller="mpc", horizon=horizon,
                              forecaster="oracle", coupling_w=coupling_w,
                              coupling_eps=coupling_eps,
                              solver_config=solver_config,
                              cold_start=cold_start,
                              run_ca_baseline=False, warm_start=warm_start,
                              solver_steps=solver_steps, hot_loop=hot_loop,
                              device=dev)
        oracle_metrics = [r.metrics for r in oracle.tenants]
    with span("replay/metrics", cat="replay"):
        replays = [_assemble_replay(spec, steps, ca)
                   for spec, steps, ca in zip(tenants, histories, cas)]
        metrics = FleetReplayMetrics(
            tenants=[r.metrics for r in replays],
            baseline=([r.ca_metrics for r in replays]
                      if run_ca_baseline else None),
            replay_mode=replay_mode, controller=controller,
            oracle=oracle_metrics,
            health=health.report() if health is not None else None)
    return FleetReplayResult(
        tenants=replays, metrics=metrics,
        solver_traces=traces_out if capture_solver_trace else None)
