"""Trace-driven fleet replay — port of ``repro.fleet.replay``'s two
engines with the myopic controller.

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
allocation. Not ported yet: the MPC controller (``controller="mpc"``
raises ``NotImplementedError``).
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
from .batching import bucket_dims, embed_solutions, stack_problems
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
    per tenant of its per-WARM-tick ``PGDTrace`` rows (numpy leaves; cold
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


def _replay_sequential(ctls, tenants: Sequence[TenantSpec],
                       capture_solver_trace: bool,
                       health: Optional[HealthMonitor] = None,
                       anytime: Optional[AnytimeConfig] = None):
    """The sequential loop: one ``replay/tick`` span per (tenant, tick),
    each tenant's controller stepping through its trace. Returns
    ``(histories, solver_traces)``. With a :class:`HealthMonitor` each
    (tenant, tick) is timed and observed: the tick's problem is built up
    front (``make_problem`` is pure and history has not advanced yet, so it
    is the problem ``step`` solves) and ``last_x_rel`` feeds the KKT
    gauge."""
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
            tick_key = ("seq_tick", "myopic", ctl.catalog.n, t > 0,
                        capture_solver_trace,
                        anytime is not None and anytime.enabled)
            with span("replay/tick", cat="replay", tick=t,
                      engine="sequential", controller="myopic",
                      tenant=spec.name, compile_key=tick_key):
                step = ctl.step(demand)
                steps.append(step)
            obs.tick_end(t, step.solver_iters, compile_key=tick_key)
            gauge("replay/solver_iters", step.solver_iters)
            obs.step(tenant=spec.name, tick=t, step=step,
                     solver="multistart" if step.replanned else "adaptive",
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


def _replay_fleet_batched(catalog: Catalog, tenants: Sequence[TenantSpec], *,
                          warm_start: str, solver_steps: int, hot_loop: str,
                          device: torch.device,
                          capture_solver_trace: bool = False,
                          health: Optional[HealthMonitor] = None,
                          anytime: Optional[AnytimeConfig] = None):
    """Step ALL tenants through their traces with one batched solve per
    shape bucket per tick. Returns ``(histories, solver_traces)``.

    Each tick is a ``replay/tick`` span over per-bucket ``replay/stack`` /
    ``replay/solve`` / ``replay/round`` spans (solve spans fenced, with a
    compile key per program and bucket). A :class:`HealthMonitor` observes
    every committed (tenant, tick) — counts, the relaxed solution for the
    KKT gauge (certified on ``device``), the trace for stall detection —
    and the FLEET tick's duration against its deadline budget."""
    traces = [np.asarray(spec.trace, np.float64) for spec in tenants]
    T_len = np.asarray([tr.shape[0] for tr in traces])
    ctls = [_make_controller(catalog, spec) for spec in tenants]
    groups = _replay_batch_groups(ctls, tenants)
    # previous tick's RELAXED solution per tenant (warm_start="relaxed")
    x_rel_prev: List[Optional[np.ndarray]] = [None] * len(tenants)
    # each tenant's problem of the CURRENT tick; frozen tenants keep their
    # last one so stacked shapes stay put (its solve result is discarded)
    probs: List = [None] * len(tenants)
    solver_traces: List[List] = [[] for _ in tenants]
    obs = _TickObserver(health)
    timed = anytime is not None and anytime.enabled

    for t in range(int(T_len.max())):
        obs.tick_start()
        # ticks 0 (the cold program) and 1 (the first warm one) are each
        # the first sighting of their key
        tick_key = ("tick", "batched", "myopic", min(t, 1))
        with span("replay/tick", cat="replay", tick=t, engine="batched",
                  controller="myopic", compile_key=tick_key):
            tick_iters = 0
            for b, ctl in enumerate(ctls):
                if t < T_len[b]:
                    probs[b] = ctl.make_problem(traces[b][t])
            for key, idx in sorted(groups.items()):
                n_pad, m_pad, p_pad, n_starts = key
                active = T_len[idx] > t                 # (Bk,) liveness
                if not active.any():
                    continue    # whole bucket expired: nothing left to solve
                with span("replay/stack", cat="replay", bucket=str(key)):
                    batch = stack_problems([probs[b] for b in idx],
                                           n_max=n_pad, m_max=m_pad,
                                           p_max=p_pad, active=active,
                                           device=device)
                if t == 0:
                    # cold start: per-tenant starts at true shape, seed 0
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
                else:
                    X_cur = embed_solutions(
                        batch, [ctls[b].x_current for b in idx])
                    X_init = None
                    if (warm_start == "relaxed"
                            and x_rel_prev[idx[0]] is not None):
                        X_init = embed_solutions(
                            batch, [x_rel_prev[b] for b in idx])
                    delta = np.asarray([tenants[b].delta_max for b in idx],
                                       np.float32)
                    with span("replay/solve", cat="replay", bucket=str(key),
                              compile_key=("solve_fleet_step", key, len(idx),
                                           capture_solver_trace,
                                           timed)) as sp:
                        res = solve_fleet_step(
                            batch, X_cur, delta, x_init=X_init,
                            steps=solver_steps, hot_loop=hot_loop,
                            device=device, capture_trace=capture_solver_trace,
                            anytime=anytime)
                        sp.fence(res.x_int)
                    lane_iters = res.iters.cpu().numpy()
                    tick_iters += int(lane_iters.sum())
                    bucket_hit = bool(res.deadline_hit or False)
                X_int = res.x_int.cpu().numpy().astype(np.float64)
                # the relaxed solution crosses to the host only where it is
                # used: the warm start or the health monitor's KKT gauge
                X_rel = (res.x.cpu().numpy()
                         if warm_start == "relaxed" or health is not None
                         else None)
                batch_tr = getattr(res, "trace", None)
                lane_tr = (None if batch_tr is None
                           else [f.cpu().numpy() for f in batch_tr])
                with span("replay/round", cat="replay", bucket=str(key)):
                    for i, b in enumerate(idx):
                        if not active[i]:
                            continue  # frozen: no churn, no metrics, no state
                        n_true = int(batch.n_true[i])
                        step = ctls[b].apply_counts(
                            traces[b][t], X_int[i, :n_true],
                            replanned=(t == 0),
                            solver_iters=int(lane_iters[i]),
                            deadline_hit=bucket_hit)
                        tr_b = (None if lane_tr is None else
                                type(batch_tr)(*(f[i] for f in lane_tr)))
                        if tr_b is not None:
                            solver_traces[b].append(tr_b)
                        if X_rel is not None and warm_start == "relaxed":
                            x_rel_prev[b] = X_rel[i, :n_true]
                        if health is not None:
                            obs.step(tenant=tenants[b].name, tick=t,
                                     step=step,
                                     solver=("multistart" if t == 0
                                             else "adaptive"),
                                     lane=i,
                                     prob=problem_to(probs[b], device),
                                     x_rel=X_rel[i, :n_true], trace=tr_b,
                                     spot_unavailable=_spot_unavailable(
                                         tenants[b], t))
            gauge("replay/solver_iters", tick_iters)
        obs.tick_end(t, tick_iters, compile_key=tick_key)
    return [ctl.history for ctl in ctls], solver_traces


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet")


def replay_fleet(catalog: Catalog, tenants: Sequence[TenantSpec], *,
                 replay_mode: str = "sequential",
                 controller: str = "myopic",
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

    The port runs both engines with the myopic controller; the defaults
    are the reference's, and what is not ported yet raises
    ``NotImplementedError``. ``replay_mode="sequential"`` steps one
    controller per tenant, one solve per tenant per tick;
    ``"batched"`` one solve per shape bucket per tick (module docstring).
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
    ``capture_solver_trace`` exclude each other."""
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
    if controller == "mpc":
        raise _not_ported('controller="mpc"')
    dev = resolve_device(device)
    if replay_mode == "sequential":
        use_kernel = _use_kernel(hot_loop)
        ctls = [_make_controller(catalog, spec, dev, use_kernel)
                for spec in tenants]
        histories, traces_out = _replay_sequential(
            ctls, tenants, capture_solver_trace, health=health,
            anytime=anytime)
    else:
        histories, traces_out = _replay_fleet_batched(
            catalog, tenants, warm_start=warm_start,
            solver_steps=solver_steps, hot_loop=hot_loop, device=dev,
            capture_solver_trace=capture_solver_trace, health=health,
            anytime=anytime)
    if not run_ca_baseline:
        cas = [None] * len(tenants)
    elif ca_engine == "vectorized":
        cas = _replay_ca_fleet(catalog, tenants, ca_expander, ca_mode)
    else:
        cas = [_ca_baseline(catalog, spec, ca_expander, ca_mode)
               for spec in tenants]
    with span("replay/metrics", cat="replay"):
        replays = [_assemble_replay(spec, steps, ca)
                   for spec, steps, ca in zip(tenants, histories, cas)]
        metrics = FleetReplayMetrics(
            tenants=[r.metrics for r in replays],
            baseline=([r.ca_metrics for r in replays]
                      if run_ca_baseline else None),
            replay_mode=replay_mode, controller=controller,
            health=health.report() if health is not None else None)
    return FleetReplayResult(
        tenants=replays, metrics=metrics,
        solver_traces=traces_out if capture_solver_trace else None)
