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
device in one copy per leaf, and the solve runs there.

The Cluster-Autoscaler baseline runs on the host (numpy, as in the
reference and the paper) over the same traces. Each tenant's node pools
are sized from its trace's PER-RESOURCE PEAK demand
(``trace.max(axis=0)``): pools sized from one tick could not schedule the
peak of a ramp or a flash crowd, and the baseline's phantom SLO misses
would inflate the savings. By default the whole baseline fleet steps
through ``simulate_cluster_autoscaler_batch``, one call per tick per
distinct catalog; ``ca_engine="sequential"`` loops the per-tenant oracle,
and the two agree tick for tick.

Not ported yet (each raises ``NotImplementedError``): the MPC controller,
health monitoring, anytime deadlines, solver-trace capture and telemetry
spans.
"""
from __future__ import annotations

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
from ..core.problem import PenaltyParams
from ..device import DeviceLike, resolve_device
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
    """Per-tenant histories + fleet rollup."""

    tenants: List[TenantReplay]
    metrics: FleetReplayMetrics


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
                          device: torch.device):
    """Step ALL tenants through their traces with one batched solve per
    shape bucket per tick; returns the per-tenant step histories."""
    traces = [np.asarray(spec.trace, np.float64) for spec in tenants]
    T_len = np.asarray([tr.shape[0] for tr in traces])
    ctls = [_make_controller(catalog, spec) for spec in tenants]
    groups = _replay_batch_groups(ctls, tenants)
    # previous tick's RELAXED solution per tenant (warm_start="relaxed")
    x_rel_prev: List[Optional[np.ndarray]] = [None] * len(tenants)
    # each tenant's problem of the CURRENT tick; frozen tenants keep their
    # last one so stacked shapes stay put (its solve result is discarded)
    probs: List = [None] * len(tenants)

    for t in range(int(T_len.max())):
        for b, ctl in enumerate(ctls):
            if t < T_len[b]:
                probs[b] = ctl.make_problem(traces[b][t])
        for key, idx in sorted(groups.items()):
            n_pad, m_pad, p_pad, n_starts = key
            active = T_len[idx] > t                 # (Bk,) liveness
            if not active.any():
                continue    # whole bucket expired: nothing left to solve
            batch = stack_problems([probs[b] for b in idx], n_max=n_pad,
                                   m_max=m_pad, p_max=p_pad, active=active,
                                   device=device)
            if t == 0:
                # cold start: per-tenant starts at true shape, seed 0
                starts = make_fleet_starts(batch, n_starts, seed=0)
                res = solve_fleet(batch, starts=starts, hot_loop=hot_loop,
                                  device=device)
                lane_iters = np.zeros(len(idx), np.int64)
            else:
                X_cur = embed_solutions(
                    batch, [ctls[b].x_current for b in idx])
                X_init = None
                if warm_start == "relaxed" and x_rel_prev[idx[0]] is not None:
                    X_init = embed_solutions(batch,
                                             [x_rel_prev[b] for b in idx])
                delta = np.asarray([tenants[b].delta_max for b in idx],
                                   np.float32)
                res = solve_fleet_step(batch, X_cur, delta, x_init=X_init,
                                       steps=solver_steps, hot_loop=hot_loop,
                                       device=device)
                lane_iters = res.iters.cpu().numpy()
            X_int = res.x_int.cpu().numpy().astype(np.float64)
            X_rel = res.x.cpu().numpy() if warm_start == "relaxed" else None
            for i, b in enumerate(idx):
                if not active[i]:
                    continue  # frozen: no churn, no metrics, no state
                n_true = int(batch.n_true[i])
                ctls[b].apply_counts(traces[b][t], X_int[i, :n_true],
                                     replanned=(t == 0),
                                     solver_iters=int(lane_iters[i]))
                if X_rel is not None:
                    x_rel_prev[b] = X_rel[i, :n_true]
    return [ctl.history for ctl in ctls]


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
                 health=None,
                 anytime=None,
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
    ``use_kernel=False`` and the other two ``use_kernel=True``."""
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
    if controller == "mpc":
        raise _not_ported('controller="mpc"')
    if capture_solver_trace:
        raise _not_ported("capture_solver_trace=True")
    if health is not None:
        raise _not_ported("health monitoring")
    if anytime is not None:
        raise _not_ported("anytime deadlines")
    dev = resolve_device(device)
    if replay_mode == "sequential":   # the reference's loop, no observers
        use_kernel = _use_kernel(hot_loop)
        histories = [replay_tenant(catalog, spec, run_ca_baseline=False,
                                   use_kernel=use_kernel, device=dev).steps
                     for spec in tenants]
    else:
        histories = _replay_fleet_batched(
            catalog, tenants, warm_start=warm_start,
            solver_steps=solver_steps, hot_loop=hot_loop, device=dev)
    if not run_ca_baseline:
        cas = [None] * len(tenants)
    elif ca_engine == "vectorized":
        cas = _replay_ca_fleet(catalog, tenants, ca_expander, ca_mode)
    else:
        cas = [_ca_baseline(catalog, spec, ca_expander, ca_mode)
               for spec in tenants]
    replays = [_assemble_replay(spec, steps, ca)
               for spec, steps, ca in zip(tenants, histories, cas)]
    metrics = FleetReplayMetrics(
        tenants=[r.metrics for r in replays],
        baseline=([r.ca_metrics for r in replays]
                  if run_ca_baseline else None),
        replay_mode=replay_mode, controller=controller)
    return FleetReplayResult(tenants=replays, metrics=metrics)
