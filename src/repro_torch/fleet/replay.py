"""Trace-driven fleet replay — port of ``repro.fleet.replay``'s batched
engine with the myopic controller.

``replay_fleet(catalog, tenants, replay_mode="batched",
run_ca_baseline=False)`` steps every tenant through its demand trace with
one batched solve per shape bucket per tick: tick 0 is a cold
``solve_fleet`` (per-tenant starts drawn at true shape, seed 0), every
later tick a warm ``solve_fleet_step`` from the previous tick's
allocation under each tenant's L1 churn bound. Tenants are grouped once
into power-of-two shape buckets (``bucket_dims``) plus ``n_starts``.
Ragged traces freeze a finished tenant in its batch lane: its last
allocation stays as a fixed warm start and it records no more history.

Controllers build each tick's per-tenant problem on the host;
``stack_problems`` moves each bucket's stack to the device in one copy
per leaf, and the solve runs there.

Not ported yet (each raises ``NotImplementedError``): the sequential
engine, the MPC controller, the Cluster-Autoscaler baseline, health
monitoring, anytime deadlines, solver-trace capture and telemetry spans.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.catalog import Catalog
from ..core.catalog import M as RESOURCE_DIM
from ..core.controller import (ControllerStep,
                               InfrastructureOptimizationController)
from ..core.problem import PenaltyParams
from ..device import DeviceLike, resolve_device
from .batching import bucket_dims, embed_solutions, stack_problems
from .metrics import FleetReplayMetrics, TenantReplayMetrics, tenant_metrics
from .solver import make_fleet_starts, solve_fleet, solve_fleet_step

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


@dataclass
class FleetReplayResult:
    """Per-tenant histories + fleet rollup."""

    tenants: List[TenantReplay]
    metrics: FleetReplayMetrics


def _make_controller(catalog: Catalog, spec: TenantSpec
                     ) -> InfrastructureOptimizationController:
    return InfrastructureOptimizationController(
        catalog=spec.catalog or catalog, delta_max=spec.delta_max,
        params=spec.params, n_starts=spec.n_starts,
        allowed_idx=spec.allowed_idx, terms=spec.terms,
        spot_idx=spec.spot_idx, spot_availability=spec.spot_availability,
        device=HOST)


def _assemble_replay(spec: TenantSpec, steps: List[ControllerStep]
                     ) -> TenantReplay:
    """Roll one tenant's step history into a TenantReplay."""
    met = tenant_metrics(spec.name, [s.metrics for s in steps],
                         [s.churn for s in steps],
                         churn_violations=[s.churn_violation for s in steps],
                         solver_iters=[s.solver_iters for s in steps])
    return TenantReplay(spec=spec, steps=steps, metrics=met)


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
                 warm_start: str = "counts",
                 solver_steps: int = 600,
                 hot_loop: str = "kernel",
                 capture_solver_trace: bool = False,
                 health=None,
                 anytime=None,
                 device: DeviceLike = None) -> FleetReplayResult:
    """Replay every tenant; returns per-tenant histories + fleet aggregates.

    The port runs ``replay_mode="batched"`` with the myopic controller and
    ``run_ca_baseline=False``; the defaults are the reference's, and what is
    not ported yet raises ``NotImplementedError``. ``warm_start`` picks the
    warm tick's start: the previous integer allocation (``"counts"``) or the
    previous relaxed solution (``"relaxed"``). ``solver_steps`` is each
    warm tick's PGD budget. ``hot_loop="kernel"`` evaluates eq. (1) with
    the CUDA kernel on the card at every tick; ``"ref"`` runs the plain
    PyTorch eq. (1) at every tick instead (in the reference it picks only
    the cold solve's engine), so a whole replay can be compared with the
    kernel's."""
    if len(tenants) == 0:
        raise ValueError("replay_fleet needs at least one TenantSpec; got an "
                         "empty tenant list")
    if replay_mode not in ("sequential", "batched"):
        raise ValueError(f"unknown replay_mode {replay_mode!r}")
    if controller not in ("myopic", "mpc"):
        raise ValueError(f"unknown controller {controller!r}")
    if warm_start not in ("counts", "relaxed"):
        raise ValueError(f"unknown warm_start {warm_start!r}")
    if replay_mode == "sequential":
        raise _not_ported('replay_mode="sequential"')
    if controller == "mpc":
        raise _not_ported('controller="mpc"')
    if run_ca_baseline:
        raise _not_ported("run_ca_baseline=True (the Cluster-Autoscaler "
                          "baseline)")
    if capture_solver_trace:
        raise _not_ported("capture_solver_trace=True")
    if health is not None:
        raise _not_ported("health monitoring")
    if anytime is not None:
        raise _not_ported("anytime deadlines")
    dev = resolve_device(device)
    histories = _replay_fleet_batched(catalog, tenants, warm_start=warm_start,
                                      solver_steps=solver_steps,
                                      hot_loop=hot_loop, device=dev)
    replays = [_assemble_replay(spec, steps)
               for spec, steps in zip(tenants, histories)]
    metrics = FleetReplayMetrics(tenants=[r.metrics for r in replays],
                                 replay_mode=replay_mode,
                                 controller=controller)
    return FleetReplayResult(tenants=replays, metrics=metrics)
