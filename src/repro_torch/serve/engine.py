"""Anytime online allocation service — port of ``repro.serve.engine``.

``replay_fleet`` replays *recorded* traces — every tenant's whole demand
stream is known up front and ticks take as long as the solver takes. A
*serving* loop faces the opposite regime: demand arrives asynchronously,
tenants register and depart while the system is live, and each decision
tick has a wall-clock budget it must respect NOW, not on average. This
module is that loop.

:class:`ServeEngine` owns a fixed-capacity bank of ``capacity`` batch
lanes over one shared catalog — the serving analogue of a single
``repro_torch.fleet`` shape bucket. Because every lane always participates in
the tick's batched solve at the same padded shape, the solve's shapes
never change while the service is live: a tenant departing frees its lane,
and a later joiner reactivates that lane with a fresh cold solve and a
fresh warm-start lineage — the mid-replay extension of the frozen-lane
liveness masks (``FleetBatch.active``) the replay engines use for ragged
traces. Lanes are independent in the solver's lane loop, so a join/depart
never perturbs any other tenant's allocation.

Each :meth:`ServeEngine.tick`:

1. stamps the tick's start on the injectable ``clock``;
2. cold-solves lanes that joined since the last tick (multistart, exactly
   the controller's first step, every lane at the catalog's shape);
3. runs ONE batched anytime ``solve_fleet_step`` over the lanes holding
   fresh demand, with the tick's REMAINING wall budget as the enforced
   ``core.pgd.AnytimeConfig`` deadline — so a tick that spent most of its
   budget on cold joins truncates the warm solve harder, and every
   returned allocation is the chunked solve's best-so-far feasible
   iterate rather than a blown deadline;
4. commits each decision through the lane controller's ``apply_counts``
   (same state machine as the replay engines) and records one
   :class:`DecisionRecord` per decided tenant — latency, deadline hit,
   solver iterations, staleness — into the attached
   :class:`repro_torch.obs.HealthMonitor` and ``repro_torch.obs.metrics``
   registry.

Tenants whose demand did NOT change this tick keep their allocation and
age: ``staleness`` is the number of ticks since a tenant's allocation was
last recomputed — the serving-side cost axis traded against the objective.

On the card every eq. (1) evaluation of a tick — the cold joins'
multistart, the warm solve's chunks and its rounding — runs in the
``alloc_objective`` kernel; ``hot_loop="ref"`` runs the plain PyTorch
eq. (1) throughout instead, so a whole session can be compared with its
plain twin. ``device=None`` means ``"cuda"``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np

from ..core.catalog import Catalog
from ..core.controller import (ControllerStep,
                               InfrastructureOptimizationController)
from ..core.pgd import AnytimeConfig
from ..core.problem import PenaltyParams
from ..device import DeviceLike, resolve_device
from ..fleet.batching import stack_problems
from ..fleet.solver import _use_kernel, solve_fleet_step
from ..obs import metrics as obs_metrics
from ..obs.health import HealthMonitor
from ..obs.telemetry import span

__all__ = ["DecisionRecord", "ServeEngine", "ServeSummary",
           "MIN_SOLVE_BUDGET_MS"]

# floor on the warm solve's anytime budget: even a tick that is already
# over budget when the batched solve starts must run at least one chunk
# (the alternative — serving the stale allocation — is what staleness
# already measures; a *requested* decision always gets a best-effort one)
MIN_SOLVE_BUDGET_MS = 0.05


@dataclass
class DecisionRecord:
    """One committed serving decision with its latency provenance.

    ``latency_ms`` is the whole TICK's wall time (every decision in a tick
    shares the batched solve, so per-tenant latency IS tick latency);
    ``deadline_hit`` marks the anytime budget truncating the solve;
    ``staleness`` is how many ticks this tenant's allocation had gone
    without recomputation before this decision; ``cold`` marks join-tick
    multistart decisions (never truncated — there is no previous
    allocation to fall back on)."""

    tick: int
    tenant: str
    lane: int
    latency_ms: float
    deadline_hit: bool
    solver_iters: int
    staleness: int
    feasible: bool
    objective: float
    cold: bool = False


@dataclass
class ServeSummary:
    """Roll-up of a serving session's decision records."""

    ticks: int
    decisions: int
    deadline_ms: Optional[float]
    p50_latency_ms: float
    p99_latency_ms: float
    miss_rate: float              # share of DECIDED ticks over wall budget
    truncated_rate: float         # share of decisions the solver truncated
    mean_staleness: float
    max_staleness: int

    def to_dict(self) -> Dict:
        return {"ticks": self.ticks, "decisions": self.decisions,
                "deadline_ms": self.deadline_ms,
                "p50_latency_ms": self.p50_latency_ms,
                "p99_latency_ms": self.p99_latency_ms,
                "miss_rate": self.miss_rate,
                "truncated_rate": self.truncated_rate,
                "mean_staleness": self.mean_staleness,
                "max_staleness": self.max_staleness}


@dataclass
class _Lane:
    """One batch lane's tenant binding (None fields when the lane is free).

    The lane keeps its LAST problem when its tenant departs so the stacked
    batch never changes shape; a freed lane's solve result is masked out
    by the liveness mask exactly like a replay engine's expired tenant."""

    controller: Optional[InfrastructureOptimizationController] = None
    name: Optional[str] = None
    pending: Optional[np.ndarray] = None      # latest unserved demand
    prob: Optional[object] = None             # lane's current problem
    last_update_tick: int = -1
    joined_tick: int = -1
    needs_cold: bool = False


class ServeEngine:
    """Event-driven anytime allocation server over ``capacity`` batch lanes
    (module docstring has the full contract).

    Knobs: ``deadline_ms`` — per-TICK wall budget enforced on the batched
    warm solve via ``core.pgd.AnytimeConfig`` (None serves untruncated,
    the replay engine's warm solve); ``chunk_iters`` — anytime chunk
    granularity; ``solver_steps`` — warm solve's full iteration budget;
    ``clock`` — injectable monotonic-seconds source shared by tick timing
    and the anytime loop (deterministic tests inject a fake);
    ``health`` — optional :class:`repro_torch.obs.HealthMonitor` observing
    every decision and tick (first-sighting ticks excluded from its
    deadline budget via the serve tick's compile key); ``hot_loop`` —
    ``"kernel"`` (eq. (1) in the CUDA kernel on the card) or ``"ref"``
    (plain PyTorch everywhere), as ``replay_fleet``'s; ``device`` — where
    problems live and solves run (None means "cuda")."""

    def __init__(self, catalog: Catalog, capacity: int, *,
                 deadline_ms: Optional[float] = None,
                 chunk_iters: int = 32,
                 delta_max: float = 8.0,
                 n_starts: int = 4,
                 solver_steps: int = 600,
                 params: Optional[PenaltyParams] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 health: Optional[HealthMonitor] = None,
                 hot_loop: str = "kernel",
                 device: DeviceLike = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.hot_loop = hot_loop
        self.use_kernel = _use_kernel(hot_loop)
        self.device = resolve_device(device)
        self.catalog = catalog
        self.capacity = int(capacity)
        self.deadline_ms = deadline_ms
        self.chunk_iters = int(chunk_iters)
        self.delta_max = float(delta_max)
        self.n_starts = int(n_starts)
        self.solver_steps = int(solver_steps)
        self.params = params
        self.clock = clock
        self.health = health
        self.tick_count = 0
        self.records: List[DecisionRecord] = []
        self._lanes = [_Lane() for _ in range(self.capacity)]
        self._by_name: Dict[str, int] = {}
        # free lanes hold this placeholder problem so the stacked batch
        # keeps its shape; their solve results are masked out
        ctl = self._make_controller()
        self._placeholder_prob = ctl.make_problem(
            np.ones(len(catalog.matrices()[0]), np.float64))

    # -- tenant lifecycle ---------------------------------------------------

    def _make_controller(self) -> InfrastructureOptimizationController:
        return InfrastructureOptimizationController(
            catalog=self.catalog, delta_max=self.delta_max,
            params=self.params, n_starts=self.n_starts, device=self.device,
            use_kernel=self.use_kernel)

    def register(self, name: str, demand: Optional[np.ndarray] = None) -> int:
        """Bind ``name`` to a free lane (reusing departed tenants' lanes —
        batch shapes never change). The first allocation is computed by the
        next :meth:`tick`'s cold multistart solve; ``demand`` (optional
        here) or a later :meth:`submit` supplies it. Returns the lane."""
        if name in self._by_name:
            raise ValueError(f"tenant {name!r} is already registered "
                             f"(lane {self._by_name[name]})")
        for i, lane in enumerate(self._lanes):
            if lane.controller is None:
                break
        else:
            raise ValueError(
                f"service is at capacity ({self.capacity} lanes); "
                f"{name!r} must wait for a departure")
        # fresh controller = fresh warm-start lineage: nothing of the
        # departed tenant's state leaks into the joiner's solves
        self._lanes[i] = _Lane(controller=self._make_controller(), name=name,
                               pending=(None if demand is None
                                        else np.asarray(demand, np.float64)),
                               prob=self._lanes[i].prob,
                               joined_tick=self.tick_count, needs_cold=True)
        self._by_name[name] = i
        return i

    def depart(self, name: str) -> None:
        """Release ``name``'s lane. The lane keeps its last problem (shape
        stability) but drops all tenant state; a later :meth:`register`
        may reuse it with a fresh cold start."""
        i = self._require(name)
        self._lanes[i] = _Lane(prob=self._lanes[i].prob)
        del self._by_name[name]

    def submit(self, name: str, demand: np.ndarray) -> None:
        """Queue ``name``'s latest demand (latest-wins: a tenant that
        submits twice between ticks is served its NEWEST demand — serving
        a superseded demand would spend the budget on a stale answer)."""
        i = self._require(name)
        self._lanes[i].pending = np.asarray(demand, np.float64)

    def tenants(self) -> List[str]:
        """Currently registered tenant names (lane order)."""
        return [ln.name for ln in self._lanes if ln.name is not None]

    def allocation(self, name: str) -> Optional[np.ndarray]:
        """``name``'s current committed allocation (None before its first
        decided tick)."""
        ctl = self._lanes[self._require(name)].controller
        return None if ctl.x_current is None else ctl.x_current.copy()

    def _require(self, name: str) -> int:
        if name not in self._by_name:
            raise KeyError(f"unknown tenant {name!r}; registered: "
                           f"{sorted(self._by_name)}")
        return self._by_name[name]

    # -- the decision tick --------------------------------------------------

    def tick(self) -> List[DecisionRecord]:
        """Run one decision tick: cold-solve joiners, then one batched
        anytime solve over every lane with fresh demand (module docstring
        steps 1-4). Returns this tick's records (also appended to
        ``self.records``). Lanes with no fresh demand keep their
        allocation and age their staleness; an empty tick (no pending
        demand anywhere) is a cheap no-op that still advances the tick
        counter."""
        t = self.tick_count
        self.tick_count += 1
        t0 = self.clock()
        records: List[DecisionRecord] = []

        cold = [i for i, ln in enumerate(self._lanes)
                if ln.needs_cold and ln.pending is not None]
        warm = [i for i, ln in enumerate(self._lanes)
                if ln.controller is not None and not ln.needs_cold
                and ln.pending is not None]
        tick_key = ("serve_tick", bool(cold), bool(warm))

        with span("serve/tick", cat="serve", tick=t, compile_key=tick_key):
            # cold joins: per-lane multistart (all lanes share the catalog
            # shape); each ends in a host read of its counts
            for i in cold:
                ln = self._lanes[i]
                demand, ln.pending = ln.pending, None
                ln.prob = ln.controller.make_problem(demand)
                with span("serve/cold", cat="serve", tenant=ln.name):
                    step = ln.controller.step(demand)
                ln.needs_cold = False
                records.append(self._record(t, i, ln, step, t0, cold=True))

            if warm:
                self._warm_solve(t, warm, t0, records)

        dur_ms = (self.clock() - t0) * 1e3
        for rec in records:   # every decision in a tick shares its latency
            rec.latency_ms = dur_ms
        reg = obs_metrics.current_metrics()
        if reg is not None and records:
            reg.histogram("serve/decision_ms").observe(dur_ms)
            for rec in records:
                reg.histogram("serve/staleness").observe(rec.staleness)
        if self.health is not None and records:
            self.health.observe_tick(t, dur_ms, compile_key=tick_key)
        self.records.extend(records)
        return records

    def _warm_solve(self, t: int, warm: List[int], t0: float,
                    records: List[DecisionRecord]) -> None:
        """One batched anytime ``solve_fleet_step`` over the lanes holding
        fresh demand; every other lane rides along masked-out so the
        solve's shape never changes."""
        probs, demands = [], {}
        warm_set = set(warm)
        active = np.zeros(self.capacity, bool)
        X_cur = np.zeros((self.capacity, self.catalog.n), np.float32)
        for i, ln in enumerate(self._lanes):
            if i in warm_set:
                demand, ln.pending = ln.pending, None
                demands[i] = demand
                ln.prob = ln.controller.make_problem(demand)
                active[i] = True
            if ln.controller is not None and ln.controller.x_current is not None:
                X_cur[i] = ln.controller.x_current
            probs.append(ln.prob if ln.prob is not None
                         else self._placeholder_prob)
        batch = stack_problems(probs, active=active, device=self.device)
        anytime = None
        if self.deadline_ms is not None:
            # the warm solve gets what is LEFT of the tick's budget after
            # cold joins (floored: a requested decision is always computed);
            # the cold joins' counts were read on the host, so the device
            # has finished their work when the clock is read
            spent_ms = (self.clock() - t0) * 1e3
            anytime = AnytimeConfig(
                deadline_ms=max(self.deadline_ms - spent_ms,
                                MIN_SOLVE_BUDGET_MS),
                chunk_iters=self.chunk_iters, clock=self.clock)
        with span("serve/solve", cat="serve",
                  compile_key=("serve_solve", self.capacity, self.catalog.n,
                               anytime is not None)):
            res = solve_fleet_step(batch, X_cur, self.delta_max,
                                   steps=self.solver_steps, anytime=anytime,
                                   hot_loop=self.hot_loop, device=self.device)
        hit = bool(res.deadline_hit or False)
        X_int = res.x_int.cpu().numpy().astype(np.float64)
        lane_iters = res.iters.cpu().numpy().astype(np.int64)
        X_rel = res.x.cpu().numpy().astype(np.float64)
        for i in warm:
            ln = self._lanes[i]
            step = ln.controller.apply_counts(
                demands[i], X_int[i], replanned=False,
                solver_iters=int(lane_iters[i]), deadline_hit=hit)
            ln.controller.last_x_rel = X_rel[i]
            records.append(self._record(t, i, ln, step, t0))

    def _record(self, t: int, lane: int, ln: _Lane, step: ControllerStep,
                t0: float, cold: bool = False) -> DecisionRecord:
        staleness = (0 if cold or ln.last_update_tick < 0
                     else t - ln.last_update_tick)
        ln.last_update_tick = t
        rec = DecisionRecord(
            tick=t, tenant=ln.name, lane=lane,
            latency_ms=(self.clock() - t0) * 1e3,   # finalized at tick end
            deadline_hit=step.deadline_hit,
            solver_iters=step.solver_iters, staleness=staleness,
            feasible=bool(step.metrics.satisfied),
            objective=float(step.metrics.total_cost), cold=cold)
        if self.health is not None:
            self.health.observe_step(
                tenant=ln.name, tick=t, step=step,
                solver="multistart" if cold else "adaptive", lane=lane,
                prob=ln.prob, x_rel=ln.controller.last_x_rel)
        return rec

    # -- reading back -------------------------------------------------------

    def summary(self) -> ServeSummary:
        """Percentile roll-up of every decision so far (see
        :class:`ServeSummary`). An engine with no decisions reports
        zeroed percentiles."""
        recs = self.records
        if not recs:
            return ServeSummary(ticks=self.tick_count, decisions=0,
                                deadline_ms=self.deadline_ms,
                                p50_latency_ms=0.0, p99_latency_ms=0.0,
                                miss_rate=0.0, truncated_rate=0.0,
                                mean_staleness=0.0, max_staleness=0)
        # one latency sample per DECIDED tick (records in a tick share it)
        by_tick = {}
        for r in recs:
            by_tick[r.tick] = r.latency_ms
        lats = np.asarray(sorted(by_tick.values()), np.float64)
        miss = (0.0 if self.deadline_ms is None
                else float((lats > self.deadline_ms).mean()))
        stal = np.asarray([r.staleness for r in recs], np.float64)
        return ServeSummary(
            ticks=self.tick_count, decisions=len(recs),
            deadline_ms=self.deadline_ms,
            p50_latency_ms=float(np.percentile(lats, 50)),
            p99_latency_ms=float(np.percentile(lats, 99)),
            miss_rate=miss,
            truncated_rate=float(np.mean([r.deadline_hit for r in recs])),
            mean_staleness=float(stal.mean()),
            max_staleness=int(stal.max()))
