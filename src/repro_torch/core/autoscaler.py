"""A copy of ``repro.core.autoscaler`` (numpy only; tests pin it equal).

Kubernetes Cluster Autoscaler baseline simulator (paper §IV.A.2).

Reproduces the CA constraints the paper compares against:
  * scaling restricted to predefined node pools,
  * no dynamic instance-type selection outside pools,
  * homogeneous scaling within each pool,
  * scale-up driven by unschedulable demand, scale-down of underutilized
    nodes where removal keeps demand satisfied.

Pure numpy — the baseline does not need (and the paper's does not have)
accelerated math.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from .catalog import Catalog, M


@dataclass
class NodePool:
    """One CA node pool: a single instance type with count bounds — the
    unit of homogeneous scaling the paper's baseline is restricted to."""

    instance_idx: int            # index into the catalog
    count: int = 0               # current nodes
    min_count: int = 0
    max_count: int = 10_000


@dataclass
class CAResult:
    """Cluster-Autoscaler simulation outcome for one demand snapshot."""

    counts: np.ndarray           # (n,) integer allocation over catalog types
    cost: float
    iterations: int
    satisfied: bool


def _provided(K: np.ndarray, counts: np.ndarray) -> np.ndarray:
    return K @ counts


def simulate_cluster_autoscaler(
    catalog: Catalog,
    pools: Sequence[NodePool],
    demand: np.ndarray,
    max_iters: int = 100_000,
    expander: str = "random",
    scale_down: str = "utilization",
    mode: str = "wave",
    seed: int = 0,
) -> CAResult:
    """Greedy CA loop: while some resource is unschedulable, scale up a pool
    that can schedule the bottleneck resource, then run the scale-down pass.

    ``expander`` mirrors the real Cluster Autoscaler's ``--expander`` flag:
      * "random"      — CA's DEFAULT: any pool that can schedule the pending
                        demand, chosen uniformly (paper-comparable baseline).
      * "least-waste" — CA's optional smarter expander (a strong baseline;
                        reported separately in benchmarks).
      * "first-fit"   — priority expander: first pool in listed order.

    ``scale_down``:
      * "utilization" — CA semantics: remove a node only if it is below the
                        50% utilization threshold w.r.t. residual demand and
                        removal keeps everything schedulable.
      * "greedy"      — remove most-expensive nodes while feasible (stronger
                        than real CA).
      * "none"

    ``mode``:
      * "wave"        — CA semantics (paper §IV.A.2): one scaling event picks
                        ONE pool and scales it homogeneously until the whole
                        pending demand fits (or the pool caps out). This is
                        the behavior that produces the paper's pathological
                        over-provisioning on asymmetric workloads.
      * "incremental" — re-pick the pool after every single node added (a
                        much stronger baseline than real CA; reported
                        separately in benchmarks).
    """
    K, _, c = catalog.matrices()
    n = catalog.n
    rng = np.random.default_rng(seed)
    counts = np.zeros(n, np.float64)
    for pool in pools:
        counts[pool.instance_idx] += pool.count

    # Aggregate caps per instance type: several pools may share a type (e.g.
    # per-zone pools of one machine family) and their counts/min_counts are
    # already summed, so the headroom must be the SUM of max_counts too.
    pool_caps: dict = {}
    for p in pools:
        pool_caps[p.instance_idx] = pool_caps.get(p.instance_idx, 0) + p.max_count
    it = 0
    while it < max_iters:
        it += 1
        deficit = demand - _provided(K, counts)
        if np.all(deficit <= 1e-9):
            break
        r_star = int(np.argmax(deficit / np.maximum(demand, 1e-9)))
        # candidate pools that provide r_star and have headroom
        cands = []
        for p in pools:
            j = p.instance_idx
            if K[r_star, j] <= 0 or counts[j] + 1 > pool_caps[j]:
                continue
            cands.append(j)
        if not cands:
            break  # nothing scalable — demand unsatisfiable in this pool set
        if expander == "random":
            best_j = int(rng.choice(cands))
        elif expander == "first-fit":
            best_j = cands[0]
        elif expander == "least-waste":
            best_j, best_waste = None, np.inf
            for j in cands:
                add = K[:, j]
                used = np.minimum(add, np.maximum(deficit, 0.0))
                waste = 1.0 - (used.sum() / max(add.sum(), 1e-9))
                if waste < best_waste - 1e-12:
                    best_waste, best_j = waste, j
        else:
            raise ValueError(f"unknown expander {expander!r}")
        if mode == "wave":
            # homogeneous scale-up of the chosen pool until the full pending
            # demand fits in it (or it caps out)
            while counts[best_j] + 1 <= pool_caps[best_j]:
                counts[best_j] += 1
                if np.all(demand - _provided(K, counts) <= 1e-9):
                    break
        else:
            counts[best_j] += 1

    if scale_down != "none":
        order = np.argsort(-c)
        changed = True
        while changed:
            changed = False
            for j in order:
                floor_j = sum(p.min_count for p in pools if p.instance_idx == j)
                while counts[j] > floor_j:
                    trial = counts.copy()
                    trial[j] -= 1
                    if not np.all(_provided(K, trial) >= demand - 1e-9):
                        break
                    if scale_down == "utilization":
                        # CA removes only under-utilized nodes: the node's
                        # contribution must be <50% needed given the rest.
                        surplus = _provided(K, counts) - demand
                        node_used = np.minimum(K[:, j], np.maximum(K[:, j] - surplus, 0.0))
                        util = node_used.sum() / max(K[:, j].sum(), 1e-9)
                        if util >= 0.5:
                            break
                    counts = trial
                    changed = True

    satisfied = bool(np.all(_provided(K, counts) >= demand - 1e-9))
    return CAResult(counts=counts, cost=float(c @ counts), iterations=it,
                    satisfied=satisfied)


def simulate_cluster_autoscaler_batch(
    catalog: Catalog,
    pools: Sequence,
    demands: np.ndarray,
    max_iters: int = 100_000,
    expander: str = "random",
    scale_down: str = "utilization",
    mode: str = "wave",
    seed: int = 0,
) -> List[CAResult]:
    """Vectorized CA: step B tenants' simulations in lockstep over one shared
    catalog, returning exactly what B :func:`simulate_cluster_autoscaler`
    calls would (the sequential simulator stays the test oracle —
    the port's tests sweep both and assert equal counts).

    ``pools`` is either one pool list shared by every tenant or a sequence of
    B per-tenant pool lists; ``demands`` is (B, m). Each tenant draws from
    its own ``default_rng(seed)`` stream in the same order as its sequential
    run, so ``expander="random"`` matches too.

    The heavy inner work — deficit evaluation during scale-up and the
    feasibility/utilization checks during scale-down — runs as ONE numpy
    matmul over all still-active tenants per lockstep iteration, instead of a
    Python loop of per-tenant matvecs. Tenants that finish (satisfied, capped
    out, or converged scale-down) drop out of the active set; finished-tenant
    rows are never recomputed. Wave-mode scale-up uses a closed-form unit
    count verified against the sequential one-node-at-a-time predicate, so
    pathological cap-out waves cost O(1) matvecs instead of O(max_count)."""
    K, _, c = catalog.matrices()
    n = catalog.n
    demands = np.asarray(demands, np.float64)
    assert demands.ndim == 2, "demands must be (B, m)"
    B = demands.shape[0]
    if B > 0 and (len(pools) == 0 or isinstance(pools[0], NodePool)):
        pools = [pools] * B
    assert len(pools) == B, (len(pools), B)

    counts = np.zeros((B, n), np.float64)
    caps = np.zeros((B, n), np.float64)
    floors = np.zeros((B, n), np.float64)
    pool_js: List[List[int]] = []
    for b, ps in enumerate(pools):
        for p in ps:
            counts[b, p.instance_idx] += p.count
            caps[b, p.instance_idx] += p.max_count   # aggregated, as sequential
            floors[b, p.instance_idx] += p.min_count
        pool_js.append([int(p.instance_idx) for p in ps])
    rngs = [np.random.default_rng(seed) for _ in range(B)]

    def _fits(b: int, j: int, u: float) -> bool:
        """The sequential wave predicate, fresh matvec included."""
        trial = counts[b].copy()
        trial[j] += u
        return bool(np.all(demands[b] - _provided(K, trial) <= 1e-9))

    # ---- scale-up: lockstep over tenants still scaling ----------------------
    it = np.zeros(B, np.int64)
    done = np.zeros(B, bool)
    while True:
        act = np.nonzero(~done & (it < max_iters))[0]
        if act.size == 0:
            break
        it[act] += 1
        deficit = demands[act] - counts[act] @ K.T               # (A, m)
        sat = np.all(deficit <= 1e-9, axis=1)
        done[act[sat]] = True
        r_star = np.argmax(deficit / np.maximum(demands[act], 1e-9), axis=1)
        for a, b in enumerate(act):
            if sat[a]:
                continue
            r = int(r_star[a])
            cands = [j for j in pool_js[b]
                     if K[r, j] > 0 and counts[b, j] + 1 <= caps[b, j]]
            if not cands:
                done[b] = True       # nothing scalable — unsatisfiable
                continue
            if expander == "random":
                best_j = int(rngs[b].choice(cands))
            elif expander == "first-fit":
                best_j = cands[0]
            elif expander == "least-waste":
                best_j, best_waste = None, np.inf
                for j in cands:
                    add = K[:, j]
                    used = np.minimum(add, np.maximum(deficit[a], 0.0))
                    waste = 1.0 - (used.sum() / max(add.sum(), 1e-9))
                    if waste < best_waste - 1e-12:
                        best_waste, best_j = waste, j
            else:
                raise ValueError(f"unknown expander {expander!r}")
            if mode == "wave":
                # closed-form unit count for "add nodes until the pending
                # demand fits or the pool caps out", then verify/adjust with
                # the sequential predicate (guards the 1e-9 boundary ulps)
                head = int(caps[b, best_j] - counts[b, best_j])
                kj = K[:, best_j]
                if np.any((kj <= 0) & (deficit[a] > 1e-9)):
                    u = head                     # never fits: cap out
                else:
                    need = (deficit[a] - 1e-9) / np.where(kj > 0, kj, np.inf)
                    u = int(min(max(np.ceil(need.max()), 1.0), head))
                while u < head and not _fits(b, best_j, u):
                    u += 1
                while u > 1 and _fits(b, best_j, u - 1):
                    u -= 1
                counts[b, best_j] += u
            else:
                counts[b, best_j] += 1

    # ---- scale-down: lockstep sweeps until no tenant changes ----------------
    if scale_down != "none":
        order = np.argsort(-c)
        while True:
            changed = np.zeros(B, bool)
            for j in order:
                # only tenants actually holding removable nodes of type j
                # (as sequential's `counts[j] > floor_j` gate, hoisted so
                # unheld types cost no matmul at all)
                live = np.nonzero(counts[:, j] > floors[:, j])[0]
                if not live.size:
                    continue
                kj = K[:, j]
                kj_sum = max(kj.sum(), 1e-9)
                while live.size:
                    sub = counts[live]
                    provided = sub @ K.T
                    trial = sub.copy()
                    trial[:, j] -= 1.0
                    ok = ((sub[:, j] > floors[live, j])
                          & np.all(trial @ K.T >= demands[live] - 1e-9, axis=1))
                    if scale_down == "utilization":
                        surplus = provided - demands[live]
                        node_used = np.minimum(
                            kj[None, :], np.maximum(kj[None, :] - surplus, 0.0))
                        ok &= node_used.sum(axis=1) / kj_sum < 0.5
                    live = live[ok]
                    counts[live, j] -= 1.0
                    changed[live] = True
            if not changed.any():
                break

    provided = counts @ K.T
    satisfied = np.all(provided >= demands - 1e-9, axis=1)
    costs = counts @ c
    return [CAResult(counts=counts[b].copy(), cost=float(costs[b]),
                     iterations=int(it[b]), satisfied=bool(satisfied[b]))
            for b in range(B)]


def default_pools_for(catalog: Catalog, idxs: Sequence[int],
                      existing: Optional[dict] = None,
                      max_count: int = 10_000) -> List[NodePool]:
    """Wrap catalog indices as NodePools, seeding counts from an
    ``existing`` {index: count} deployment (replay carries these forward)."""
    existing = existing or {}
    return [NodePool(instance_idx=int(j), count=int(existing.get(int(j), 0)),
                     max_count=max_count) for j in idxs]
