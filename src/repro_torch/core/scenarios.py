"""A copy of ``repro.core.scenarios`` (numpy only; tests pin it equal).

The paper's five evaluation scenarios (§IV.D), built over the synthetic
catalogs with the exact demand vectors from the text.

Each scenario yields: the demand vector, the optimizer's allowed-type mask,
the CA node pools, and any pre-existing allocation (applied to both sides,
as in the paper's harness).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from .autoscaler import NodePool, default_pools_for
from .catalog import Catalog, make_cloud_catalog


@dataclass
class Scenario:
    """One paper evaluation setup (§IV.B): a demand vector, the optimizer's
    approved types, the CA's node pools, and any pre-existing deployment."""

    name: str
    title: str
    demand: np.ndarray                       # (4,) cpu, mem, net, storage
    allowed_idx: Optional[np.ndarray]        # optimizer's allowed types (None = all)
    pools: List[NodePool]                    # CA node pools
    existing: np.ndarray                     # (n,) counts pre-deployed


def _existing_vec(n: int, items: Dict[int, int]) -> np.ndarray:
    v = np.zeros(n, np.float64)
    for j, k in items.items():
        v[j] = k
    return v


def _pick(catalog: Catalog, pred: Callable, k: int, sort_key=None) -> np.ndarray:
    idx = catalog.select(pred)
    if sort_key is not None:
        idx = idx[np.argsort([sort_key(catalog.instances[j]) for j in idx],
                             kind="stable")]
    return idx[:k]


def build_scenarios(catalog: Optional[Catalog] = None) -> List[Scenario]:
    """The paper's five scenarios (basic web app, enterprise migration,
    high-performance batch, storage-heavy, mixed) over ``catalog``."""
    cat = catalog or make_cloud_catalog()
    n = cat.n
    inst = cat.instances

    scenarios: List[Scenario] = []

    # ---- 1. Basic web application (greenfield) ----------------------------
    d1 = np.array([8, 16, 4, 100], np.float64)
    # CA: standard general-purpose types available in a new cluster
    # (burstable + general families — the defaults a fresh cluster offers)
    gp = np.concatenate([
        _pick(cat, lambda t: t.provider == "azure" and t.family in ("B", "D")
              and t.cpu in (2, 4, 8), 8, sort_key=lambda t: t.hourly_price),
        _pick(cat, lambda t: t.provider == "linode"
              and t.family in ("nanode", "standard")
              and t.cpu in (2, 4, 8), 8, sort_key=lambda t: t.hourly_price),
    ])
    scenarios.append(Scenario(
        name="s1_greenfield", title="Basic Web Application (Greenfield)",
        demand=d1, allowed_idx=None,
        pools=default_pools_for(cat, gp), existing=_existing_vec(n, {})))

    # ---- 2. Scaling with existing infrastructure --------------------------
    d2 = np.array([16, 32, 8, 200], np.float64)
    small_az = _pick(cat, lambda t: t.provider == "azure" and 2 <= t.cpu <= 4
                     and t.family in ("B", "D"), 2, sort_key=lambda t: t.hourly_price)
    small_li = _pick(cat, lambda t: t.provider == "linode" and 2 <= t.cpu <= 4
                     and t.family == "standard", 2, sort_key=lambda t: t.hourly_price)
    existing2 = _existing_vec(n, {int(small_az[0]): 2, int(small_li[0]): 1})
    pools2 = default_pools_for(cat, np.concatenate([small_az, small_li]),
                               existing={int(small_az[0]): 2, int(small_li[0]): 1})
    scenarios.append(Scenario(
        name="s2_scaling", title="Scaling with Existing Infrastructure",
        demand=d2, allowed_idx=None, pools=pools2, existing=existing2))

    # ---- 3. Enterprise fixed node pools ------------------------------------
    # Approved lists in enterprises standardize on a SPREAD of families
    # (incl. premium/confidential SKUs), not the cheapest types — pick
    # min/median/max-price representatives per size category & provider.
    d3 = np.array([24, 64, 12, 300], np.float64)

    def _spread(pred, prov, k):
        idx = cat.select(lambda t, pred=pred, prov=prov: t.provider == prov and pred(t))
        idx = idx[np.argsort([inst[j].hourly_price for j in idx], kind="stable")]
        if len(idx) == 0:
            return idx
        picks = np.unique(np.linspace(0, len(idx) - 1, k).astype(int))
        return idx[picks]

    small = np.concatenate([_spread(lambda t: 2 <= t.cpu <= 4, "azure", 3),
                            _spread(lambda t: 2 <= t.cpu <= 4, "linode", 2)])
    medium = np.concatenate([_spread(lambda t: 4 < t.cpu <= 8, "azure", 3),
                             _spread(lambda t: 4 < t.cpu <= 8, "linode", 2)])
    large = np.concatenate([_spread(lambda t: t.cpu >= 8, "azure", 3),
                            _spread(lambda t: t.cpu >= 8, "linode", 2)])
    approved3 = np.concatenate([small, medium, large])
    scenarios.append(Scenario(
        name="s3_enterprise", title="Enterprise Environment (Fixed Node Pools)",
        demand=d3, allowed_idx=approved3,
        pools=default_pools_for(cat, approved3), existing=_existing_vec(n, {})))

    # ---- 4. Memory-intensive data processing -------------------------------
    d4 = np.array([32, 128, 12, 500], np.float64)
    himem = np.concatenate([
        _pick(cat, lambda t: t.provider == "azure" and t.family in ("E", "M")
              and t.mem_gb >= 16, 5, sort_key=lambda t: t.hourly_price),
        _pick(cat, lambda t: t.provider == "linode" and t.family == "highmem"
              and t.mem_gb >= 16, 4, sort_key=lambda t: t.hourly_price)])
    # paper: general pools also exist — CA must pick within memory-opt + GP
    # (dedicated general-purpose families; burstables are not production
    # options for memory-intensive workloads)
    gp_d = np.concatenate([
        _pick(cat, lambda t: t.provider == "azure" and t.family == "D"
              and t.cpu in (2, 4, 8), 6, sort_key=lambda t: t.hourly_price),
        _pick(cat, lambda t: t.provider == "linode" and t.family == "standard"
              and t.cpu in (2, 4, 8), 6, sort_key=lambda t: t.hourly_price)])
    pools4_idx = np.concatenate([himem, gp_d])
    existing4 = _existing_vec(n, {int(himem[0]): 1})
    scenarios.append(Scenario(
        name="s4_memory", title="Memory-Intensive Data Processing",
        demand=d4, allowed_idx=None,
        pools=default_pools_for(cat, pools4_idx, existing={int(himem[0]): 1}),
        existing=existing4))

    # ---- 5. Constrained: only small instances ------------------------------
    d5 = np.array([32, 64, 12, 300], np.float64)
    tiny = cat.select(lambda t: t.cpu <= 2)
    # CA pools: a manageable subset of those tiny types (one pool per family)
    seen, tiny_pools = set(), []
    for j in tiny:
        key = (inst[j].provider, inst[j].family)
        if key not in seen:
            seen.add(key)
            tiny_pools.append(j)
    scenarios.append(Scenario(
        name="s5_constrained", title="Resource Constraints (Small Instances Only)",
        demand=d5, allowed_idx=tiny,
        pools=default_pools_for(cat, np.asarray(tiny_pools)),
        existing=_existing_vec(n, {})))

    return scenarios


def scaled_scenario(base: Scenario, factor: float) -> Scenario:
    """Demand-scaled variant (paper Fig. 2 sweep)."""
    return Scenario(name=f"{base.name}_x{factor:g}", title=base.title,
                    demand=base.demand * factor, allowed_idx=base.allowed_idx,
                    pools=list(base.pools), existing=base.existing)
