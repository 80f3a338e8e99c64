"""Paper §VII future-work features — port of ``repro.core.extensions``:

* §VII.A High availability: minimum replicas (x_i >= k for chosen types),
  availability-zone spread (a zone-replicated catalog with per-zone
  minimums), anti-affinity (mutually exclusive type groups, repaired after
  rounding since it is combinatorial).
* §VII.B Reserved / spot pricing: a two-tier catalog transform — each type
  gains a "reserved" twin at a discount, capped by the committed amount,
  and a "spot" twin at a deep discount with the interruption risk folded
  into its price (a certainty-equivalent cost, which keeps the objective
  convex).

Catalog transforms are host numpy; problem edits keep every leaf on the
problem's device.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .catalog import Catalog, InstanceType
from .problem import AllocationProblem
from .rounding import greedy_round


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy()


def _on(prob: AllocationProblem, a: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=prob.device)


# ---------------------------------------------------------------------------
# §VII.A — High availability
# ---------------------------------------------------------------------------

@dataclass
class HAPolicy:
    """High-availability add-ons (paper §VII.A): per-type minimum replicas,
    zone spread, and anti-affinity groups."""

    min_replicas: Dict[int, int]          # instance idx -> minimum count
    zones: int = 1                        # AZ spread factor
    anti_affinity: Sequence[Sequence[int]] = ()   # groups; use at most 1 of each


def zone_replicated_catalog(catalog: Catalog, zones: int) -> Catalog:
    """Replicate every instance type per availability zone (zone-suffixed
    names, identical specs). Spread constraints become per-zone minimums on
    the replicated types."""
    out: List[InstanceType] = []
    for z in range(zones):
        for it in catalog.instances:
            out.append(dataclasses.replace(it, name=f"{it.name}@z{z}"))
    return Catalog(out)


def apply_ha(prob: AllocationProblem, policy: HAPolicy,
             n_base: Optional[int] = None) -> AllocationProblem:
    """Lower-bound constraints for HA minimums; with ``zones`` > 1 the
    problem is assumed built on a zone-replicated catalog (n = zones *
    n_base) and each zone receives ceil(min/zones) replicas."""
    lb = _host(prob.lb).copy()
    if policy.zones > 1:
        if n_base is None or prob.n != policy.zones * n_base:
            raise ValueError(f"apply_ha: zones={policy.zones} needs a "
                             f"zone-replicated problem with n_base given")
        per_zone = {j: int(np.ceil(k / policy.zones))
                    for j, k in policy.min_replicas.items()}
        for z in range(policy.zones):
            for j, k in per_zone.items():
                lb[z * n_base + j] = max(lb[z * n_base + j], k)
    else:
        for j, k in policy.min_replicas.items():
            lb[j] = max(lb[j], k)
    return prob._replace(lb=_on(prob, lb))


def enforce_anti_affinity(x: np.ndarray, prob: AllocationProblem,
                          policy: HAPolicy) -> np.ndarray:
    """Post-rounding repair: within each anti-affinity group keep only the
    most cost-effective member, re-cover any deficit greedily (paper III.B
    scoring). Combinatorial constraints stay out of the convex core."""
    x = np.asarray(x, np.float64).copy()
    c, K, lb = _host(prob.c), _host(prob.K), _host(prob.lb)
    for group in policy.anti_affinity:
        active = [j for j in group if x[j] > 0.5]
        if len(active) <= 1:
            continue
        keep = min(active, key=lambda j: c[j] / max(float(K[:, j].sum()),
                                                    1e-9))
        for j in active:
            if j != keep:
                x[j] = lb[j]
    return _host(greedy_round(prob, _on(prob, x)))


# ---------------------------------------------------------------------------
# §VII.B — Reserved / spot pricing tiers
# ---------------------------------------------------------------------------

@dataclass
class PricingTiers:
    """Reserved/spot pricing knobs (paper §VII.B): discounts, the reserved
    capacity cap, and the spot interruption cost model."""

    reserved_discount: float = 0.4        # 40% off on committed capacity
    reserved_cap_fraction: float = 0.6    # at most this share may be reserved
    spot_discount: float = 0.7            # 70% off spot
    spot_interruption_rate: float = 0.05  # hourly interruption probability
    interruption_penalty_hours: float = 2.0   # lost work per interruption


def tiered_catalog(catalog: Catalog, tiers: PricingTiers
                   ) -> Tuple[Catalog, np.ndarray, np.ndarray]:
    """Returns (catalog with on-demand + reserved + spot twins,
    reserved_idx mask, spot_idx mask). Spot's effective price folds the
    interruption risk in as a certainty-equivalent surcharge:
        p_spot_eff = p_spot * (1 + rate * penalty_hours)
    keeping the objective linear (convexity preserved)."""
    out: List[InstanceType] = list(catalog.instances)
    n = len(out)
    reserved, spot = [], []
    for j, it in enumerate(catalog.instances):
        reserved.append(len(out))
        out.append(dataclasses.replace(
            it, name=it.name + "#res",
            hourly_price=round(it.hourly_price * (1 - tiers.reserved_discount), 6)))
    for j, it in enumerate(catalog.instances):
        spot.append(len(out))
        eff = (it.hourly_price * (1 - tiers.spot_discount)
               * (1 + tiers.spot_interruption_rate
                  * tiers.interruption_penalty_hours))
        out.append(dataclasses.replace(
            it, name=it.name + "#spot", hourly_price=round(eff, 6)))
    res_mask = np.zeros(len(out), bool)
    res_mask[np.asarray(reserved)] = True
    spot_mask = np.zeros(len(out), bool)
    spot_mask[np.asarray(spot)] = True
    return Catalog(out), res_mask, spot_mask


def cap_reserved(prob: AllocationProblem, res_mask: np.ndarray,
                 demand_cover_counts: np.ndarray,
                 tiers: PricingTiers) -> AllocationProblem:
    """Upper-bound reserved twins by the committed share of a reference
    cover (reservations are long-term commitments; the cap models the
    planner's commitment budget)."""
    ub = _host(prob.ub).copy()
    cap = np.ceil(tiers.reserved_cap_fraction
                  * np.maximum(demand_cover_counts, 0.0))
    base_n = res_mask.sum()
    # reserved twins occupy [n_base, 2 n_base)
    ub[res_mask] = np.minimum(ub[res_mask], np.maximum(cap[:base_n], 0.0))
    return prob._replace(ub=_on(prob, ub))
