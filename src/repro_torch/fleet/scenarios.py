"""Fleet scenario builders — port of ``repro.fleet.scenarios``: the three
consumers of the priced-term objective (``repro_torch.core.terms``).

Each helper takes :class:`~repro_torch.fleet.replay.TenantSpec` fleets and
returns NEW specs (``dataclasses.replace``; inputs are never mutated) with
the scenario's priced terms attached — and, for spot, the widened catalog
and the seeded availability overlay. The replay engines need no scenario
code: terms ride on every tick's problem through the controller's
``terms`` and the batched stacker, and the spot overlay through
``TenantSpec.spot_idx`` / ``spot_availability``.

Prices are in solver units like every other objective quantity: per-type
prices (``priority_eviction``, ``spot_risk``) in catalog $/hr, the scalar
``slo_penalty`` price in $ per unit of NORMALIZED shortage (demand is
scaled to 1 per resource).

Host numpy throughout, as in the reference; the terms' params are float32
tensors on the host until a problem carries them to its device.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.catalog import Catalog, spot_catalog, spot_risk_prices
from ..core.terms import make_term

from .replay import TenantSpec, default_ca_pools
from .traces import make_trace

# eviction-exposure weight per priority class: critical work is never
# evicted (no surcharge), batch work carries full expected-restart cost
PRIORITY_CLASSES: Dict[str, float] = {
    "critical": 0.0,
    "standard": 0.4,
    "batch": 1.0,
}


def with_slo_pricing(specs: Sequence[TenantSpec], price: float = 0.5,
                     ) -> List[TenantSpec]:
    """Attach a contractual SLO-credit price to every tenant: the
    ``slo_penalty`` term charges ``price`` per unit of unmet (normalized)
    demand, on top of the solver's soft shortage penalty — so the
    cost/SLO tradeoff is PRICED in $ instead of tuned via penalty weights.
    Raising ``price`` moves the replay along the cost/SLO frontier
    (``benchmarks/scenario_bench.py`` sweeps it)."""
    assert price >= 0.0, price
    term = make_term("slo_penalty", price=price)
    return [replace(s, terms=tuple(s.terms) + (term,)) for s in specs]


def _peak_total(spec: TenantSpec) -> float:
    """A tenant's peak total demand (per-resource peaks summed) — the same
    peak the CA baseline provisions for; used only as a relative
    contention weight, so mixed resource units are acceptable."""
    return float(np.asarray(spec.trace, np.float64).max(axis=0).sum())


def with_priority_classes(specs: Sequence[TenantSpec],
                          priorities: Sequence[str], *,
                          catalog: Catalog,
                          eviction_price: float = 0.15,
                          classes: Optional[Dict[str, float]] = None,
                          ) -> List[TenantSpec]:
    """Attach per-tenant ``priority_eviction`` terms from named priority
    classes (one class per spec, keys of ``classes`` /
    :data:`PRIORITY_CLASSES`).

    A tenant's surcharge prices its eviction exposure PER NODE: an
    eviction costs drain + reschedule + warm-up overhead roughly per node
    regardless of size, so the per-type price is the flat
    ``weight * eviction_price * pressure * median(c)`` on every type
    (``c`` the tenant's catalog hourly prices; a price ∝ c would be a
    uniform objective rescale that never moves the argmin). ``pressure``
    is the fleet's high-priority peak-demand share (fraction of the
    fleet's summed peak demand owned by weight-0 tenants) — low-priority
    capacity is only at risk to the extent protected work can claim it.
    Critical tenants get no term (weight 0 would be an exact no-op
    anyway); batch tenants feel consolidation pressure — fewer, larger
    nodes expose fewer eviction targets."""
    classes = PRIORITY_CLASSES if classes is None else classes
    if len(priorities) != len(specs):
        raise ValueError(f"got {len(priorities)} priorities for "
                         f"{len(specs)} tenant specs")
    weights = []
    for p in priorities:
        try:
            weights.append(float(classes[p]))
        except KeyError:
            raise ValueError(f"unknown priority class {p!r}; choose from "
                             f"{sorted(classes)}") from None
    peaks = np.asarray([_peak_total(s) for s in specs])
    protected = np.asarray([w == 0.0 for w in weights])
    pressure = float(peaks[protected].sum() / max(peaks.sum(), 1e-9))
    out: List[TenantSpec] = []
    for spec, w in zip(specs, weights):
        if w == 0.0 or pressure == 0.0:
            out.append(replace(spec))
            continue
        c = (spec.catalog or catalog).matrices()[2]
        per_node = w * eviction_price * pressure * float(np.median(c))
        term = make_term("priority_eviction",
                         price=np.full(len(c), per_node, np.float32))
        out.append(replace(spec, terms=tuple(spec.terms) + (term,)))
    return out


def make_spot_fleet(catalog: Catalog, specs: Sequence[TenantSpec], *,
                    discount: float = 0.7,
                    interruption_rate: float = 0.08,
                    mean_outage: float = 3.0,
                    penalty_hours: float = 2.0,
                    seed: int = 0,
                    ) -> Tuple[Catalog, List[TenantSpec]]:
    """Widen the fleet onto a spot market: returns ``(spot_cat, specs)``
    where ``spot_cat`` appends a spot twin of every type at the true
    discounted price (:func:`~repro_torch.core.catalog.spot_catalog`) and every
    spec gets (1) a ``spot_risk`` term pricing the expected interruption
    cost on the twins (:func:`~repro_torch.core.catalog.spot_risk_prices` at
    ``interruption_rate``/``penalty_hours``), and (2) its own seeded
    ``spot_interruption`` availability overlay (``seed + tenant index`` —
    pools fail independently per tenant) that the controller applies per
    tick by zeroing interrupted twins' capacity. Tenants keeping an
    ``allowed_idx`` also get their types' spot twins allowed. Tenants
    without an explicit ``ca_pool_idx`` get one pinned to the ON-DEMAND
    catalog's default pools (indices are unchanged by twin appending), so
    the CA baseline stays the spot-blind operator status quo instead of
    scheduling on interruption-free discounted twins.

    Per-tenant catalog overrides are not supported (the twins must index
    into the shared fleet catalog for the overlay to line up)."""
    for spec in specs:
        if spec.catalog is not None:
            raise ValueError(
                f"TenantSpec {spec.name!r} has a per-tenant catalog; "
                f"make_spot_fleet requires the shared fleet catalog so "
                f"spot-twin indices line up across the fleet")
    spot_cat, spot_idx = spot_catalog(catalog, discount=discount)
    risk = spot_risk_prices(spot_cat, spot_idx, rate=interruption_rate,
                            penalty_hours=penalty_hours)
    term = make_term("spot_risk", risk=risk)
    out: List[TenantSpec] = []
    for i, spec in enumerate(specs):
        T = int(np.asarray(spec.trace).shape[0])
        avail = make_trace("spot_interruption", np.ones(len(spot_idx)), T,
                           seed=seed + i, rate=interruption_rate,
                           mean_outage=mean_outage)
        allowed = spec.allowed_idx
        if allowed is not None:
            allowed = np.asarray(allowed, np.int64)
            allowed = np.unique(np.concatenate([allowed, spot_idx[allowed]]))
        ca_pools = spec.ca_pool_idx
        if ca_pools is None:
            ca_pools = default_ca_pools(
                catalog, np.asarray(spec.trace, np.float64).max(axis=0))
        out.append(replace(spec, allowed_idx=allowed, ca_pool_idx=ca_pools,
                           terms=tuple(spec.terms) + (term,),
                           spot_idx=spot_idx, spot_availability=avail))
    return spot_cat, out
