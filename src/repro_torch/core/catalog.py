"""A copy of ``repro.core.catalog`` (numpy only; tests pin it bit-equal).

Synthetic instance catalogs — 940 Azure-like + 940 Linode-like types
(paper §IV.A collected these via live APIs; offline we generate catalogs with
the same scale and family/price structure, deterministically).

Resources (m=4, matching the paper's scenario dimensions):
  0: vCPU cores, 1: memory GB, 2: network units, 3: storage GB.

Also provides a TPU/accelerator-slice catalog used by the framework
integration (demands derived from dry-run rooflines → fleet planning).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

RESOURCES = ("cpu", "mem_gb", "net_units", "storage_gb")
M = len(RESOURCES)


@dataclass
class InstanceType:
    """One purchasable node type: per-node capacities and hourly price."""

    name: str
    provider: str
    family: str
    cpu: float
    mem_gb: float
    net_units: float
    storage_gb: float
    hourly_price: float


@dataclass
class Catalog:
    """An ordered list of instance types; ``matrices()`` lowers it to the
    paper's (K, E, c) model inputs (see docs/math.md)."""

    instances: List[InstanceType]

    @property
    def n(self) -> int:
        return len(self.instances)

    @property
    def providers(self) -> List[str]:
        seen: List[str] = []
        for it in self.instances:
            if it.provider not in seen:
                seen.append(it.provider)
        return seen

    def matrices(self):
        """Return (K (m,n), E (p,n), c (n,)) as float32 numpy arrays."""
        n = self.n
        K = np.zeros((M, n), np.float32)
        for j, it in enumerate(self.instances):
            K[:, j] = (it.cpu, it.mem_gb, it.net_units, it.storage_gb)
        provs = self.providers
        E = np.zeros((len(provs), n), np.float32)
        for j, it in enumerate(self.instances):
            E[provs.index(it.provider), j] = 1.0
        c = np.asarray([it.hourly_price for it in self.instances], np.float32)
        return K, E, c

    def select(self, pred) -> np.ndarray:
        """Indices of instances satisfying a predicate."""
        return np.asarray([j for j, it in enumerate(self.instances) if pred(it)],
                          np.int64)


# family spec: (name, ram_per_cpu, storage_per_cpu, net_per_cpu,
#               price_per_cpu_hr, storage_price_per_gb_hr)
_AZURE_FAMILIES = [
    ("B", 4.0, 8.0, 0.25, 0.0104, 0.00005),     # burstable
    ("D", 4.0, 16.0, 0.50, 0.0480, 0.00005),    # general purpose
    ("F", 2.0, 8.0, 0.50, 0.0425, 0.00005),     # compute optimized
    ("E", 8.0, 32.0, 0.50, 0.0630, 0.00005),    # memory optimized
    ("M", 16.0, 64.0, 0.75, 0.1070, 0.00005),   # large memory
    ("L", 8.0, 340.0, 0.75, 0.0860, 0.00002),   # storage optimized
    ("DC", 4.0, 16.0, 0.50, 0.0980, 0.00005),   # confidential
    ("NV", 8.0, 48.0, 1.00, 0.1900, 0.00005),   # accel-adjacent
]
_AZURE_SIZES = [1, 2, 4, 8, 12, 16, 20, 24, 32, 48, 64, 96]
_AZURE_GENS = [("v3", 1.00), ("v4", 0.97), ("v5", 0.94), ("sv5", 0.99),
               ("av4", 0.90), ("av5", 0.87), ("dv4", 1.02), ("dv5", 0.98),
               ("ev4", 1.05), ("ev5", 1.01)]

_LINODE_FAMILIES = [
    ("standard", 2.0, 26.0, 0.40, 0.0270, 0.0),
    ("dedicated", 2.0, 25.0, 0.55, 0.0540, 0.0),
    ("highmem", 8.0, 20.0, 0.40, 0.0600, 0.0),
    ("premium", 2.0, 32.0, 0.80, 0.0650, 0.0),
    ("gpu-host", 6.0, 80.0, 1.00, 0.1500, 0.0),
    ("nanode", 1.0, 25.0, 0.20, 0.0075, 0.0),
]
_LINODE_SIZES = [1, 2, 4, 6, 8, 12, 16, 20, 24, 32, 40, 48, 56, 64, 80, 96]


def _mk_instance(rng, provider, fam, size, gen_name, gen_factor,
                 ram_per_cpu, st_per_cpu, net_per_cpu, ppc, spg) -> InstanceType:
    jitter = float(1.0 + 0.03 * rng.standard_normal())
    cpu = float(size)
    mem = cpu * ram_per_cpu
    storage = cpu * st_per_cpu
    net = max(0.25, cpu * net_per_cpu)
    # mild sublinear size discount, matching public price sheets
    size_disc = size ** -0.03
    price = (ppc * cpu * gen_factor * size_disc + spg * storage) * jitter
    return InstanceType(
        name=f"{provider}-{fam}{size}{gen_name}",
        provider=provider, family=fam, cpu=cpu, mem_gb=mem,
        net_units=net, storage_gb=storage, hourly_price=round(max(price, 0.003), 5),
    )


def make_cloud_catalog(seed: int = 0, n_per_provider: int = 940) -> Catalog:
    """Deterministic synthetic two-provider catalog (940 Azure-like + 940
    Linode-like types) with the paper's family/size/price structure."""
    rng = np.random.default_rng(seed)
    out: List[InstanceType] = []

    azure: List[InstanceType] = []
    for fam, rpc, spc, npc, ppc, spg in _AZURE_FAMILIES:
        for size in _AZURE_SIZES:
            for gen, gf in _AZURE_GENS:
                azure.append(_mk_instance(rng, "azure", fam, size, gen, gf,
                                          rpc, spc, npc, ppc, spg))
    azure = azure[:n_per_provider]

    linode: List[InstanceType] = []
    for fam, rpc, spc, npc, ppc, spg in _LINODE_FAMILIES:
        for size in _LINODE_SIZES:
            for rep in range(10):  # region/variant replicas with price jitter
                linode.append(_mk_instance(rng, "linode", fam, size, f"r{rep}",
                                           1.0 + 0.01 * rep, rpc, spc, npc, ppc, spg))
    linode = linode[:n_per_provider]

    out = azure + linode
    return Catalog(out)


def spot_catalog(catalog: Catalog, discount: float = 0.7,
                 suffix: str = "#spot"):
    """Append a spot/preemptible twin of every instance type at
    ``(1 - discount)`` times the on-demand price.

    Returns ``(catalog, spot_idx)`` — the widened catalog and the (S,)
    indices of the spot twins.  Unlike ``extensions.tiered_catalog`` (which
    folds interruption risk into the price as a certainty equivalent), the
    spot price here is the TRUE discounted price: interruption risk is
    priced separately via the ``spot_risk`` objective term
    (:func:`spot_risk_prices`), and availability is driven per tick by the
    ``spot_interruption`` trace overlay (``repro_torch.fleet.traces``) zeroing
    interrupted twins' capacity (mask/bounds) — so risk stays visible in
    the objective split instead of hiding in the catalog."""
    from dataclasses import replace

    assert 0.0 < discount < 1.0, discount
    out = list(catalog.instances)
    spot: List[int] = []
    for it in catalog.instances:
        spot.append(len(out))
        out.append(replace(
            it, name=it.name + suffix,
            hourly_price=round(it.hourly_price * (1.0 - discount), 6)))
    return Catalog(out), np.asarray(spot, np.int64)


def spot_risk_prices(catalog: Catalog, spot_idx: np.ndarray,
                     rate: float = 0.05,
                     penalty_hours: float = 2.0) -> np.ndarray:
    """Per-type ``spot_risk`` term prices: the certainty-equivalent
    interruption surcharge ``rate * penalty_hours * hourly_price`` on each
    spot twin, zero on on-demand types.  Attach with
    ``make_term("spot_risk", risk=...)`` so the surcharge shows up as its
    own objective term rather than a repriced catalog."""
    risk = np.zeros(catalog.n, np.float32)
    for j in np.asarray(spot_idx, np.int64):
        risk[j] = rate * penalty_hours * catalog.instances[int(j)].hourly_price
    return risk


def make_tpu_catalog(seed: int = 0) -> Catalog:
    """Accelerator-slice catalog for the framework integration. Resources map
    to: cpu -> chips, mem_gb -> HBM GB, net_units -> ICI GB/s (aggregate),
    storage_gb -> host RAM GB."""
    slices = []
    # (name, chips, $/chip-hr)
    for chips, price_per_chip in [(1, 1.2), (4, 1.2), (8, 1.18), (16, 1.15),
                                  (32, 1.12), (64, 1.10), (128, 1.08),
                                  (256, 1.05)]:
        slices.append(InstanceType(
            name=f"v5e-{chips}", provider="tpu-cloud", family="v5e",
            cpu=float(chips), mem_gb=16.0 * chips, net_units=50.0 * 4 * chips,
            storage_gb=64.0 * max(1, chips // 4),
            hourly_price=round(price_per_chip * chips, 3)))
    for chips, price_per_chip in [(4, 4.2), (8, 4.1), (16, 4.0), (32, 3.9),
                                  (64, 3.85), (128, 3.8)]:
        slices.append(InstanceType(
            name=f"v5p-{chips}", provider="tpu-cloud", family="v5p",
            cpu=float(chips) * 2.33, mem_gb=95.0 * chips, net_units=90.0 * 6 * chips,
            storage_gb=128.0 * max(1, chips // 4),
            hourly_price=round(price_per_chip * chips, 3)))
    for chips, price_per_chip in [(1, 0.9), (16, 0.88), (64, 0.85), (256, 0.82)]:
        slices.append(InstanceType(
            name=f"trn2-{chips}", provider="aws", family="trn2",
            cpu=float(chips) * 0.65, mem_gb=24.0 * chips, net_units=30.0 * 4 * chips,
            storage_gb=96.0 * max(1, chips // 8),
            hourly_price=round(price_per_chip * chips, 3)))
    return Catalog(slices)
