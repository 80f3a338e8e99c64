"""A copy of ``repro.core.metrics`` (numpy only; tests pin it equal).

Evaluation metrics (paper §IV.B): cost, utilization, diversity,
fragmentation, over-provisioning."""
from __future__ import annotations

from dataclasses import dataclass, asdict

import numpy as np

from .catalog import Catalog


@dataclass
class AllocationMetrics:
    """Snapshot evaluation of one allocation against one demand vector, in
    raw catalog units (the paper's §IV.B comparison columns)."""

    total_cost: float            # $/hr
    utilization_pct: float       # mean_r demand/provided * 100
    instance_diversity: int      # distinct instance types deployed
    provider_fragmentation: int  # distinct providers used
    overprovision_pct: float     # mean_r (provided-demand)/demand * 100
    satisfied: bool

    def as_dict(self):
        return asdict(self)


def evaluate(catalog: Catalog, counts: np.ndarray, demand: np.ndarray) -> AllocationMetrics:
    """Score integer ``counts`` against ``demand`` in raw units — shared by
    the optimizer, the CA baseline, and both replay engines."""
    K, E, c = catalog.matrices()
    counts = np.asarray(counts, np.float64)
    provided = K @ counts
    nonzero = demand > 0
    util = np.mean(np.where(nonzero, demand / np.maximum(provided, 1e-9), 1.0)) * 100.0
    over = np.mean(np.where(nonzero,
                            (provided - demand) / np.maximum(demand, 1e-9), 0.0)) * 100.0
    used = counts > 0.5
    return AllocationMetrics(
        total_cost=float(c @ counts),
        utilization_pct=float(min(util, 100.0)),
        instance_diversity=int(used.sum()),
        provider_fragmentation=int((E @ used.astype(np.float64) > 0.5).sum()),
        overprovision_pct=float(over),
        satisfied=bool(np.all(provided >= demand - 1e-6)),
    )


def per_dim_utilization(catalog: Catalog, counts: np.ndarray,
                        demand: np.ndarray) -> np.ndarray:
    """Radar-graph data (paper Appendix A): demand/provided per resource."""
    K, _, _ = catalog.matrices()
    provided = K @ np.asarray(counts, np.float64)
    return np.clip(demand / np.maximum(provided, 1e-9), 0.0, 1.0)
