"""A copy of ``repro.core.workloads`` (numpy only; tests pin it equal).

Framework integration: convert dry-run roofline artifacts into the paper's
demand vectors, so the Infrastructure Optimization Controller plans
accelerator fleets for training/serving jobs.

Demand dims reuse the catalog convention (see catalog.make_tpu_catalog):
  0: chips-equivalent of compute  (HLO_FLOPs / (peak_flops * step_budget_s))
  1: HBM GB                       (per-device bytes * devices / 1e9)
  2: ICI GB/s aggregate           (collective_bytes / step_budget_s / 1e9)
  3: host RAM GB                  (data pipeline + checkpoint staging)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

PEAK_FLOPS_BF16 = 197e12       # per chip (given)
HBM_BW = 819e9                 # bytes/s per chip
ICI_LINK_BW = 50e9             # bytes/s per link


@dataclass
class JobSpec:
    """A training/serving job's roofline numbers (FLOPs, bytes moved,
    collective traffic) plus its step-time budget."""

    name: str
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    bytes_per_device: float
    devices: int
    step_budget_s: float = 1.0   # target step time
    host_ram_gb: float = 64.0


def demand_from_job(job: JobSpec) -> np.ndarray:
    """Lower a JobSpec to an (m,) accelerator demand vector (chips, HBM GB,
    ICI Gb/s, host RAM) — the bridge from dry-run rooflines to the
    allocator."""
    compute_chips = job.hlo_flops / (PEAK_FLOPS_BF16 * job.step_budget_s)
    hbm_gb = job.bytes_per_device * job.devices / 1e9
    ici_gbps = job.collective_bytes / job.step_budget_s / 1e9
    return np.array([compute_chips, hbm_gb, ici_gbps, job.host_ram_gb], np.float64)


def demand_from_dryrun_record(rec: Dict, step_budget_s: float = 1.0) -> np.ndarray:
    """rec: one JSON record produced by repro.launch.dryrun."""
    job = JobSpec(
        name=rec.get("cell", "job"),
        hlo_flops=float(rec["flops"]),
        hlo_bytes=float(rec.get("bytes_accessed", 0.0)),
        collective_bytes=float(rec.get("collective_bytes", 0.0)),
        bytes_per_device=float(rec.get("bytes_per_device", 0.0)),
        devices=int(rec.get("devices", 256)),
        step_budget_s=step_budget_s,
    )
    return demand_from_job(job)


def fleet_demand(records, step_budget_s: float = 1.0) -> np.ndarray:
    """Aggregate demand across a fleet of concurrent jobs."""
    total = np.zeros(4, np.float64)
    for rec in records:
        total += demand_from_dryrun_record(rec, step_budget_s)
    return total
