"""Elastic scaling — port of ``repro.distributed.elastic``, where the
PAPER'S ALLOCATOR becomes the framework's brain: on failure (or load
change) the Infrastructure Optimization Controller replans the accelerator
fleet under the incremental-adoption churn bound (paper §III.E), and the
runtime rebuilds the mesh and reshards the parameters.

Flow:
  demand  = roofline-derived demand vector (repro_torch.core.workloads) for
            the jobs that must keep running
  replan  = controller.replan_on_failure(failed, demand)  (convex solve)
  rebuild = _mesh_from_chips() -> launch.mesh.make_mesh -> reshard_params
            (the deterministic data pipeline re-shards itself by step index)

``ElasticFleet`` runs the port's controller on ``make_tpu_catalog()`` on
``device`` (default "cuda"): with ``use_kernel`` (the default) its solves
evaluate eq. (1) with the ``alloc_objective`` kernel, else with its plain
version.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import numpy as np

from ..core import InfrastructureOptimizationController, make_tpu_catalog
from ..core.workloads import JobSpec, demand_from_job
from ..device import DeviceLike
from ..optim.adamw import tree_map


@dataclass
class FleetPlan:
    counts: np.ndarray            # catalog counts (slice types)
    total_chips: int
    cost_per_hour: float
    mesh_shape: Tuple[int, ...]   # (data, model) for the training job


def _mesh_from_chips(chips: int, model_parallel: int = 16) -> Tuple[int, int]:
    data = max(1, chips // model_parallel)
    return (data, model_parallel)


class ElasticFleet:
    """Owns the controller + current plan for ONE training job."""

    def __init__(self, job: JobSpec, delta_max: float = 64.0,
                 model_parallel: int = 16, device: DeviceLike = None,
                 use_kernel: bool = True):
        self.catalog = make_tpu_catalog()
        self.job = job
        self.model_parallel = model_parallel
        self.controller = InfrastructureOptimizationController(
            catalog=self.catalog, delta_max=delta_max, n_starts=4,
            device=device, use_kernel=use_kernel)

    def _to_plan(self, counts: np.ndarray) -> FleetPlan:
        K, _, c = self.catalog.matrices()
        chips = float(K[0] @ counts)   # resource 0 = chips-equivalent
        return FleetPlan(
            counts=counts, total_chips=int(chips),
            cost_per_hour=float(c @ counts),
            mesh_shape=_mesh_from_chips(int(chips), self.model_parallel))

    def initial_plan(self) -> FleetPlan:
        demand = demand_from_job(self.job)
        step = self.controller.step(demand)
        return self._to_plan(step.counts)

    def replan_after_failure(self, failed_counts: np.ndarray) -> FleetPlan:
        demand = demand_from_job(self.job)
        step = self.controller.replan_on_failure(failed_counts, demand)
        return self._to_plan(step.counts)

    def replan_for_demand(self, scale: float) -> FleetPlan:
        job = dataclasses.replace(self.job, hlo_flops=self.job.hlo_flops * scale)
        step = self.controller.step(demand_from_job(job))
        return self._to_plan(step.counts)


def reshard_params(params, old_mesh, new_mesh, axes_tree, rules):
    """Move a tree of DTensors on ``old_mesh`` onto the placements that
    ``sharding.make_shardings`` gives on ``new_mesh`` (the post-failure
    rebuild without a checkpoint): each leaf is gathered whole and
    redistributed. Both meshes span the same ranks. Returns the new tree;
    with a checkpoint, load the full tensors and distribute them instead."""
    from torch.distributed.tensor import DTensor

    from . import sharding as shd
    placements = shd.make_shardings(axes_tree, new_mesh, rules, params)

    def move(p, pl):
        if isinstance(p, DTensor) and p.device_mesh is not old_mesh:
            raise ValueError("reshard_params: a leaf is not on old_mesh")
        full = p.full_tensor() if isinstance(p, DTensor) else p
        return shd.shard_full(full, new_mesh, pl)

    return tree_map(move, params, placements)
