"""repro_torch.fleet — the batched fleet solver and trace replay: stack
tenant problems (``batching``, globally padded or in power-of-two shape
buckets), solve them cold (``solve_fleet``, ``solve_fleet_bucketed``) and
warm (``solve_fleet_step``), replay demand traces (``replay_fleet``, its
sequential and batched engines, with the myopic or the receding-horizon
controller, ``controller="mpc"``, see ``repro_torch.horizon``;
``replay_tenant`` for one tenant) against the Cluster-Autoscaler baseline
on the same traces, and build priced
scenario fleets (``scenarios``: SLO pricing, priority classes, the spot
market)."""
from .batching import (BucketedFleet, FleetBatch, bucket_dims,
                       bucket_problems, ceil_pow2, embed_solutions,
                       padding_stats, scatter_from_buckets, stack_problems,
                       tenant_problem, union_term_kinds, unstack_solution)
from .metrics import FleetReplayMetrics, TenantReplayMetrics
from .replay import (FleetReplayResult, TenantReplay, TenantSpec,
                     replay_fleet, replay_tenant)
from .scenarios import (PRIORITY_CLASSES, make_spot_fleet,
                        with_priority_classes, with_slo_pricing)
from .solver import (FleetSolveResult, FleetStepResult, make_fleet_starts,
                     solve_fleet, solve_fleet_bucketed, solve_fleet_step)
from .traces import (TRACE_KINDS, constant_trace, diurnal_trace,
                     flash_crowd_trace, make_trace, ramp_trace,
                     spot_interruption_trace, weekly_trace)

__all__ = [
    "FleetBatch", "stack_problems", "unstack_solution", "embed_solutions",
    "tenant_problem", "union_term_kinds",
    "BucketedFleet", "bucket_dims", "bucket_problems", "ceil_pow2",
    "scatter_from_buckets", "padding_stats",
    "FleetReplayMetrics", "TenantReplayMetrics", "FleetReplayResult",
    "TenantReplay", "TenantSpec", "replay_fleet", "replay_tenant",
    "FleetSolveResult", "FleetStepResult", "make_fleet_starts", "solve_fleet",
    "solve_fleet_bucketed", "solve_fleet_step", "TRACE_KINDS", "make_trace",
    "diurnal_trace", "flash_crowd_trace", "ramp_trace", "weekly_trace",
    "constant_trace", "spot_interruption_trace",
    "PRIORITY_CLASSES", "with_slo_pricing", "with_priority_classes",
    "make_spot_fleet",
]
