"""repro_torch.fleet — the batched fleet solver and trace replay: stack
tenant problems (``batching``), solve them cold (``solve_fleet``) and warm
(``solve_fleet_step``), and replay demand traces (``replay_fleet``, its
sequential and batched engines; ``replay_tenant`` for one tenant) against
the Cluster-Autoscaler baseline on the same traces."""
from .batching import (FleetBatch, bucket_dims, ceil_pow2, embed_solutions,
                       stack_problems, tenant_problem)
from .metrics import FleetReplayMetrics, TenantReplayMetrics
from .replay import (FleetReplayResult, TenantReplay, TenantSpec,
                     replay_fleet, replay_tenant)
from .solver import (FleetSolveResult, FleetStepResult, make_fleet_starts,
                     solve_fleet, solve_fleet_step)
from .traces import TRACE_KINDS, make_trace

__all__ = [
    "FleetBatch", "bucket_dims", "ceil_pow2", "embed_solutions",
    "stack_problems", "tenant_problem",
    "FleetReplayMetrics", "TenantReplayMetrics", "FleetReplayResult",
    "TenantReplay", "TenantSpec", "replay_fleet", "replay_tenant",
    "FleetSolveResult", "FleetStepResult", "make_fleet_starts", "solve_fleet", "solve_fleet_step", "TRACE_KINDS",
    "make_trace",
]
