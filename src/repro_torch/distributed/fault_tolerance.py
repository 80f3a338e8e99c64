"""Fault tolerance & straggler mitigation — a copy of
``repro.distributed.fault_tolerance`` (host numpy; tests pin it equal to
the reference), resuming from the port's checkpoints
(``repro_torch.checkpoint.checkpoint.latest_step_dir``).

On a multi-host deployment a failed host kills the SPMD program; the
recovery loop is PROCESS-level: detect -> replan capacity (the paper's
allocator, see elastic.py) -> rebuild mesh -> restore checkpoint -> resume
from the deterministic data stream. This module implements that control loop
plus straggler policies, with simulated failure/timing sources so the logic
is testable on CPU.

Pieces:
  * TrainingSupervisor — restart-with-backoff loop around a train function;
    checkpoint/restore + deterministic data resharding on membership change.
  * StragglerMonitor — per-step worker timing watchdog; policies:
      "wait"      — synchronous (baseline),
      "deadline"  — drop contributions slower than k x median (gradient
                    renormalization by participation weight),
      "backup"    — duplicate the slowest shard's work next step (speculative
                    re-execution, MapReduce-style backup tasks).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np


@dataclass
class FailureEvent:
    step: int
    kind: str              # "host_down" | "straggler" | "preemption"
    worker: int


@dataclass
class StragglerMonitor:
    n_workers: int
    policy: str = "deadline"
    deadline_factor: float = 3.0
    history: List[np.ndarray] = field(default_factory=list)
    backup_queue: List[int] = field(default_factory=list)

    def observe(self, step_times: np.ndarray):
        """step_times (n_workers,) seconds for this step."""
        self.history.append(step_times)

    def plan(self, step_times: np.ndarray) -> Dict:
        """Returns {included: bool mask, renorm: float, backups: [worker]}."""
        med = float(np.median(step_times))
        if self.policy == "wait":
            included = np.ones(self.n_workers, bool)
        elif self.policy == "deadline":
            included = step_times <= self.deadline_factor * med
            if not included.any():
                included = np.ones(self.n_workers, bool)
        elif self.policy == "backup":
            included = np.ones(self.n_workers, bool)
            worst = int(np.argmax(step_times))
            if step_times[worst] > self.deadline_factor * med:
                self.backup_queue.append(worst)
        else:
            raise ValueError(self.policy)
        renorm = self.n_workers / max(int(included.sum()), 1)
        return {"included": included, "renorm": renorm,
                "backups": list(self.backup_queue)}

    def effective_step_time(self, step_times: np.ndarray) -> float:
        plan = self.plan(step_times)
        inc = step_times[plan["included"]]
        return float(inc.max()) if len(inc) else float(step_times.max())


@dataclass
class SupervisorConfig:
    max_restarts: int = 10
    backoff_s: float = 0.0           # simulated
    checkpoint_every: int = 25


class TrainingSupervisor:
    """Restart loop: run train_fn until completion, restoring from the last
    committed checkpoint after each failure. train_fn receives
    (start_step, num_shards) and must raise on (injected) failure."""

    def __init__(self, cfg: SupervisorConfig, ckpt_dir: str):
        self.cfg = cfg
        self.ckpt_dir = ckpt_dir
        self.restarts = 0
        self.events: List[FailureEvent] = []

    def run(self, train_fn: Callable[[int, int], int], total_steps: int,
            initial_shards: int, replan_shards: Optional[Callable[[int], int]] = None):
        """Returns the final step reached. ``replan_shards(old)`` is invoked
        after each failure — the elastic hook (paper's controller decides the
        new fleet size)."""
        from ..checkpoint.checkpoint import latest_step_dir
        num_shards = initial_shards
        step = 0
        while step < total_steps:
            try:
                step = train_fn(step, num_shards)
            except RuntimeError as e:
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise
                if replan_shards is not None:
                    num_shards = replan_shards(num_shards)
                # resume point = last committed checkpoint (the failing step
                # itself is unknowable after a real crash)
                d = latest_step_dir(self.ckpt_dir)
                step = (int(d.split("step_")[-1]) if d else 0)
                self.events.append(FailureEvent(step=step, kind=str(e),
                                                worker=-1))
        return step


def simulate_step_times(rng: np.random.Generator, n_workers: int,
                        base_s: float = 1.0, straggle_prob: float = 0.05,
                        straggle_factor: float = 8.0) -> np.ndarray:
    t = rng.normal(base_s, 0.03 * base_s, n_workers).clip(base_s * 0.8)
    mask = rng.random(n_workers) < straggle_prob
    return np.where(mask, t * straggle_factor, t)
