"""Flash-crowd serving demo: ``python -m repro_torch.serve`` — port of
``python -m repro.serve``.

Drives a :class:`repro_torch.serve.ServeEngine` through a bursty session —
tenants join over the first ticks, submit flash-crowd demand, and a
fraction departs mid-session with joiners reusing their lanes — then
prints the decision-latency percentiles, deadline-miss/truncation rates
and staleness the engine recorded. ``--deadline-ms`` turns on the
enforced anytime budget; without it the demo serves untruncated. The
session runs on the card unless ``--device cpu`` asks for the CPU.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from ..core.catalog import make_cloud_catalog
from ..device import DeviceLike
from ..fleet.traces import flash_crowd_trace
from ..obs.health import HealthMonitor

from .engine import ServeEngine


def run_demo(lanes: int = 8, ticks: int = 24,
             deadline_ms: Optional[float] = None, seed: int = 0,
             arrival_p: float = 0.7, churn_tick: Optional[int] = None,
             verbose: bool = True, hot_loop: str = "kernel",
             device: DeviceLike = None) -> ServeEngine:
    """The demo session (importable for tests): ``lanes`` tenants arrive
    over the first ticks (each with a flash-crowd trace), one departs at
    ``churn_tick`` (default mid-session) and a fresh joiner reuses its
    lane. Demand arrival is asynchronous: each live tenant submits on an
    independent coin flip per tick (``arrival_p``), so some ticks decide
    many tenants and some decide none. ``hot_loop`` and ``device`` are the
    engine's."""
    rng = np.random.default_rng(seed)
    catalog = make_cloud_catalog()
    health = HealthMonitor(deadline_ms=deadline_ms, kkt_every=0)
    eng = ServeEngine(catalog, lanes, deadline_ms=deadline_ms, health=health,
                      hot_loop=hot_loop, device=device)
    base = np.array([8.0, 16.0, 4.0, 100.0])   # cpu, mem, net, storage
    traces = {f"tenant-{k}": flash_crowd_trace(
        base * rng.uniform(0.5, 1.5, size=base.shape), ticks,
        seed=seed + k) for k in range(lanes)}
    churn_tick = ticks // 2 if churn_tick is None else churn_tick
    pending = sorted(traces)
    cursor = {}
    for t in range(ticks):
        # staggered joins: one or two waiting tenants per tick
        for _ in range(min(len(pending), int(rng.integers(1, 3)))):
            name = pending.pop(0)
            eng.register(name)
            cursor[name] = 0
        if t == churn_tick and eng.tenants():
            gone = eng.tenants()[0]
            eng.depart(gone)
            del cursor[gone]
            joiner = f"{gone}-successor"
            traces[joiner] = flash_crowd_trace(
                base * rng.uniform(0.5, 1.5, size=base.shape), ticks,
                seed=seed + 101)
            eng.register(joiner)
            cursor[joiner] = 0
        for name in eng.tenants():
            tr = traces[name]
            if cursor[name] == 0 or rng.random() < arrival_p:
                eng.submit(name, tr[min(cursor[name], len(tr) - 1)])
                cursor[name] += 1
        eng.tick()
    if verbose:
        s = eng.summary()
        print(f"serve demo: {s.decisions} decisions over {s.ticks} ticks, "
              f"{lanes} lanes")
        print(f"  latency p50/p99 : {s.p50_latency_ms:.2f} / "
              f"{s.p99_latency_ms:.2f} ms")
        if deadline_ms is not None:
            print(f"  deadline {deadline_ms:g} ms: miss rate "
                  f"{s.miss_rate:.1%}, truncated {s.truncated_rate:.1%}")
        print(f"  staleness mean/max: {s.mean_staleness:.2f} / "
              f"{s.max_staleness} ticks")
        for line in health.report().summary_lines():
            print(line)
    return eng


def main(argv: Optional[Sequence[str]] = None) -> int:
    """CLI entry point: ``python -m repro_torch.serve [--lanes N]
    [--ticks T] [--deadline-ms MS] [--seed S] [--device DEV]``."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serve", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--lanes", type=int, default=8,
                    help="lane capacity / tenant count (default 8)")
    ap.add_argument("--ticks", type=int, default=24,
                    help="session length in decision ticks (default 24)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="enforced per-tick wall budget (default: none)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu to run here)")
    args = ap.parse_args(argv)
    run_demo(lanes=args.lanes, ticks=args.ticks,
             deadline_ms=args.deadline_ms, seed=args.seed,
             device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
