"""Keep the port's trace export path from rotting silently — port of the
reference's ``tools/trace_demo.py``.

Runs a SMALL fully-instrumented fleet replay (telemetry recorder, per-lane
solver-trace capture, the batched engine, ``hot_loop="kernel"``), writes
the Perfetto-loadable Chrome trace (default
``build/repro_torch_trace/trace.json`` at the repository root, plus the
JSONL event log next to it), re-validates BOTH emitted files against their
schemas (``repro_torch.obs.export.validate_chrome_trace`` /
``validate_jsonl``), and prints the ``ReplayReport`` rollup. Exit 1 on any
schema violation, on a trace with no compile-tagged solve span, or on a
replay that captured no solver trace — the things the export pipeline
exists to deliver.

The replay runs on the card (``--device cuda``, the default; it raises
without one) unless ``--device cpu`` asks for the CPU, where the kernel
wrappers run their plain versions.

``--validate TRACE.json`` skips the replay and only re-validates an
already-emitted artifact pair (the JSONL is looked up next to the trace),
exiting non-zero on problems.

Run:  PYTHONPATH=src python -m repro_torch.tools.trace_demo [--out PATH]
      [--device cpu]
Open: https://ui.perfetto.dev  →  drag the trace in.
"""
from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

REPO = Path(__file__).resolve().parents[3]
DEFAULT_OUT = REPO / "build" / "repro_torch_trace" / "trace.json"


def validate_artifacts(trace_path: str, jsonl_path: str) -> List[str]:
    """Validate an emitted (Chrome trace, JSONL event log) pair against
    both export schemas; returns all problems, each prefixed with the file
    it came from (empty list = both valid)."""
    from ..obs import validate_chrome_trace, validate_jsonl

    problems = [f"trace schema: {p}" for p in validate_chrome_trace(trace_path)]
    problems += [f"jsonl schema: {p}" for p in validate_jsonl(jsonl_path)]
    return problems


def _validate_only(trace_path: str) -> int:
    jsonl_path = os.path.splitext(trace_path)[0] + ".jsonl"
    failures = validate_artifacts(trace_path, jsonl_path)
    if failures:
        print(f"[trace-demo] INVALID — {len(failures)} problem(s):")
        for f in failures:
            print(f"  {f}")
        return 1
    print(f"[trace-demo] OK — {trace_path} and {jsonl_path} validate")
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Instrumented fleet replay exported as a Chrome trace "
                    "and a JSONL event log, both revalidated.")
    ap.add_argument("--out", default=str(DEFAULT_OUT),
                    help="Chrome trace path; the JSONL goes next to it")
    ap.add_argument("--validate", metavar="TRACE.json",
                    help="only re-validate an emitted trace and its JSONL")
    ap.add_argument("--device", default="cuda",
                    help="device of the replay (default cuda; raises "
                         "without a card)")
    args = ap.parse_args(argv)
    if args.validate:
        return _validate_only(args.validate)

    from ..core import Catalog, make_cloud_catalog
    from ..device import resolve_device
    from ..fleet import TenantSpec, make_trace, replay_fleet
    from ..obs import (ReplayReport, telemetry, write_chrome_trace,
                       write_jsonl)

    device = resolve_device(args.device)
    catalog = Catalog(make_cloud_catalog().instances[::40])
    base = np.array([8.0, 16.0, 4.0, 100.0])
    specs = [
        TenantSpec(name="diurnal", n_starts=2,
                   trace=make_trace("diurnal", base, 4, seed=0,
                                    amplitude=0.3)),
        TenantSpec(name="ramp", n_starts=2,
                   trace=make_trace("ramp", base * 0.6, 4, seed=1)),
    ]
    print(f"[trace-demo] instrumented batched replay on {device}: "
          f"{len(specs)} tenants x 4 ticks, catalog n={catalog.n}")
    with telemetry() as rec:
        res = replay_fleet(catalog, specs, run_ca_baseline=False,
                           replay_mode="batched", hot_loop="kernel",
                           capture_solver_trace=True, device=device)

    path = write_chrome_trace(rec, args.out)
    jsonl = write_jsonl(rec, os.path.splitext(args.out)[0] + ".jsonl")
    failures = validate_artifacts(str(path), str(jsonl))
    if not rec.spans("replay/solve", phase="compile"):
        failures.append("no compile-tagged replay/solve span recorded")
    n_traces = sum(len(t) for t in (res.solver_traces or []))
    if n_traces == 0:
        failures.append("replay captured no per-lane solver traces")

    print(ReplayReport.from_recorder(rec).render())
    print(f"[trace-demo] wrote {path} ({len(rec.events)} spans) and {jsonl}")
    print(f"[trace-demo] {n_traces} per-lane solver traces captured")
    if failures:
        print(f"[trace-demo] FAILED — {len(failures)} problem(s):")
        for f in failures:
            print(f"  {f}")
        return 1
    print("[trace-demo] OK — both artifacts validate; open the trace at "
          "https://ui.perfetto.dev")
    return 0


if __name__ == "__main__":
    sys.exit(main())
