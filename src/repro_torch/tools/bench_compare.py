"""Compare two BENCH JSON files and fail on a regression — port of the
reference's ``tools/bench_compare.py``.

Thin CLI over :mod:`repro_torch.obs.regress` — all comparison policy
(metric classification, per-class tolerances, provenance-aware refusal)
lives there; this module only parses arguments, loads JSON and maps
outcomes to exit codes:

* **0** — comparable, no metric regressed past its class tolerance;
* **1** — comparable, and at least one metric regressed;
* **2** — NOT comparable: schema-invalid BENCH doc, config-digest
  mismatch, or platform/backend mismatch without
  ``--allow-cross-platform``. Distinct from 1 so a stale baseline reads as
  "refresh the baseline", not "you slowed the code down".

``--selftest BENCH.json`` proves the sentinel actually bites: the doc is
compared against perturbed copies of itself — a +25% inflation of every
timing leaf must fail at the default 20% timing tolerance, a +2%
inflation of the objective leaves must fail at the 1% objective
tolerance, and the identity comparison must pass. Exit 0 only when all
three hold.

Usage:
  PYTHONPATH=src python -m repro_torch.tools.bench_compare BASE.json \\
      CAND.json [--timing-rtol 0.2] [--objective-rtol 0.01] \\
      [--allow-cross-platform]
  PYTHONPATH=src python -m repro_torch.tools.bench_compare --selftest \\
      BENCH.json
"""
from __future__ import annotations

import argparse
import copy
import json
import sys
from typing import Optional, Sequence

from ..obs.regress import classify_metric, compare_bench, numeric_leaves


def _load(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _set_path(doc, path: str, value) -> None:
    """Set a dotted-path leaf (as produced by ``numeric_leaves``) in a
    nested dict/list document; list segments are integer indices."""
    node = doc
    parts = path.split(".")
    for part in parts[:-1]:
        node = node[int(part)] if isinstance(node, list) else node[part]
    last = parts[-1]
    if isinstance(node, list):
        node[int(last)] = value
    else:
        node[last] = value


def _perturbed(doc: dict, kinds: tuple, factor: float) -> dict:
    """Copy ``doc`` with every nonzero numeric leaf of the given metric
    classes scaled by ``factor`` (regression direction for lower-better
    classes when factor > 1). Returns the copy and leaves others intact."""
    out = copy.deepcopy(doc)
    touched = 0
    for path, val in numeric_leaves(doc).items():
        if classify_metric(path) in kinds and abs(val) > 1e-9:
            _set_path(out, path, val * factor)
            touched += 1
    if touched == 0:
        raise SystemExit(f"selftest: doc has no nonzero {kinds} leaves "
                         f"to perturb")
    return out


def _selftest(path: str) -> int:
    doc = _load(path)
    failures = []

    ident = compare_bench(doc, doc)
    if not ident.ok or ident.refusals:
        failures.append("identity comparison did not pass cleanly:\n"
                        + ident.summary())

    slow = compare_bench(doc, _perturbed(doc, ("timing",), 1.25),
                         timing_rtol=0.2)
    if slow.ok or not any(d.kind == "timing" for d in slow.regressions):
        failures.append("+25% timing perturbation was NOT caught at "
                        "timing_rtol=0.2:\n" + slow.summary())

    worse = compare_bench(doc, _perturbed(doc, ("objective",), 1.02),
                          objective_rtol=0.01)
    if worse.ok or not any(d.kind == "objective" for d in worse.regressions):
        failures.append("+2% objective perturbation was NOT caught at "
                        "objective_rtol=0.01:\n" + worse.summary())

    if failures:
        print(f"[bench-compare] SELFTEST FAILED ({len(failures)}):")
        for f in failures:
            print(f"  {f}")
        return 1
    print("[bench-compare] selftest OK — identity passes; +25% timing and "
          "+2% objective regressions are both caught")
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Compare two BENCH JSON files; nonzero exit on "
                    "regression (1) or non-comparable pair (2).")
    ap.add_argument("base", nargs="?", help="baseline (golden) BENCH json")
    ap.add_argument("cand", nargs="?", help="candidate (fresh) BENCH json")
    ap.add_argument("--timing-rtol", type=float, default=0.2,
                    help="allowed relative regression for timing/throughput "
                         "metrics (default 0.2)")
    ap.add_argument("--objective-rtol", type=float, default=0.01,
                    help="allowed relative regression for objective/quality "
                         "metrics (default 0.01)")
    ap.add_argument("--allow-cross-platform", action="store_true",
                    help="on platform/backend mismatch, skip timing metrics "
                         "instead of refusing (objective still compared)")
    ap.add_argument("--selftest", metavar="BENCH.json",
                    help="prove the sentinel catches injected regressions "
                         "in this doc, then exit")
    args = ap.parse_args(argv)

    if args.selftest:
        return _selftest(args.selftest)
    if not args.base or not args.cand:
        ap.error("BASE and CAND are required (or use --selftest)")

    cmp = compare_bench(
        _load(args.base), _load(args.cand),
        timing_rtol=args.timing_rtol, objective_rtol=args.objective_rtol,
        allow_cross_platform=args.allow_cross_platform)
    print(f"[bench-compare] {args.base} vs {args.cand}")
    print(cmp.summary())
    if cmp.refusals:
        return 2
    return 0 if cmp.ok else 1


if __name__ == "__main__":
    sys.exit(main())
