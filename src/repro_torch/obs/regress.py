"""A copy of ``repro.obs.regress`` (stdlib only; a test pins its code to
the original's, statement for statement).

The bench regression sentinel: schema-validate and compare BENCH JSON
documents. It is the comparison engine behind
``python -m repro_torch.tools.bench_compare``:

* :func:`validate_bench` — structural gate: a BENCH doc must carry a
  provenance block and at least one numeric metric.
* :func:`compare_bench` — walks the two docs' shared numeric leaves,
  classifies each metric path (timing / throughput / objective / quality —
  see :func:`classify_metric`), and checks the candidate against the
  baseline under PER-CLASS relative tolerances: timings may regress by
  ``timing_rtol`` (noisy), objectives only by ``objective_rtol`` (a worse
  J is a solver bug, not noise). Improvements never fail.

**Provenance-aware refusal**: tolerances are meaningless across different
experiments or machines, so the comparison REFUSES (distinct from failing)
when the two provenance blocks' ``config_digest`` differ (always — a
different config is a different workload) or when platform/backend differ
(unless ``allow_cross_platform=True``, which skips TIMING comparisons but
still compares the deterministic objective metrics). As in the reference,
only ``platform`` and ``backend`` are compared: two cards of other models
or power limits under one platform string are not refused, so a caller
comparing card timings checks the provenance's ``device`` and
``power_limit`` itself.

Unclassified metric paths are reported as skipped, never silently dropped
— a comparison that ignored half the file must say so.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["classify_metric", "validate_bench", "compare_bench",
           "MetricDelta", "BenchComparison", "numeric_leaves"]

# subtrees that are provenance/config, not metrics
_META_KEYS = ("provenance", "config")

# classification tables: (substring, class). First match on the FULL
# dotted path (lowercased) wins; later entries are fallbacks on the leaf
# key. Classes: lower-better "timing"/"objective", higher-better
# "throughput"/"quality".
_LEAF_RULES: Tuple[Tuple[str, str], ...] = (
    ("speedup", "throughput"),
    ("ticks_per_s", "throughput"),
    ("per_sec", "throughput"),
    ("savings_vs_ca_pct", "quality"),
    ("cost_savings", "quality"),
    ("t_compile", "timing"),
    ("t_execute", "timing"),
    ("t_replay", "timing"),
    ("t_fleet", "timing"),
    ("t_naive", "timing"),
    ("compile_ms", "timing"),
    ("execute_ms", "timing"),
    ("steady_ms", "timing"),
    ("tick_ms", "timing"),
    ("_ms", "timing"),
    ("t_total", "timing"),
    ("objective", "objective"),
    ("cost_integral", "objective"),
    ("slo_ticks", "objective"),
    ("slo_violation", "objective"),
    ("slo_breach", "objective"),
    ("nonfinite", "objective"),
    ("stall", "objective"),
    ("interruption", "objective"),
    ("churn", "objective"),
    ("regret", "objective"),
    ("fun_int", "objective"),
    ("cost", "objective"),
)


def classify_metric(path: str) -> Optional[str]:
    """Classify a dotted metric path: ``"timing"`` / ``"throughput"``
    (wall-clock, noisy, lower/higher-better), ``"objective"`` /
    ``"quality"`` (deterministic solution metrics, lower/higher-better),
    or None (not compared; reported as skipped)."""
    lower = path.lower()
    leaf = lower.rsplit(".", 1)[-1]
    for pat, cls in _LEAF_RULES:
        if pat in leaf:
            return cls
    # path-level fallback: a leaf nested under a timing-ish section
    for pat, cls in _LEAF_RULES:
        if pat in lower:
            return cls
    return None


def numeric_leaves(doc: Any, prefix: str = "") -> Dict[str, float]:
    """Flatten a BENCH doc to ``{dotted.path: value}`` over its numeric
    leaves, skipping the provenance/config subtrees and booleans. List
    elements use their index as a path segment."""
    out: Dict[str, float] = {}
    if isinstance(doc, dict):
        for k, v in doc.items():
            if not prefix and k in _META_KEYS:
                continue
            p = f"{prefix}.{k}" if prefix else str(k)
            out.update(numeric_leaves(v, p))
    elif isinstance(doc, (list, tuple)):
        for i, v in enumerate(doc):
            out.update(numeric_leaves(v, f"{prefix}.{i}" if prefix
                                      else str(i)))
    elif isinstance(doc, (int, float)) and not isinstance(doc, bool):
        out[prefix] = float(doc)
    return out


def validate_bench(doc: Any) -> List[str]:
    """Structural validation of one BENCH doc; returns problems (empty =
    valid). Required: a dict with a ``provenance`` dict carrying at least
    ``platform`` and ``backend`` keys, and >= 1 numeric metric leaf."""
    problems: List[str] = []
    if not isinstance(doc, dict):
        return ["BENCH doc is not a JSON object"]
    prov = doc.get("provenance")
    if not isinstance(prov, dict):
        problems.append("missing provenance block")
    else:
        for key in ("platform", "backend"):
            if key not in prov:
                problems.append(f"provenance missing {key!r}")
    if not numeric_leaves(doc):
        problems.append("no numeric metric leaves found")
    return problems


@dataclass
class MetricDelta:
    """One compared metric: baseline/candidate values, relative change
    (positive = regression direction for its class) and pass/fail."""

    path: str
    kind: str           # timing | throughput | objective | quality
    base: float
    cand: float
    rel_change: float   # signed; > 0 means WORSE for this class
    rtol: float
    ok: bool


@dataclass
class BenchComparison:
    """The outcome of one baseline-vs-candidate comparison.

    ``refusals`` non-empty means the pair was NOT comparable (exit 2 in
    the CLI) — distinct from ``ok=False`` (comparable, and regressed)."""

    ok: bool
    deltas: List[MetricDelta] = field(default_factory=list)
    skipped: List[str] = field(default_factory=list)
    refusals: List[str] = field(default_factory=list)

    @property
    def regressions(self) -> List[MetricDelta]:
        """The failing deltas, worst relative change first."""
        return sorted((d for d in self.deltas if not d.ok),
                      key=lambda d: -d.rel_change)

    def summary(self) -> str:
        """Human-readable report (the CLI's output)."""
        if self.refusals:
            return "REFUSED:\n" + "\n".join(f"  {r}" for r in self.refusals)
        lines = [f"compared {len(self.deltas)} metrics "
                 f"({len(self.skipped)} unclassified skipped)"]
        for d in self.regressions:
            lines.append(f"  REGRESSION {d.path} [{d.kind}]: "
                         f"{d.base:g} -> {d.cand:g} "
                         f"({d.rel_change * 100:+.1f}%, rtol "
                         f"{d.rtol * 100:.0f}%)")
        if not self.regressions:
            worst = max(self.deltas, key=lambda d: d.rel_change,
                        default=None)
            if worst is not None:
                lines.append(f"  OK — worst delta {worst.path} "
                             f"{worst.rel_change * 100:+.1f}% "
                             f"(rtol {worst.rtol * 100:.0f}%)")
            else:
                lines.append("  OK — no shared classified metrics")
        return "\n".join(lines)


def _provenance_refusals(base: Dict, cand: Dict,
                         allow_cross_platform: bool) -> Tuple[List[str], bool]:
    """Compare the two provenance blocks; returns ``(refusals,
    skip_timing)``. Config-digest mismatch always refuses; platform or
    backend mismatch refuses unless ``allow_cross_platform`` — which
    instead drops every timing/throughput comparison (deterministic
    objective metrics survive a machine change; wall time does not)."""
    bp = base.get("provenance") or {}
    cp = cand.get("provenance") or {}
    refusals: List[str] = []
    bd, cd = bp.get("config_digest"), cp.get("config_digest")
    if bd is not None and cd is not None and bd != cd:
        refusals.append(f"config_digest mismatch ({bd} vs {cd}): the two "
                        f"runs measured different experiments")
    skip_timing = False
    for key in ("platform", "backend"):
        bv, cv = bp.get(key), cp.get(key)
        if bv is not None and cv is not None and bv != cv:
            if allow_cross_platform:
                skip_timing = True
            else:
                refusals.append(
                    f"{key} mismatch ({bv!r} vs {cv!r}): timings are not "
                    f"comparable across machines (pass "
                    f"--allow-cross-platform to compare objective metrics "
                    f"only)")
    return refusals, skip_timing


def compare_bench(base: Dict, cand: Dict, *, timing_rtol: float = 0.2,
                  objective_rtol: float = 0.01,
                  allow_cross_platform: bool = False) -> BenchComparison:
    """Compare candidate BENCH doc against a baseline (module docstring).

    A metric FAILS when its regression-direction relative change exceeds
    its class tolerance: timings/throughput vs ``timing_rtol``,
    objective/quality vs ``objective_rtol``. Metrics present in only one
    doc, or unclassified, are reported in ``skipped``."""
    problems = [f"baseline: {p}" for p in validate_bench(base)]
    problems += [f"candidate: {p}" for p in validate_bench(cand)]
    if problems:
        return BenchComparison(ok=False, refusals=problems)
    refusals, skip_timing = _provenance_refusals(base, cand,
                                                 allow_cross_platform)
    if refusals:
        return BenchComparison(ok=False, refusals=refusals)

    b_leaves = numeric_leaves(base)
    c_leaves = numeric_leaves(cand)
    deltas: List[MetricDelta] = []
    skipped: List[str] = []
    for path in sorted(set(b_leaves) | set(c_leaves)):
        if path not in b_leaves or path not in c_leaves:
            skipped.append(f"{path} (only in "
                           f"{'baseline' if path in b_leaves else 'candidate'})")
            continue
        kind = classify_metric(path)
        if kind is None:
            skipped.append(f"{path} (unclassified)")
            continue
        if skip_timing and kind in ("timing", "throughput"):
            skipped.append(f"{path} (timing skipped: cross-platform)")
            continue
        bv, cv = b_leaves[path], c_leaves[path]
        denom = max(abs(bv), 1e-12)
        # signed change, oriented so positive == regression for the class
        if kind in ("timing", "objective"):      # lower is better
            rel = (cv - bv) / denom
        else:                                    # higher is better
            rel = (bv - cv) / denom
        rtol = (timing_rtol if kind in ("timing", "throughput")
                else objective_rtol)
        deltas.append(MetricDelta(path=path, kind=kind, base=bv, cand=cv,
                                  rel_change=rel, rtol=rtol,
                                  ok=rel <= rtol))
    return BenchComparison(ok=all(d.ok for d in deltas), deltas=deltas,
                           skipped=skipped)
