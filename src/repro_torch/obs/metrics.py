"""Typed metric registry: counters, gauges and fixed-bucket log2 histograms
— port of ``repro.obs.metrics``.

``repro_torch.obs.telemetry`` answers "where did the wall time go" for ONE
instrumented run; this module is the production-metrics counterpart — the
numbers a fleet operator would scrape: monotonically increasing counters
(SLO-breach ticks, deadline misses), last-value gauges (worst KKT residual)
and latency/effort HISTOGRAMS with p50/p95/p99 estimation, exported as a
Prometheus textfile or a JSON snapshot.

Design rules (shared with the rest of ``repro_torch.obs``):

* **No-op when disabled.** Module-level helpers (:func:`inc`,
  :func:`set_gauge`, :func:`observe`, :func:`observe_counts`) cost one
  ``ContextVar.get`` returning ``None`` when no registry is installed —
  the instrumented paths are the production paths, and per-tenant integer
  allocations are bit-identical with metrics on or off.
* **Device-side hot path.** Histogram accumulation of device values uses
  :func:`bucket_counts`: a fixed-shape torch reduction (scatter-add into
  ``(n_buckets,)``) on the values' own device, with no host read. The
  replay loops merge the fixed-shape counts into the host-side
  :class:`Histogram` once per tick (:func:`Histogram.merge` /
  :func:`observe_counts`) — device code never touches Python metric state.
* **Fixed log2 buckets.** Bucket ``i`` (``1 <= i <= n_core``) covers
  ``[2^(lo_exp+i-1), 2^(lo_exp+i))``; bucket 0 is underflow (``v <
  2^lo_exp``, zeros and negatives included), the last bucket overflow
  (``v >= 2^hi_exp``). Fixed edges mean histograms from different ticks,
  lanes or processes merge by vector addition — no rebinning, ever.

Quantile estimates interpolate linearly inside the containing bucket and
are clamped to the observed ``[min, max]``, so they are exact for constant
streams and within one log2 bucket of the true quantile otherwise
(test-enforced against ``numpy.quantile`` in ``tests/obs/test_metrics.py``).

Prometheus naming scheme: every exported
series is ``repro_<name>`` with ``.``/``/`` mapped to ``_``; counters get
a ``_total`` suffix; histograms emit cumulative ``_bucket{le=...}`` rows
plus ``_sum``/``_count``. Units are part of the metric name (``_ms``,
``_ticks``, ``_iters``).

Usage::

    from repro_torch.obs import collect_metrics, observe, inc

    with collect_metrics() as reg:
        inc("replay/slo_breach_ticks")
        observe("replay/tick_ms", 12.5)
    print(reg.to_prometheus())
"""
from __future__ import annotations

import json
import math
import re
from contextlib import contextmanager
from contextvars import ContextVar
from pathlib import Path
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Union

import numpy as np
import torch

__all__ = ["HistCounts", "bucket_counts", "Counter", "Gauge", "Histogram",
           "MetricRegistry", "collect_metrics", "current_metrics", "inc",
           "set_gauge", "observe", "observe_counts", "DEFAULT_LO_EXP",
           "DEFAULT_HI_EXP"]

# Default bucket range: 2^-10 (~1e-3) .. 2^20 (~1e6) — covers sub-ms tick
# latencies up to million-scale iteration counts with 30 log2 buckets.
DEFAULT_LO_EXP = -10
DEFAULT_HI_EXP = 20


class HistCounts(NamedTuple):
    """Fixed-shape histogram accumulation state (device- or host-side).

    ``counts`` has ``hi_exp - lo_exp + 2`` entries (underflow + log2 core
    + overflow); ``total``/``n`` are the sum and count of FINITE observed
    values, ``vmin``/``vmax`` their range (+inf/-inf when none), and
    ``nonfinite`` the number of NaN/Inf samples excluded from every other
    field. The leaves are tensors on the values' device (or numpy values
    on the host side)."""

    counts: Any      # (n_buckets,) int32
    total: Any       # () float32 sum of finite values
    n: Any           # () int32 count of finite values
    vmin: Any        # () float32 min of finite values (+inf when none)
    vmax: Any        # () float32 max of finite values (-inf when none)
    nonfinite: Any   # () int32 count of NaN/Inf samples


def _n_buckets(lo_exp: int, hi_exp: int) -> int:
    return hi_exp - lo_exp + 2


def bucket_counts(values, lo_exp: int = DEFAULT_LO_EXP,
                  hi_exp: int = DEFAULT_HI_EXP) -> HistCounts:
    """Fixed-shape histogram pass over ``values`` (any shape) on their own
    device — the reference's jnp reduction in torch, float32 throughout
    and with its log2, so the bucket counts equal the reference's. Output shapes depend only
    on ``(lo_exp, hi_exp)``; nothing is read back to the host. Non-finite
    samples are excluded from the buckets/sum/min/max and tallied in
    ``nonfinite``. Merge the result into a host :class:`Histogram` with
    :func:`Histogram.merge` (or :func:`observe_counts`) once per tick."""
    nb = _n_buckets(lo_exp, hi_exp)
    v = torch.as_tensor(values).to(torch.float32).reshape(-1)
    finite = torch.isfinite(v)
    vf = torch.where(finite, v, torch.zeros_like(v))
    # exponent -> bucket index; underflow (v < 2^lo, zeros/negatives) -> 0,
    # overflow (v >= 2^hi) -> nb-1. The clamp keeps log2's domain safe.
    # log2 as the reference's jnp.log2 lowers on XLA: log(v) * (1 / ln 2)
    # in float32, which puts some exact powers of two (2^13, 2^15) one
    # bucket low; torch.log2 would not, and the counts would differ there
    lg = torch.log(torch.clamp(vf, min=2.0 ** (lo_exp - 1)))
    e = torch.floor(lg * torch.tensor(1.0 / math.log(2.0),
                                      dtype=torch.float32, device=v.device))
    idx = torch.clamp(e.to(torch.int32) - lo_exp + 1, 0, nb - 1)
    idx = torch.where(vf < 2.0 ** lo_exp, torch.zeros_like(idx), idx)
    w = finite.to(torch.int32)
    counts = torch.zeros(nb, dtype=torch.int32, device=v.device)
    counts.scatter_add_(0, idx.to(torch.int64), w)
    inf = torch.full_like(v, float("inf"))
    return HistCounts(
        counts=counts,
        total=vf.sum(),
        n=w.sum(),
        vmin=torch.where(finite, v, inf).amin() if v.numel()
        else torch.tensor(float("inf"), device=v.device),
        vmax=torch.where(finite, v, -inf).amax() if v.numel()
        else torch.tensor(float("-inf"), device=v.device),
        nonfinite=(1 - w).sum(),
    )


_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    """Map a registry metric name to a legal Prometheus series name:
    ``repro_`` prefix, path separators and other illegal chars -> ``_``."""
    clean = _NAME_RE.sub("_", name)
    if not clean.startswith("repro_"):
        clean = "repro_" + clean
    return clean


class Counter:
    """A monotonically increasing sum (exported as ``<name>_total``)."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        """Add ``v`` (must be >= 0: counters only go up)."""
        v = float(v)
        if v < 0:
            raise ValueError(f"counter {self.name!r}: negative increment {v}")
        self.value += v


class Gauge:
    """A last-value sample with running min/max/n (exported as-is)."""

    __slots__ = ("name", "help", "value", "vmin", "vmax", "n")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value: Optional[float] = None
        self.vmin = math.inf
        self.vmax = -math.inf
        self.n = 0

    def set(self, v: float) -> None:
        """Record a sample; ``value`` keeps the last one."""
        v = float(v)
        self.value = v
        if math.isfinite(v):
            self.vmin = min(self.vmin, v)
            self.vmax = max(self.vmax, v)
        self.n += 1


class Histogram:
    """Fixed-bucket log2 histogram with quantile estimation.

    Host-side accumulation via :meth:`observe` (scalar or array) or
    :meth:`merge` (a device-computed :class:`HistCounts`). Bucket layout is
    identical to :func:`bucket_counts`, so the two paths agree exactly."""

    __slots__ = ("name", "help", "lo_exp", "hi_exp", "counts", "total",
                 "vmin", "vmax", "nonfinite")

    def __init__(self, name: str, help: str = "",
                 lo_exp: int = DEFAULT_LO_EXP, hi_exp: int = DEFAULT_HI_EXP):
        if hi_exp <= lo_exp:
            raise ValueError(f"histogram {name!r}: hi_exp must exceed lo_exp")
        self.name = name
        self.help = help
        self.lo_exp = lo_exp
        self.hi_exp = hi_exp
        self.counts = np.zeros(_n_buckets(lo_exp, hi_exp), np.int64)
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.nonfinite = 0

    # -- accumulation -------------------------------------------------------

    def observe(self, values) -> None:
        """Host-side accumulation of a scalar or array of samples."""
        v = np.asarray(values, np.float64).ravel()
        finite = np.isfinite(v)
        self.nonfinite += int((~finite).sum())
        v = v[finite]
        if v.size == 0:
            return
        nb = self.counts.shape[0]
        with np.errstate(divide="ignore"):
            e = np.floor(np.log2(np.maximum(v, 2.0 ** (self.lo_exp - 1))))
        idx = np.clip(e.astype(np.int64) - self.lo_exp + 1, 0, nb - 1)
        idx[v < 2.0 ** self.lo_exp] = 0
        np.add.at(self.counts, idx, 1)
        self.total += float(v.sum())
        self.vmin = min(self.vmin, float(v.min()))
        self.vmax = max(self.vmax, float(v.max()))

    def merge(self, hc: HistCounts) -> None:
        """Merge a device-computed fixed-shape :class:`HistCounts` (from
        :func:`bucket_counts` with the SAME bucket range) — the host-side
        per-tick merge of the device hot path (one host read)."""
        hc = HistCounts(*(f.cpu().numpy() if torch.is_tensor(f) else f
                          for f in hc))
        counts = np.asarray(hc.counts, np.int64)
        if counts.shape != self.counts.shape:
            raise ValueError(
                f"histogram {self.name!r}: merge got {counts.shape[0]} "
                f"buckets, layout has {self.counts.shape[0]} (lo_exp/hi_exp "
                f"must match bucket_counts)")
        self.counts += counts
        self.total += float(hc.total)
        self.nonfinite += int(hc.nonfinite)
        if int(np.asarray(hc.n)) > 0:
            self.vmin = min(self.vmin, float(hc.vmin))
            self.vmax = max(self.vmax, float(hc.vmax))

    # -- reading back -------------------------------------------------------

    @property
    def count(self) -> int:
        """Number of finite samples observed."""
        return int(self.counts.sum())

    @property
    def edges(self) -> List[float]:
        """Upper bucket edges (``le`` values): ``2^lo_exp .. 2^hi_exp``;
        the final overflow bucket's edge is +inf."""
        return [2.0 ** e for e in range(self.lo_exp, self.hi_exp + 1)] \
            + [math.inf]

    def quantile(self, q: float) -> Optional[float]:
        """Estimate the ``q``-quantile (``q`` in [0, 100]) by linear
        interpolation inside the containing log2 bucket, clamped to the
        observed ``[min, max]`` — exact for constant streams, within one
        bucket otherwise. None when empty."""
        total = self.count
        if total == 0:
            return None
        target = (q / 100.0) * total
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo = (self.vmin if i == 0
                      else 2.0 ** (self.lo_exp + i - 1))
                hi = (self.vmax if i == self.counts.shape[0] - 1
                      else 2.0 ** (self.lo_exp + i))
                frac = (target - cum) / c
                est = lo + (hi - lo) * min(max(frac, 0.0), 1.0)
                return float(min(max(est, self.vmin), self.vmax))
            cum += c
        return float(self.vmax)

    def percentiles(self) -> Dict[str, Optional[float]]:
        """The standard p50/p95/p99 triple."""
        return {"p50": self.quantile(50), "p95": self.quantile(95),
                "p99": self.quantile(99)}


class MetricRegistry:
    """Get-or-create store of named metrics plus the two exporters.

    One registry instruments one run (like ``telemetry``'s Recorder).
    Re-requesting a name returns the SAME metric object; requesting an
    existing name as a different type raises."""

    def __init__(self) -> None:
        self._metrics: Dict[str, Union[Counter, Gauge, Histogram]] = {}

    def _get(self, name: str, cls, **kwargs):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, **kwargs)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, requested {cls.__name__}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        """Get-or-create the counter ``name``."""
        return self._get(name, Counter, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        """Get-or-create the gauge ``name``."""
        return self._get(name, Gauge, help=help)

    def histogram(self, name: str, help: str = "",
                  lo_exp: int = DEFAULT_LO_EXP,
                  hi_exp: int = DEFAULT_HI_EXP) -> Histogram:
        """Get-or-create the histogram ``name`` (bucket range is fixed at
        creation; later calls ignore ``lo_exp``/``hi_exp``)."""
        return self._get(name, Histogram, help=help, lo_exp=lo_exp,
                         hi_exp=hi_exp)

    # -- exporters ----------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready snapshot: counters/gauges as numbers, histograms as
        bucket vectors plus count/sum/min/max and the p50/p95/p99 triple."""
        out: Dict[str, Any] = {"counters": {}, "gauges": {}, "histograms": {}}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if isinstance(m, Counter):
                out["counters"][name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][name] = {
                    "value": m.value, "n": m.n,
                    "min": None if m.n == 0 or not math.isfinite(m.vmin)
                    else m.vmin,
                    "max": None if m.n == 0 or not math.isfinite(m.vmax)
                    else m.vmax}
            else:
                pct = m.percentiles()
                out["histograms"][name] = {
                    "lo_exp": m.lo_exp, "hi_exp": m.hi_exp,
                    "counts": [int(c) for c in m.counts],
                    "count": m.count, "sum": m.total,
                    "nonfinite": m.nonfinite,
                    "min": None if m.count == 0 else m.vmin,
                    "max": None if m.count == 0 else m.vmax,
                    **pct}
        return out

    def write_snapshot(self, path: Union[str, Path]) -> Path:
        """Write :meth:`snapshot` as JSON; returns the path written."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.snapshot(), indent=1, sort_keys=True)
                        + "\n")
        return path

    def to_prometheus(self) -> str:
        """Render every metric in the Prometheus text exposition format
        (textfile-collector ready): ``# HELP``/``# TYPE`` headers, counters
        as ``_total``, histograms as cumulative ``_bucket{le=...}`` rows
        plus ``_sum``/``_count``."""
        lines: List[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            pname = _prom_name(name)
            if isinstance(m, Counter):
                if not pname.endswith("_total"):
                    pname += "_total"
                if m.help:
                    lines.append(f"# HELP {pname} {m.help}")
                lines.append(f"# TYPE {pname} counter")
                lines.append(f"{pname} {m.value:g}")
            elif isinstance(m, Gauge):
                if m.help:
                    lines.append(f"# HELP {pname} {m.help}")
                lines.append(f"# TYPE {pname} gauge")
                val = m.value if m.value is not None else math.nan
                lines.append(f"{pname} {val:g}")
            else:
                if m.help:
                    lines.append(f"# HELP {pname} {m.help}")
                lines.append(f"# TYPE {pname} histogram")
                cum = 0
                for edge, c in zip(m.edges, m.counts):
                    cum += int(c)
                    le = "+Inf" if math.isinf(edge) else f"{edge:g}"
                    lines.append(f'{pname}_bucket{{le="{le}"}} {cum}')
                lines.append(f"{pname}_sum {m.total:g}")
                lines.append(f"{pname}_count {m.count}")
        return "\n".join(lines) + ("\n" if lines else "")

    def write_prometheus(self, path: Union[str, Path]) -> Path:
        """Write :meth:`to_prometheus` to a textfile; returns the path."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(self.to_prometheus())
        return path


# ---------------------------------------------------------------------------
# contextvar scoping — the no-op disabled path (mirrors obs.telemetry)
# ---------------------------------------------------------------------------

_METRICS: ContextVar[Optional[MetricRegistry]] = ContextVar(
    "repro_torch_obs_metrics", default=None)


def current_metrics() -> Optional[MetricRegistry]:
    """The registry installed in this context, or None (metrics off)."""
    return _METRICS.get()


@contextmanager
def collect_metrics(enabled: bool = True,
                    registry: Optional[MetricRegistry] = None
                    ) -> Iterator[Optional[MetricRegistry]]:
    """Install a :class:`MetricRegistry` for the enclosed block.

    ``with collect_metrics() as reg:`` — every module-level :func:`inc` /
    :func:`set_gauge` / :func:`observe` / :func:`observe_counts` call
    inside the block records into ``reg``. Pass ``registry=`` to install an
    existing registry (e.g. one shared with a
    :class:`repro_torch.obs.health.HealthMonitor`); ``enabled=False`` is an
    explicit no-op scope. Nested scopes shadow and restore, exactly like
    ``repro_torch.obs.telemetry``."""
    if not enabled:
        yield None
        return
    reg = registry if registry is not None else MetricRegistry()
    token = _METRICS.set(reg)
    try:
        yield reg
    finally:
        _METRICS.reset(token)


def inc(name: str, v: float = 1.0) -> None:
    """Bump counter ``name`` on the installed registry (no-op when off)."""
    reg = _METRICS.get()
    if reg is not None:
        reg.counter(name).inc(v)


def set_gauge(name: str, value: float) -> None:
    """Sample gauge ``name`` on the installed registry (no-op when off)."""
    reg = _METRICS.get()
    if reg is not None:
        reg.gauge(name).set(value)


def observe(name: str, values) -> None:
    """Host-side histogram observation (scalar or array; no-op when off)."""
    reg = _METRICS.get()
    if reg is not None:
        reg.histogram(name).observe(values)


def observe_counts(name: str, hc: HistCounts) -> None:
    """Merge device-computed :func:`bucket_counts` into histogram ``name``
    (the per-tick host-side merge of the device path; no-op when off)."""
    reg = _METRICS.get()
    if reg is not None:
        reg.histogram(name).merge(hc)
