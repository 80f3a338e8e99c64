"""Nested timing spans, counters and gauges behind a contextvar Recorder —
port of ``repro.obs.telemetry``.

The observability contract of this repo, in one sentence: **telemetry may
measure the system but never participate in it**. Concretely:

* When no recorder is installed (the default), every instrumentation point
  degenerates to one ``ContextVar.get`` returning ``None`` plus a shared
  no-op context manager — no allocation, no clock read, no fencing. The
  instrumented code paths are the production code paths.
* When a recorder IS installed, spans read the monotonic clock and
  (optionally) fence CUDA's asynchronous launches with
  ``torch.cuda.synchronize`` on every device a fenced tensor lives on —
  which forces *completion*, never *recomputation*: device values are
  untouched, so per-tenant integer allocations are bit-identical with
  telemetry on or off.

Span model
----------

A span is a named wall-clock interval with a category, free-form tags and
an implicit parent (the innermost open span on the recorder's stack —
spans nest like call frames; export reconstructs the tree from interval
containment). Spans that wrap device work should:

1. pass ``fence=...`` (tensors, or tuples, lists and dicts of them) or
   call ``Span.fence(x)`` before the span closes, so asynchronous launches
   cannot leak the device time into whatever span comes next, and
2. pass a hashable ``compile_key`` identifying the program (function name
   + shapes/args). The FIRST span per recorder to see a given key is
   tagged ``phase="compile"`` (on the card its duration includes building
   or loading the kernel libraries and the first launches); later spans
   with the same key are ``phase="execute"`` (steady state).

Counters are monotonic sums (``counter("replay/solver_iters", 42)``);
gauges are timestamped samples (``gauge("stack/padding_waste", 0.37)``).
Both land in the export stream alongside spans.

Usage::

    from repro_torch.obs import telemetry, span

    with telemetry() as rec:
        with span("replay/solve", compile_key=("warm", 32, 4)) as sp:
            res = solve_fleet_step(batch, X, delta)
            sp.fence(res.x_int)
    print(rec.summary())

All timestamps are microseconds since the recorder was installed
(monotonic, ``time.perf_counter_ns`` based) — the unit Chrome trace events
use natively.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

__all__ = ["Recorder", "SpanEvent", "Span", "telemetry", "current_recorder",
           "span", "counter", "gauge"]


@dataclass
class SpanEvent:
    """One closed span: a named wall-clock interval plus its context.

    ``ts_us``/``dur_us`` are microseconds (start relative to the recorder's
    installation, duration of the interval). ``depth`` is the nesting level
    at open time (0 = top-level). ``phase`` is ``"compile"`` for the first
    span of a ``compile_key``, ``"execute"`` for repeats, and ``None`` for
    spans that never declared a key (pure-host work). ``tags`` carries the
    caller's free-form annotations (bucket dims, tick index, engine...)."""

    name: str
    cat: str
    ts_us: float
    dur_us: float
    depth: int
    phase: Optional[str] = None
    tags: Dict[str, Any] = field(default_factory=dict)


def _cuda_devices(x, out: set) -> set:
    """The CUDA devices of every tensor in ``x`` (a tensor, or tuples,
    lists and dicts of them; anything else is skipped)."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            out.add(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, out)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _cuda_devices(v, out)
    return out


class Span:
    """An OPEN span handle (yielded by :func:`span` while recording).

    ``fence(x)`` waits for every CUDA device that a tensor in ``x`` lives
    on and returns ``x`` unchanged — call it on the device call's result so
    the span measures completed device work, not launches. CPU tensors need
    no wait. ``tag(k, v)`` attaches tags after opening."""

    __slots__ = ("_rec", "name", "cat", "tags", "_t0", "_depth", "phase")

    def __init__(self, rec: "Recorder", name: str, cat: str,
                 tags: Dict[str, Any], depth: int, phase: Optional[str]):
        self._rec = rec
        self.name = name
        self.cat = cat
        self.tags = tags
        self._depth = depth
        self.phase = phase
        self._t0 = time.perf_counter_ns()

    def fence(self, x):
        """Synchronize every CUDA device of ``x``'s tensors; returns ``x``."""
        for dev in _cuda_devices(x, set()):
            torch.cuda.synchronize(dev)
        return x

    def tag(self, **kv) -> "Span":
        """Attach tags to the open span; returns self for chaining."""
        self.tags.update(kv)
        return self

    def _close(self) -> None:
        t1 = time.perf_counter_ns()
        self._rec._events.append(SpanEvent(
            name=self.name, cat=self.cat,
            ts_us=(self._t0 - self._rec._t0_ns) / 1e3,
            dur_us=(t1 - self._t0) / 1e3,
            depth=self._depth, phase=self.phase, tags=self.tags))


class _NoopSpan:
    """The shared do-nothing span handle returned while telemetry is off.

    ``fence`` is a true no-op: with no recorder there is nothing to time,
    so the production path never pays a ``torch.cuda.synchronize``."""

    __slots__ = ()

    def fence(self, x):
        """Return ``x`` untouched (no sync — telemetry is off)."""
        return x

    def tag(self, **kv) -> "_NoopSpan":
        """Ignore tags; returns self."""
        return self


_NOOP_SPAN = _NoopSpan()


class Recorder:
    """Collects spans, counters and gauges for one instrumented region.

    Install via :func:`telemetry`; read back through ``events`` /
    ``counters`` / ``gauges``. Not thread-safe by design — one recorder
    instruments one (single-threaded) replay/bench run; the contextvar
    scoping keeps concurrent asyncio tasks from sharing one by accident."""

    def __init__(self) -> None:
        self._t0_ns = time.perf_counter_ns()
        self._events: List[SpanEvent] = []
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, List[Tuple[float, float]]] = {}
        self._depth = 0
        self._seen_keys: set = set()

    # -- recording ----------------------------------------------------------

    @contextmanager
    def span(self, name: str, cat: str = "span",
             compile_key: Optional[Any] = None,
             fence: Optional[Any] = None, **tags) -> Iterator[Span]:
        """Open a nested span; see module docstring for the span model.

        ``compile_key`` (hashable) tags this span ``phase="compile"`` the
        first time the key is seen by this recorder, ``"execute"`` after.
        ``fence`` optionally names a pytree to ``block_until_ready`` at
        close (equivalent to calling ``Span.fence`` last)."""
        phase = None
        if compile_key is not None:
            first = compile_key not in self._seen_keys
            if first:
                self._seen_keys.add(compile_key)
            phase = "compile" if first else "execute"
        sp = Span(self, name, cat, dict(tags), self._depth, phase)
        self._depth += 1
        try:
            yield sp
        finally:
            if fence is not None:
                sp.fence(fence)
            self._depth -= 1
            sp._close()

    def counter(self, name: str, inc: float = 1.0) -> None:
        """Add ``inc`` to the monotonic counter ``name``."""
        self.counters[name] = self.counters.get(name, 0.0) + float(inc)

    def gauge(self, name: str, value: float) -> None:
        """Record a timestamped sample of gauge ``name``."""
        now = (time.perf_counter_ns() - self._t0_ns) / 1e3
        self.gauges.setdefault(name, []).append((now, float(value)))

    # -- reading back -------------------------------------------------------

    @property
    def events(self) -> List[SpanEvent]:
        """All closed spans, in close order."""
        return list(self._events)

    def spans(self, name: Optional[str] = None,
              phase: Optional[str] = None) -> List[SpanEvent]:
        """Closed spans filtered by exact name and/or phase."""
        return [e for e in self._events
                if (name is None or e.name == name)
                and (phase is None or e.phase == phase)]

    def total_us(self, name: str, phase: Optional[str] = None) -> float:
        """Summed duration (µs) of all spans named ``name``."""
        return sum(e.dur_us for e in self.spans(name, phase))

    def summary(self) -> str:
        """A quick per-name rollup (count, total ms, compile/execute split)
        for interactive use."""
        by_name: Dict[str, List[SpanEvent]] = {}
        for e in self._events:
            by_name.setdefault(e.name, []).append(e)
        lines = [f"telemetry: {len(self._events)} spans, "
                 f"{len(self.counters)} counters, {len(self.gauges)} gauges"]
        for name in sorted(by_name):
            evs = by_name[name]
            tot = sum(e.dur_us for e in evs) / 1e3
            comp = sum(e.dur_us for e in evs if e.phase == "compile") / 1e3
            line = f"  {name:<28s} n={len(evs):<5d} total {tot:9.1f}ms"
            if comp:
                line += f"  (compile {comp:.1f}ms)"
            lines.append(line)
        for name in sorted(self.counters):
            lines.append(f"  counter {name:<20s} {self.counters[name]:g}")
        return "\n".join(lines)


_RECORDER: ContextVar[Optional[Recorder]] = ContextVar(
    "repro_torch_obs_recorder", default=None)


def current_recorder() -> Optional[Recorder]:
    """The recorder installed in this context, or None (telemetry off)."""
    return _RECORDER.get()


@contextmanager
def telemetry(enabled: bool = True) -> Iterator[Optional[Recorder]]:
    """Install a fresh :class:`Recorder` for the enclosed block.

    ``with telemetry() as rec: ...`` — every :func:`span` / :func:`counter`
    / :func:`gauge` call inside the block (any module, any call depth)
    records into ``rec``. ``telemetry(enabled=False)`` is an explicit
    no-op scope (yields None), handy for flag-driven call sites. Nested
    ``telemetry()`` blocks shadow the outer recorder and restore it on
    exit (contextvar token reset)."""
    if not enabled:
        yield None
        return
    rec = Recorder()
    token = _RECORDER.set(rec)
    try:
        yield rec
    finally:
        _RECORDER.reset(token)


def span(name: str, cat: str = "span", compile_key: Optional[Any] = None,
         fence: Optional[Any] = None, **tags):
    """Module-level span entry point — THE instrumentation call sites use.

    With a recorder installed this is ``recorder.span(...)``; without one
    it returns a shared no-op context manager whose ``fence`` does nothing
    — the disabled cost is one contextvar read. See the module docstring
    for ``compile_key`` (compile-vs-execute tagging) and fencing."""
    rec = _RECORDER.get()
    if rec is None:
        return _NOOP_CM
    return rec.span(name, cat=cat, compile_key=compile_key, fence=fence,
                    **tags)


class _NoopContext:
    """Reusable, reentrant no-op context manager (the disabled span path:
    no generator, no allocation — one shared instance serves every call)."""

    __slots__ = ()

    def __enter__(self) -> _NoopSpan:
        return _NOOP_SPAN

    def __exit__(self, *exc) -> bool:
        return False


_NOOP_CM = _NoopContext()


def counter(name: str, inc: float = 1.0) -> None:
    """Bump counter ``name`` on the installed recorder (no-op when off)."""
    rec = _RECORDER.get()
    if rec is not None:
        rec.counter(name, inc)


def gauge(name: str, value: float) -> None:
    """Sample gauge ``name`` on the installed recorder (no-op when off)."""
    rec = _RECORDER.get()
    if rec is not None:
        rec.gauge(name, value)
