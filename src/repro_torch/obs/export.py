"""Export a :class:`~repro_torch.obs.telemetry.Recorder` to JSONL / Chrome
trace — port of ``repro.obs.export``.

Two formats:

* **JSONL** (:func:`write_jsonl`) — one JSON object per line, one line per
  span/counter/gauge, in close order. Grep-able, diff-able, no schema
  beyond "each line is an event".
* **Chrome trace events** (:func:`to_chrome_trace` /
  :func:`write_chrome_trace`) — the ``chrome://tracing`` / Perfetto JSON
  array format. Spans become complete events (``"ph": "X"``, with
  microsecond ``ts``/``dur``); gauges become counter events
  (``"ph": "C"``). Open https://ui.perfetto.dev and drop the file in, or
  load it at ``chrome://tracing``. Nesting is reconstructed by Perfetto
  from interval containment on a single pid/tid, which matches how the
  recorder's span stack works (one single-threaded instrumented run).

:func:`validate_chrome_trace` and :func:`validate_jsonl` are the schema
gates ``python -m repro_torch.tools.trace_demo`` runs: each re-parses its
emitted file and checks the fields its consumer actually requires
(Perfetto's ``ph``/``ts``/``dur``/pid/tid; the JSONL event-type schemas) —
so neither export path can rot silently. The recorder is the port's, with
the reference's fields, so the files and the checks are the reference's.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Union

from .telemetry import Recorder

__all__ = ["events_to_dicts", "write_jsonl", "to_chrome_trace",
           "write_chrome_trace", "validate_chrome_trace", "validate_jsonl"]

_PID = 1      # one instrumented process...
_TID = 1      # ...single-threaded by Recorder design


def events_to_dicts(rec: Recorder) -> List[Dict[str, Any]]:
    """Flatten a recorder into plain dicts (spans, then counters, then
    gauges) — the JSONL line set."""
    out: List[Dict[str, Any]] = []
    for e in rec.events:
        out.append({"type": "span", "name": e.name, "cat": e.cat,
                    "ts_us": e.ts_us, "dur_us": e.dur_us, "depth": e.depth,
                    "phase": e.phase, "tags": e.tags})
    for name, total in sorted(rec.counters.items()):
        out.append({"type": "counter", "name": name, "total": total})
    for name, samples in sorted(rec.gauges.items()):
        for ts, v in samples:
            out.append({"type": "gauge", "name": name, "ts_us": ts,
                        "value": v})
    return out


def write_jsonl(rec: Recorder, path: Union[str, Path]) -> Path:
    """Write the recorder as JSON-lines; returns the path written."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w") as fh:
        for d in events_to_dicts(rec):
            fh.write(json.dumps(d) + "\n")
    return path


def to_chrome_trace(rec: Recorder) -> List[Dict[str, Any]]:
    """Render the recorder as a Chrome trace-event array (JSON-ready).

    Spans map to complete events (``ph="X"``) with their phase and tags in
    ``args``; gauge samples map to counter events (``ph="C"``). Timestamps
    are already microseconds relative to recorder install, which is the
    unit the format expects."""
    events: List[Dict[str, Any]] = []
    for e in rec.events:
        args = dict(e.tags)
        if e.phase is not None:
            args["phase"] = e.phase
        events.append({"name": e.name, "cat": e.cat, "ph": "X",
                       "ts": e.ts_us, "dur": e.dur_us,
                       "pid": _PID, "tid": _TID, "args": args})
    for name, samples in sorted(rec.gauges.items()):
        for ts, v in samples:
            events.append({"name": name, "ph": "C", "ts": ts,
                           "pid": _PID, "tid": _TID,
                           "args": {"value": v}})
    # Chrome sorts by ts itself, but emitting sorted keeps diffs stable.
    events.sort(key=lambda d: d["ts"])
    return events


def write_chrome_trace(rec: Recorder, path: Union[str, Path]) -> Path:
    """Write a Perfetto-loadable ``trace.json``; returns the path."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w") as fh:
        json.dump({"traceEvents": to_chrome_trace(rec),
                   "displayTimeUnit": "ms"}, fh, indent=1)
    return path


def validate_chrome_trace(path: Union[str, Path]) -> List[str]:
    """Re-parse an emitted trace file and return schema problems (empty
    list = valid). Checks the fields Perfetto actually requires: a
    ``traceEvents`` array; per event a string ``name``, a known ``ph``,
    numeric non-negative ``ts``; ``dur`` present and non-negative on
    complete events; integer ``pid``/``tid``."""
    problems: List[str] = []
    try:
        doc = json.loads(Path(path).read_text())
    except (OSError, json.JSONDecodeError) as exc:
        return [f"unreadable trace: {exc}"]
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["missing/invalid traceEvents array"]
    if not events:
        problems.append("trace has zero events")
    for i, ev in enumerate(events):
        where = f"event[{i}]"
        if not isinstance(ev.get("name"), str) or not ev.get("name"):
            problems.append(f"{where}: missing name")
        ph = ev.get("ph")
        if ph not in ("X", "B", "E", "C", "i", "M"):
            problems.append(f"{where}: bad ph {ph!r}")
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"{where}: bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"{where}: complete event with bad dur "
                                f"{dur!r}")
        for k in ("pid", "tid"):
            if not isinstance(ev.get(k), int):
                problems.append(f"{where}: missing {k}")
    return problems


# per-type required fields of the JSONL event stream (events_to_dicts):
# field -> allowed types; None values are never emitted except span.phase
_JSONL_SCHEMAS: Dict[str, Dict[str, tuple]] = {
    "span": {"name": (str,), "cat": (str,), "ts_us": (int, float),
             "dur_us": (int, float), "depth": (int,), "tags": (dict,)},
    "counter": {"name": (str,), "total": (int, float)},
    "gauge": {"name": (str,), "ts_us": (int, float), "value": (int, float)},
}


def validate_jsonl(path: Union[str, Path]) -> List[str]:
    """Re-parse an emitted JSONL event log and return schema problems
    (empty list = valid) — the JSONL counterpart of
    :func:`validate_chrome_trace`. Every line must parse as a JSON object
    with a known ``type`` and that type's required fields
    (:func:`events_to_dicts` is the emitter being checked); span
    durations/timestamps must be non-negative and ``phase`` one of
    compile/execute/None."""
    problems: List[str] = []
    try:
        lines = Path(path).read_text().splitlines()
    except OSError as exc:
        return [f"unreadable event log: {exc}"]
    if not lines:
        problems.append("event log has zero lines")
    for i, line in enumerate(lines):
        where = f"line[{i}]"
        try:
            ev = json.loads(line)
        except json.JSONDecodeError as exc:
            problems.append(f"{where}: not JSON ({exc})")
            continue
        if not isinstance(ev, dict):
            problems.append(f"{where}: not an object")
            continue
        schema = _JSONL_SCHEMAS.get(ev.get("type"))
        if schema is None:
            problems.append(f"{where}: unknown type {ev.get('type')!r}")
            continue
        for fld, types in schema.items():
            val = ev.get(fld)
            # bool is an int subclass; never a valid numeric field here
            if not isinstance(val, types) or isinstance(val, bool):
                problems.append(f"{where}: bad {fld} {val!r}")
        for fld in ("ts_us", "dur_us"):
            val = ev.get(fld)
            if isinstance(val, (int, float)) and val < 0:
                problems.append(f"{where}: negative {fld} {val!r}")
        if ev.get("type") == "span" and ev.get("phase") not in (
                None, "compile", "execute"):
            problems.append(f"{where}: bad phase {ev.get('phase')!r}")
    return problems
