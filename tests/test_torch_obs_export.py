"""The port's JSONL / Chrome-trace export and ``ReplayReport`` against the
reference's: recorders filled alike (timestamps pinned to the same values)
export and roll up alike; the port's validators flag the reference's
corrupt files with the reference's problems; and a port replay on the CPU
under ``telemetry()`` exports valid files whose span structure and
padding-waste samples equal the reference replay's on the same fleet."""
import json
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the operands are tiny, and the suite runs its files
# in parallel workers, where extra threads only take cores from the others
torch.set_num_threads(1)

import repro.core as jcore  # noqa: E402
import repro.core.multistart as jms  # noqa: E402
import repro.fleet as jfleet  # noqa: E402
import repro.fleet.replay as jreplay  # noqa: E402
import repro.obs as jobs  # noqa: E402

import repro_torch.core as tcore  # noqa: E402
import repro_torch.core.multistart as tms  # noqa: E402
import repro_torch.fleet as tfleet  # noqa: E402
import repro_torch.fleet.replay as treplay  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402


def _fill(rec):
    """The same spans (nested, compile-tagged, untagged), counters and
    gauges, recorded in the same order."""
    with rec.span("replay/tick", cat="replay", tick=0,
                  compile_key=("tick", 0)):
        with rec.span("replay/stack", cat="replay", bucket="(64, 4, 2, 2)"):
            rec.gauge("stack/padding_waste", 0.25)
        with rec.span("replay/solve", cat="replay",
                      compile_key=("solve", 32)):
            pass
    with rec.span("replay/tick", cat="replay", tick=1,
                  compile_key=("tick", 0)):
        with rec.span("replay/solve", cat="replay",
                      compile_key=("solve", 32)):
            pass
        rec.gauge("stack/padding_waste", 0.5)
    rec.gauge("replay/solver_iters", 40)
    rec.gauge("replay/solver_iters", 12)
    rec.counter("n_solves")
    rec.counter("n_solves", 2)
    with rec.span("host/work"):
        pass


def _pin(rec):
    """Timestamps and durations pinned to fixed values (the clocks of two
    runs never agree)."""
    for i, e in enumerate(rec._events):
        e.ts_us, e.dur_us = 10.0 * i + 0.5, 3.25 * (i + 1)
    for name, samples in rec.gauges.items():
        rec.gauges[name] = [(100.0 + k, v) for k, (_, v) in
                            enumerate(samples)]
    return rec


@pytest.fixture(scope="module")
def recorders():
    with jobs.telemetry() as jrec:
        _fill(jrec)
    with tobs.telemetry() as trec:
        _fill(trec)
    return _pin(jrec), _pin(trec)


def test_exports_equal(recorders):
    jrec, trec = recorders
    assert tobs.events_to_dicts(trec) == jobs.events_to_dicts(jrec)
    chrome = tobs.to_chrome_trace(trec)
    assert chrome == jobs.to_chrome_trace(jrec)
    assert len(chrome) == 10                   # 6 spans + 4 gauge samples
    json.dumps(chrome)                         # no tensor/tuple leakage


def test_replay_report_equal(recorders):
    jrec, trec = recorders
    got = tobs.ReplayReport.from_recorder(trec)
    want = jobs.ReplayReport.from_recorder(jrec)
    assert got.to_dict() == want.to_dict()
    assert got.render() == want.render()
    assert got.n_ticks == 2
    assert tobs.percentiles([1.0, 2.0, 3.0]) == jobs.percentiles(
        [1.0, 2.0, 3.0])
    assert tobs.percentiles([]) == {}


def test_emitted_files_equal_and_valid(recorders, tmp_path):
    jrec, trec = recorders
    for fn in ("write_chrome_trace", "write_jsonl"):
        ext = "json" if fn == "write_chrome_trace" else "jsonl"
        tp = getattr(tobs, fn)(trec, tmp_path / f"port.{ext}")
        jp = getattr(jobs, fn)(jrec, tmp_path / f"ref.{ext}")
        assert tp.read_text() == jp.read_text()
    assert tobs.validate_chrome_trace(tmp_path / "port.json") == []
    assert tobs.validate_jsonl(tmp_path / "port.jsonl") == []


def test_chrome_validator_flags_what_the_reference_does(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [
        {"name": "ok", "ph": "X", "ts": 1.0, "dur": 2.0, "pid": 1, "tid": 1},
        {"name": "", "ph": "Z", "ts": -1.0, "pid": "x"},
        {"name": "span", "ph": "X", "ts": 0.0, "dur": -3, "pid": 1,
         "tid": 1},
    ]}))
    problems = tobs.validate_chrome_trace(bad)
    assert problems == jobs.validate_chrome_trace(bad)
    for what in ("bad ph", "bad ts", "missing name", "missing pid",
                 "complete event with bad dur"):
        assert any(what in p for p in problems), what
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"traceEvents": []}))
    assert tobs.validate_chrome_trace(empty) == ["trace has zero events"]
    notarray = tmp_path / "notarray.json"
    notarray.write_text(json.dumps({"traceEvents": {}}))
    assert (tobs.validate_chrome_trace(notarray)
            == jobs.validate_chrome_trace(notarray)
            == ["missing/invalid traceEvents array"])
    notjson = tmp_path / "nope.json"
    notjson.write_text("{")
    assert "unreadable" in tobs.validate_chrome_trace(notjson)[0]
    assert tobs.validate_chrome_trace(notjson) == jobs.validate_chrome_trace(
        notjson)
    assert tobs.validate_chrome_trace(tmp_path / "missing.json")


def test_jsonl_validator_flags_what_the_reference_does(tmp_path):
    bad = tmp_path / "bad.jsonl"
    bad.write_text("\n".join([
        "{not json",
        json.dumps([1, 2]),
        json.dumps({"type": "mystery"}),
        json.dumps({"type": "span", "name": 7, "cat": "c", "ts_us": -1.0,
                    "dur_us": 2.0, "depth": 0, "tags": {},
                    "phase": "weird"}),
        json.dumps({"type": "counter", "name": "n", "total": True}),
        json.dumps({"type": "gauge", "name": "g", "ts_us": 1.0,
                    "value": "x"}),
    ]) + "\n")
    problems = tobs.validate_jsonl(bad)
    assert problems == jobs.validate_jsonl(bad)
    for what in ("not JSON", "not an object", "unknown type", "bad name 7",
                 "negative ts_us", "bad phase", "bad total True",
                 "bad value 'x'"):
        assert any(what in p for p in problems), what
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert tobs.validate_jsonl(empty) == ["event log has zero lines"]
    assert "unreadable" in tobs.validate_jsonl(tmp_path / "missing.jsonl")[0]


# ---------------------------------------------------------------------------
# an instrumented replay in both packages
# ---------------------------------------------------------------------------

BASE = np.array([8.0, 16.0, 4.0, 100.0])


def _specs(TenantSpec, make_trace):
    """``python -m repro_torch.tools.trace_demo``'s fleet."""
    return [TenantSpec(name="diurnal", n_starts=2,
                       trace=make_trace("diurnal", BASE, 4, seed=0,
                                        amplitude=0.3)),
            TenantSpec(name="ramp", n_starts=2,
                       trace=make_trace("ramp", BASE * 0.6, 4, seed=1))]


@pytest.fixture(scope="module", params=["batched", "sequential"])
def replay_pair(request):
    """Both packages replay the fleet under telemetry, the port fed the
    reference's cold starts; returns ``(mode, ref_rec, port_rec, port)``."""
    mode = request.param
    mod_j, mod_t, name = ((jreplay, treplay, "make_fleet_starts")
                          if mode == "batched" else
                          (jms, tms, "make_starts"))
    make = getattr(mod_j, name)
    starts = []

    def capture(*a, **kw):
        out = make(*a, **kw)
        starts.append(np.array(out))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod_j, name, capture)
        jcat = jcore.Catalog(jcore.make_cloud_catalog().instances[::40])
        with jobs.telemetry() as jrec:
            jfleet.replay_fleet(jcat, _specs(jfleet.TenantSpec,
                                             jfleet.make_trace),
                                run_ca_baseline=False, replay_mode=mode,
                                capture_solver_trace=True)
        fed = iter(starts)
        mp.setattr(mod_t, name, lambda *a, **kw: torch.as_tensor(next(fed)))
        tcat = tcore.Catalog(tcore.make_cloud_catalog().instances[::40])
        with tobs.telemetry() as trec:
            port = tfleet.replay_fleet(tcat, _specs(tfleet.TenantSpec,
                                                    tfleet.make_trace),
                                       run_ca_baseline=False,
                                       replay_mode=mode,
                                       capture_solver_trace=True,
                                       device="cpu")
        assert next(fed, None) is None
    return mode, jrec, trec, port


def test_port_replay_exports_validate(replay_pair, tmp_path):
    mode, _, trec, port = replay_pair
    trace = tobs.write_chrome_trace(trec, tmp_path / "trace.json")
    jsonl = tobs.write_jsonl(trec, tmp_path / "trace.jsonl")
    assert tobs.validate_chrome_trace(trace) == []
    assert tobs.validate_jsonl(jsonl) == []
    # the batched engine wraps its fleet solves in compile-keyed spans, the
    # sequential one its ticks
    keyed = "replay/solve" if mode == "batched" else "replay/tick"
    assert trec.spans(keyed, phase="compile")
    report = tobs.ReplayReport.from_recorder(trec)
    # a tick span per (tenant, tick) in the sequential engine, per fleet
    # tick in the batched one
    ticks = [len(t.steps) for t in port.tenants]
    assert report.n_ticks == (sum(ticks) if mode == "sequential"
                              else max(ticks))
    json.dumps(report.to_dict())


def test_port_replay_structure_equals_the_reference(replay_pair):
    _, jrec, trec, _ = replay_pair
    shape = lambda rec: Counter((e.name, e.phase) for e in rec.events)
    assert shape(trec) == shape(jrec)
    assert sorted(trec.gauges) == sorted(jrec.gauges)
    waste = lambda rec: [v for _, v in rec.gauges.get(
        "stack/padding_waste", [])]
    assert waste(trec) == waste(jrec)
    assert (len(trec.gauges["replay/solver_iters"])
            == len(jrec.gauges["replay/solver_iters"]))
    got = tobs.ReplayReport.from_recorder(trec)
    want = jobs.ReplayReport.from_recorder(jrec)
    assert got.n_ticks == want.n_ticks
    assert ([(p.name, p.count) for p in got.phases]
            == [(p.name, p.count) for p in want.phases])
    assert got.padding_waste == want.padding_waste
