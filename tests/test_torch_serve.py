"""The port's ServeEngine on the CPU: the cases of
``tests/serve/test_engine.py`` (tenant lifecycle over fixed batch lanes,
join/depart isolation, staleness, the anytime budget under an injectable
clock, the health monitor, the demo), and a session against the
reference's ServeEngine under the same fake clock."""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the operands are tiny, and the suite runs its files
# in parallel workers, where extra threads only take cores from the others
torch.set_num_threads(1)

import repro.core as jcore  # noqa: E402
import repro.core.multistart as jms  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402

import repro_torch.core as tcore  # noqa: E402
import repro_torch.core.multistart as tms  # noqa: E402
from repro_torch.obs import HealthMonitor, MetricRegistry, collect_metrics  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

D0 = np.array([8.0, 16.0, 4.0, 100.0])


@pytest.fixture(scope="module")
def catalog():
    return tcore.Catalog(tcore.make_cloud_catalog().instances[::40])


def _fake_clock(step_ms=4.0):
    fake = SimpleNamespace(t=0.0)

    def clock():
        fake.t += step_ms / 1e3
        return fake.t

    return clock


def _engine(catalog, capacity, **kw):
    return ServeEngine(catalog, capacity, device="cpu", **kw)


def test_lifecycle_errors(catalog):
    eng = _engine(catalog, 2)
    eng.register("a")
    with pytest.raises(ValueError, match="already registered"):
        eng.register("a")
    eng.register("b")
    with pytest.raises(ValueError, match="at capacity"):
        eng.register("c")
    with pytest.raises(KeyError, match="unknown tenant"):
        eng.submit("zz", D0)
    eng.depart("b")
    assert eng.tenants() == ["a"]
    with pytest.raises(ValueError):
        _engine(catalog, 0)
    with pytest.raises(ValueError, match="hot_loop"):
        _engine(catalog, 1, hot_loop="pallas")
    assert eng.summary().decisions == 0 and eng.tick() == []


def test_departed_lane_is_reused_with_fresh_state(catalog):
    eng = _engine(catalog, 2)
    lane_b = eng.register("b", demand=D0 * 0.5)
    eng.register("a", demand=D0)
    eng.tick()
    eng.depart("b")
    assert eng.register("c", demand=D0 * 0.7) == lane_b
    recs = eng.tick()
    rec_c = next(r for r in recs if r.tenant == "c")
    assert rec_c.cold and rec_c.staleness == 0
    assert eng.allocation("c") is not None


def test_join_depart_does_not_perturb_other_lanes(catalog):
    def session(churn: bool):
        eng = _engine(catalog, 3)
        eng.register("a", demand=D0)
        eng.register("b", demand=D0 * 0.5)
        eng.tick()
        for t in range(3):
            if churn and t == 1:
                eng.depart("b")
                eng.register("c", demand=D0 * 0.8)
            eng.submit("a", D0 * (1.0 + 0.02 * (t + 1)))
            if "b" in eng.tenants():
                eng.submit("b", D0 * 0.5)
            eng.tick()
        return [s.counts for s in
                eng._lanes[eng._by_name["a"]].controller.history]

    plain, churned = session(False), session(True)
    assert len(plain) == len(churned) == 4
    for a, b in zip(plain, churned):
        np.testing.assert_array_equal(a, b)


def test_staleness_counts_ticks_since_last_decision(catalog):
    eng = _engine(catalog, 1)
    eng.register("a", demand=D0)
    eng.tick()
    eng.tick()
    eng.tick()
    eng.submit("a", D0 * 1.05)
    recs = eng.tick()
    assert [r.staleness for r in recs] == [3]
    assert eng.summary().max_staleness == 3
    assert eng.tick_count == 4 and len(eng.records) == 2


def test_deadline_truncates_warm_solve_deterministically(catalog):
    eng = _engine(catalog, 2, deadline_ms=10.0, chunk_iters=8,
                  clock=_fake_clock(4.0))
    eng.register("a", demand=D0)
    eng.tick()
    eng.submit("a", D0 * 1.5)
    recs = eng.tick()
    assert len(recs) == 1 and recs[0].deadline_hit
    assert 0 < recs[0].solver_iters <= 16
    s = eng.summary()
    assert s.truncated_rate == 0.5 and s.miss_rate > 0
    assert s.deadline_ms == 10.0


def test_no_deadline_serves_untruncated(catalog):
    reg = MetricRegistry()
    with collect_metrics(registry=reg):
        eng = _engine(catalog, 2)
        eng.register("a", demand=D0)
        eng.tick()
        eng.submit("a", D0 * 1.1)
        recs = eng.tick()
    assert not recs[0].deadline_hit and recs[0].solver_iters > 0
    assert eng.summary().truncated_rate == 0.0
    assert reg.histogram("serve/decision_ms").count == 2
    assert reg.histogram("serve/staleness").count == 2


def test_health_monitor_observes_decisions(catalog):
    clock = _fake_clock(2.0)
    mon = HealthMonitor(deadline_ms=1.0, kkt_every=1, clock=clock)
    eng = _engine(catalog, 2, clock=clock, health=mon)
    eng.register("a", demand=D0)
    eng.tick()
    eng.submit("a", D0 * 1.05)
    eng.tick()
    eng.submit("a", D0 * 1.1)
    eng.tick()
    rep = mon.report()
    assert rep.ticks_observed == 3
    assert rep.compile_excluded_ticks == 2
    assert rep.deadline_miss_ticks == 1
    assert rep.kkt_ticks_certified == 3
    assert np.isfinite(rep.worst_kkt_stationarity)


def test_main_demo_runs(capsys):
    from repro_torch.serve.__main__ import main, run_demo

    eng = run_demo(lanes=2, ticks=4, deadline_ms=None, verbose=True,
                   device="cpu")
    out = capsys.readouterr().out
    assert "latency p50/p99" in out
    s = eng.summary()
    assert s.decisions > 0 and s.ticks == 4
    assert all(r.feasible for r in eng.records)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(["--lanes", "1", "--ticks", "1"])


def test_session_matches_reference_under_the_same_clock(monkeypatch):
    """Both engines serve the same session (joins, a truncating deadline,
    a depart and a joiner reusing the lane, an idle tick) under fake
    clocks advancing alike: the same counts, deadline flags, iterations,
    staleness and feasibility for every decision. The port's cold joins
    are fed the reference's multistart starts."""
    starts = []
    make = jms.make_starts

    def capture(prob, n_starts, seed=0):
        out = make(prob, n_starts, seed)
        starts.append(np.array(out))
        return out

    monkeypatch.setattr(jms, "make_starts", capture)
    fed = iter(starts)
    monkeypatch.setattr(tms, "make_starts", lambda prob, n_starts, seed=0:
                        torch.as_tensor(next(fed)))

    def session(eng):
        eng.register("a", demand=D0)
        eng.register("b", demand=D0 * 0.6)
        eng.tick()
        eng.submit("a", D0 * 1.5)
        eng.submit("b", D0 * 0.7)
        eng.tick()
        eng.depart("b")
        eng.register("c", demand=D0 * 0.8)
        eng.submit("a", D0 * 1.2)
        eng.tick()
        eng.tick()
        eng.submit("a", D0 * 1.3)
        eng.submit("c", D0)
        eng.tick()
        return eng.records

    kw = dict(deadline_ms=10.0, chunk_iters=8, n_starts=2)
    ref_eng = JServeEngine(jcore.Catalog(
        jcore.make_cloud_catalog().instances[::40]), 3,
        clock=_fake_clock(4.0), **kw)
    ref = session(ref_eng)
    port_eng = ServeEngine(tcore.Catalog(
        tcore.make_cloud_catalog().instances[::40]), 3,
        clock=_fake_clock(4.0), device="cpu", **kw)
    port = session(port_eng)
    assert next(fed, None) is None
    assert len(port) == len(ref) == 8
    for rp, rr in zip(port, ref):
        assert (rp.tick, rp.tenant, rp.lane, rp.cold, rp.deadline_hit,
                rp.solver_iters, rp.staleness, rp.feasible) == (
            rr.tick, rr.tenant, rr.lane, rr.cold, rr.deadline_hit,
            rr.solver_iters, rr.staleness, rr.feasible)
        assert rp.latency_ms == pytest.approx(rr.latency_ms)
        np.testing.assert_allclose(rp.objective, rr.objective, rtol=1e-6)
    assert any(r.deadline_hit for r in port)
    for name in ("a", "c"):
        hp, hr = (e._lanes[e._by_name[name]].controller.history
                  for e in (port_eng, ref_eng))
        assert len(hp) == len(hr) > 0
        for sp, sr in zip(hp, hr):
            np.testing.assert_array_equal(sp.counts, sr.counts)
