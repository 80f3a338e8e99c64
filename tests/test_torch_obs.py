"""The port's observability layer on the CPU: telemetry spans (nesting,
tags, the no-op span, fencing), the metric registry and its device-side
``bucket_counts`` against the reference's, and the health monitor — the
reference's numpy-level checks of ``tests/obs/test_health.py`` on the
port's monitor, and ``kkt_report`` against the reference's."""
import json
import math
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the operands are tiny, and the suite runs its files
# in parallel workers, where extra threads only take cores from the others
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.obs as jobs  # noqa: E402
from repro.core.kkt import kkt_report as j_kkt  # noqa: E402
from repro.testing import make_toy_problem as j_toy  # noqa: E402

import repro_torch.core as tcore  # noqa: E402
import repro_torch.fleet as tfleet  # noqa: E402
from repro_torch.bridge import problem_arrays, problem_from_arrays  # noqa: E402
from repro_torch.core.kkt import kkt_report as t_kkt  # noqa: E402
from repro_torch.obs import (HealthEvent, HealthMonitor, Histogram,  # noqa: E402
                             MetricRegistry, bucket_counts, collect_metrics,
                             counter, current_metrics, current_recorder,
                             gauge, inc, observe, observe_counts, set_gauge,
                             span, telemetry)
from repro_torch.obs.health import (_flat_merit_streak,  # noqa: E402
                                    _nondecreasing_tail)
from repro_torch.obs.metrics import _n_buckets  # noqa: E402
from repro_torch.obs.telemetry import _NOOP_CM, _NOOP_SPAN  # noqa: E402
from repro_torch.testing import make_toy_problem as t_toy  # noqa: E402

BASE = np.array([8.0, 16.0, 4.0, 100.0])
# the NNLS fit is 500 iterative steps in float32: residual groups and
# multipliers are held at rtol 1e-3 / atol 1e-4
KKT_TOL = dict(rtol=1e-3, atol=1e-4)


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------

def test_disabled_span_is_shared_noop():
    assert current_recorder() is None
    cm = span("replay/tick", compile_key=("k",), tick=0)
    assert cm is _NOOP_CM
    with cm as sp:
        assert sp is _NOOP_SPAN
        obj = object()
        assert sp.fence(obj) is obj
        assert sp.tag(a=1) is sp
    counter("x")
    gauge("y", 1.0)


def test_telemetry_scope_installs_and_restores():
    assert current_recorder() is None
    with telemetry() as rec:
        assert current_recorder() is rec
        with telemetry(enabled=False) as none_rec:
            assert none_rec is None
        with telemetry() as inner:
            assert current_recorder() is inner
        assert current_recorder() is rec
    assert current_recorder() is None


def test_compile_execute_tagging_and_nesting():
    with telemetry() as rec:
        with span("outer", cat="t", compile_key=("prog", 32)):
            with span("inner", cat="t"):
                pass
        with span("outer", cat="t", compile_key=("prog", 32)) as sp:
            sp.tag(tick=1)
        counter("n_solves", 2)
        gauge("waste", 0.25)
    evs = {(e.name, e.phase, e.depth) for e in rec.events}
    assert ("inner", None, 1) in evs
    assert ("outer", "compile", 0) in evs
    assert ("outer", "execute", 0) in evs
    assert rec.spans("outer", phase="execute")[0].tags == {"tick": 1}
    assert rec.counters["n_solves"] == 2.0
    assert [v for _, v in rec.gauges["waste"]] == [0.25]
    assert rec.total_us("outer") > 0
    assert "outer" in rec.summary()


def test_fence_returns_its_argument_on_cpu_tensors(monkeypatch):
    """A CPU tensor needs no wait: fence syncs no CUDA device for it (and
    a tree of tensors comes back as the same object)."""
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    tree = {"x": torch.ones(3), "ys": [torch.zeros(2), (torch.ones(1),)],
            "n": 4}
    with telemetry():
        with span("s", fence=tree) as sp:
            assert sp.fence(tree) is tree
    assert synced == []


def test_replay_bit_identical_with_telemetry_on():
    cat = tcore.Catalog(tcore.make_cloud_catalog().instances[::40])
    specs = [tfleet.TenantSpec(name="a", n_starts=2, trace=tfleet.make_trace(
        "diurnal", BASE, 2))]
    kw = dict(replay_mode="batched", run_ca_baseline=False, device="cpu")
    off = tfleet.replay_fleet(cat, specs, **kw)
    with telemetry() as rec:
        on = tfleet.replay_fleet(cat, specs, **kw)
    for a, b in zip(off.tenants[0].steps, on.tenants[0].steps):
        np.testing.assert_array_equal(a.counts, b.counts)
    names = {e.name for e in rec.events}
    assert {"replay/tick", "replay/stack", "replay/solve", "replay/round",
            "replay/metrics"} <= names
    assert [e.phase for e in rec.spans("replay/tick")] == ["compile",
                                                           "compile"]
    assert len(rec.gauges["replay/solver_iters"]) == 2


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _stream(seed):
    """Seeded values with NaN, +-inf, zeros, negatives, values below the
    lowest bucket and above the highest, and exact powers of two."""
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.lognormal(1.0, 3.0, 400), -rng.uniform(0, 5, 10),
        rng.uniform(0, 2.0 ** -12, 10), [0.0, np.nan, np.inf, -np.inf],
        2.0 ** np.arange(-12, 23), [1e9, 1e-30]]).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("lo_exp,hi_exp", [(-10, 20), (-4, 4)])
def test_bucket_counts_equal_the_reference(seed, lo_exp, hi_exp):
    vals = _stream(seed)
    want = jobs.bucket_counts(jnp.asarray(vals), lo_exp=lo_exp,
                              hi_exp=hi_exp)
    got = bucket_counts(torch.as_tensor(vals), lo_exp=lo_exp, hi_exp=hi_exp)
    assert got.counts.shape == (_n_buckets(lo_exp, hi_exp),)
    assert got.counts.dtype == torch.int32
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    for f in ("n", "nonfinite"):
        assert int(getattr(got, f)) == int(getattr(want, f))
    for f in ("vmin", "vmax"):
        assert float(getattr(got, f)) == float(getattr(want, f))
    assert float(got.total) == pytest.approx(float(want.total), rel=1e-5)


def test_device_merge_matches_host_observe_exactly():
    """The two accumulation paths agree bucket for bucket on the reference
    test's stream (away from exact powers of two, where the float32 log2
    of both packages' device paths rounds 2^13 and 2^15 one bucket low)."""
    rng = np.random.default_rng(0)
    vals = np.concatenate([rng.lognormal(1.0, 2.0, 500),
                           [0.0, -3.0, 1e9, 1e-9, np.nan]]).astype(np.float32)
    host = Histogram("h")
    host.observe(vals)
    dev = Histogram("d")
    dev.merge(bucket_counts(torch.as_tensor(vals)))
    np.testing.assert_array_equal(host.counts, dev.counts)
    assert host.count == dev.count == vals.size - 1
    assert host.nonfinite == dev.nonfinite == 1
    assert host.total == pytest.approx(dev.total, rel=1e-5)
    assert (host.vmin, host.vmax) == pytest.approx((dev.vmin, dev.vmax))


def test_bucket_counts_shapes_are_static_and_empty_input():
    for vals in ([1.0], [0.5, 2.0, 7.0], np.zeros((3, 4)), []):
        hc = bucket_counts(torch.as_tensor(np.asarray(vals, np.float32)),
                           lo_exp=-4, hi_exp=4)
        assert hc.counts.shape == (_n_buckets(-4, 4),)
        assert hc.total.shape == () and hc.n.shape == ()
    assert int(hc.n) == 0 and float(hc.vmin) == math.inf


def test_registry_exports_equal_the_reference(tmp_path):
    """The same operations on both registries give the same snapshot and
    the same Prometheus text."""
    vals = _stream(3)
    finite = vals[np.isfinite(vals)]
    out = []
    for mod in (jobs, __import__("repro_torch.obs", fromlist=["x"])):
        reg = mod.MetricRegistry()
        reg.counter("serve/decisions", help="decisions").inc(3)
        reg.gauge("health/worst").set(0.5)
        reg.gauge("health/worst").set(float("nan"))
        h = reg.histogram("replay/tick_ms", help="tick latency")
        h.observe(finite)
        with mod.collect_metrics(registry=reg):
            mod.inc("serve/decisions")
            mod.observe("serve/staleness", [0, 1, 3])
        out.append((reg.snapshot(), reg.to_prometheus()))
    (js, jp), (ts, tp) = out
    assert tp == jp
    assert json.dumps(ts, sort_keys=True) == json.dumps(js, sort_keys=True)


def test_module_helpers_noop_when_disabled_and_scoping():
    assert current_metrics() is None
    inc("a")
    set_gauge("b", 1.0)
    observe("c", [1.0])
    observe_counts("d", bucket_counts(torch.ones(3)))
    reg = MetricRegistry()
    with collect_metrics(registry=reg) as r:
        assert r is reg and current_metrics() is reg
        observe_counts("d", bucket_counts(torch.tensor([1.0, 2.0, 4.0])))
        with collect_metrics(enabled=False) as none:
            assert none is None
    assert current_metrics() is None
    assert reg.histogram("d").count == 3
    with pytest.raises(TypeError):
        reg.counter("d")
    with pytest.raises(ValueError):
        reg.counter("c").inc(-1)


# ---------------------------------------------------------------------------
# health: the reference's numpy-level checks on the port's monitor
# ---------------------------------------------------------------------------

def _step(satisfied=True, churn_violation=0.0, counts=None, iters=5):
    c = np.array([1.0, 0.0, 2.0]) if counts is None else np.asarray(counts)
    return SimpleNamespace(metrics=SimpleNamespace(satisfied=satisfied),
                           churn_violation=churn_violation, counts=c,
                           solver_iters=iters)


def test_breach_counters_and_registry_mirror():
    reg = MetricRegistry()
    mon = HealthMonitor(registry=reg)
    mon.observe_step(tenant="a", tick=0, step=_step(), solver="adaptive")
    mon.observe_step(tenant="a", tick=1, step=_step(satisfied=False),
                     solver="adaptive")
    mon.observe_step(tenant="a", tick=2, step=_step(churn_violation=1.5),
                     solver="adaptive", spot_unavailable=2)
    rep = mon.report()
    assert (rep.slo_breach_ticks, rep.churn_violation_ticks,
            rep.spot_interruption_ticks, rep.nonfinite_events) == (1, 1, 1, 0)
    for name in ("slo_breach_ticks", "churn_violation_ticks",
                 "spot_interruption_ticks"):
        assert reg.counter(f"health/{name}").value == 1


def test_nonfinite_counts_and_relaxed_guards():
    mon = HealthMonitor()
    mon.observe_step(tenant="a", tick=3, step=_step(counts=[1.0, np.nan]),
                     solver="adaptive", lane=2)
    mon.observe_step(tenant="a", tick=4, step=_step(),
                     solver="adaptive", x_rel=np.array([np.inf, 0.0]))
    rep = mon.report()
    assert rep.nonfinite_events == 2
    ev = rep.events[0]
    assert (ev.kind, ev.severity, ev.tick, ev.lane) == ("non_finite",
                                                        "error", 3, 2)
    assert "counts" in ev.message and "relaxed" in rep.events[1].message


def test_nonfinite_gradient_caught_via_kkt_residual():
    prob = t_toy(seed=0, n=8, device="cpu")
    c = prob.c.clone()
    c[0] = float("nan")
    mon = HealthMonitor()
    mon.observe_step(tenant="a", tick=0, step=_step(), solver="adaptive",
                     prob=prob._replace(c=c), x_rel=np.ones(8))
    rep = mon.report()
    assert rep.nonfinite_events == 1 and "gradient" in rep.events[0].message
    assert rep.worst_kkt_stationarity is None
    mon2 = HealthMonitor()
    mon2.observe_step(tenant="a", tick=0, step=_step(), solver="adaptive",
                      prob=prob, x_rel=np.ones(8))
    assert mon2.report().nonfinite_events == 0
    assert math.isfinite(mon2.report().worst_kkt_stationarity)


def test_kkt_worst_tracking_and_cadence():
    prob = t_toy(seed=1, n=8, device="cpu")
    reg = MetricRegistry()
    mon = HealthMonitor(kkt_every=2, registry=reg)
    for t in range(4):
        mon.observe_step(tenant="a", tick=t, step=_step(), solver="adaptive",
                         prob=prob, x_rel=np.full(8, 0.5 + t))
    rep = mon.report()
    assert rep.kkt_ticks_certified == 2
    assert rep.worst_kkt["tenant"] == "a" and rep.worst_kkt["tick"] in (0, 2)
    assert reg.histogram("health/kkt_stationarity").count == 2
    assert (reg.gauge("health/worst_kkt_stationarity").value
            == pytest.approx(rep.worst_kkt_stationarity))
    none = HealthMonitor(kkt_every=0)
    none.observe_step(tenant="a", tick=0, step=_step(), solver="adaptive",
                      prob=prob, x_rel=np.ones(8))
    assert none.report().kkt_ticks_certified == 0
    warn = HealthMonitor(kkt_warn=1e-12)
    warn.observe_step(tenant="a", tick=0, step=_step(), solver="adaptive",
                      prob=prob, x_rel=np.ones(8))
    assert "kkt_residual" in [e.kind for e in warn.report().events]


def test_stall_math_and_events():
    improving = np.concatenate([np.linspace(10, 1, 30), [np.nan] * 10])
    assert _flat_merit_streak(improving) == 0
    flat = np.concatenate([np.linspace(10, 1, 10), np.full(25, 1.0)])
    assert _flat_merit_streak(flat) == 25
    assert _flat_merit_streak(np.array([5.0])) == 0
    assert _nondecreasing_tail(np.array([8.0, 4.0, 2.0, 1.0, 0.5])) == 0
    stuck = np.array([8.0, 4.0, 4.0, 4.5, 5.0])
    assert _nondecreasing_tail(stuck) == 3
    assert _nondecreasing_tail(np.concatenate([stuck, [np.nan]])) == 3
    mon = HealthMonitor(stall_window=20)
    mon.observe_step(tenant="a", tick=1, step=_step(), solver="adaptive",
                     trace=SimpleNamespace(merit=np.concatenate(
                         [np.linspace(10, 1, 5), np.full(30, 1.0)])))
    mon.observe_step(tenant="b", tick=2, step=_step(), solver="admm", lane=1,
                     trace=SimpleNamespace(primal=np.concatenate(
                         [[5.0], np.full(30, 2.0)]), dual=None),
                     diag=SimpleNamespace(primal_res=np.float32(2.0)))
    rep = mon.report()
    assert rep.stall_events == 2
    by_solver = {e.solver: e for e in rep.events}
    assert "merit flat" in by_solver["adaptive"].message
    assert "2.000e+00" in by_solver["admm"].message
    ok = HealthMonitor(stall_window=20)
    ok.observe_step(tenant="a", tick=1, step=_step(), solver="adaptive",
                    trace=SimpleNamespace(merit=np.linspace(10, 1, 40)))
    assert ok.report().stall_events == 0


def test_deadline_budget_and_compile_key_exclusion():
    reg = MetricRegistry()
    mon = HealthMonitor(deadline_ms=50.0, registry=reg)
    mon.observe_tick(0, 900.0, compile_key=("tick", 0))
    mon.observe_tick(1, 700.0, compile_key=("tick", 1))
    mon.observe_tick(2, 80.0, compile_key=("tick", 1))
    mon.observe_tick(3, 10.0, compile_key=("tick", 1))
    mon.observe_tick(4, 80.0)
    mon.observe_tick(5, 50.0)            # at budget = not over
    rep = mon.report()
    assert rep.ticks_observed == 6 and rep.compile_excluded_ticks == 2
    assert rep.deadline_miss_ticks == 2
    assert reg.counter("health/compile_excluded_ticks").value == 2
    assert reg.histogram("health/tick_compile_ms").count == 2
    assert reg.histogram("health/tick_ms").count == 4
    step = _step()
    step.deadline_hit = True
    mon.observe_step(tenant="a", tick=0, step=step, solver="adaptive")
    assert mon.report().deadline_truncated_ticks == 1
    assert "anytime trunc" in "\n".join(rep.summary_lines())


def test_event_cap_json_and_validation():
    mon = HealthMonitor(max_events=3, deadline_ms=5.0)
    for t in range(10):
        mon.observe_step(tenant="a", tick=t, solver="adaptive",
                         step=_step(counts=[np.nan]), lane=np.int64(3))
    mon.observe_tick(0, 10.0)
    rep = mon.report()
    assert len(rep.events) == 3 and rep.nonfinite_events == 10
    doc = json.loads(json.dumps(rep.to_dict(), default=int))
    assert doc["nonfinite_events"] == 10 and doc["deadline_miss_ticks"] == 1
    assert HealthEvent(kind="x", severity="warn", tenant="t", tick=0,
                       solver="s").to_dict()["value"] is None
    with pytest.raises(ValueError, match="kkt_every"):
        HealthMonitor(kkt_every=-1)
    with pytest.raises(ValueError, match="stall_window"):
        HealthMonitor(stall_window=1)


# ---------------------------------------------------------------------------
# kkt_report against the reference
# ---------------------------------------------------------------------------

def _kkt_pair(jp, tp, x):
    want = j_kkt(jp, jnp.asarray(x, jnp.float32))
    got = t_kkt(tp, torch.as_tensor(np.asarray(x, np.float32)))
    for f in want._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   err_msg=f, **KKT_TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_kkt_report_matches_reference_on_toy_points(seed):
    jp = j_toy(seed=seed, n=8)
    tp = problem_from_arrays(problem_arrays(jp), device="cpu")
    for x in (np.ones(8), np.full(8, 0.5 + seed), np.zeros(8)):
        _kkt_pair(jp, tp, x)


def test_kkt_report_matches_reference_at_a_relaxed_solution():
    """The point the monitor certifies: a multistart relaxed solution on
    the reduced catalog (near-stationary, constraints active)."""
    jcat = jcore.Catalog(jcore.make_cloud_catalog().instances[::40])
    jp = jcore.problem_from_demand(jcat, BASE)
    tp = problem_from_arrays(problem_arrays(jp), device="cpu")
    x = np.array(jcore.multistart_solve(jp, n_starts=2).best.x)
    _kkt_pair(jp, tp, x)
    got = t_kkt(tp, torch.as_tensor(x), barrier_t=torch.tensor(100.0))
    want = j_kkt(jp, jnp.asarray(x), barrier_t=jnp.float32(100.0))
    np.testing.assert_allclose(got.stationarity.numpy(),
                               np.asarray(want.stationarity), **KKT_TOL)
