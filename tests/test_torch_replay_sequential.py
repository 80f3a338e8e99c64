"""The port's sequential replay engine on the CPU: it commits exactly what
the batched engine commits with ``hot_loop="vmap"`` (ragged shapes and
ragged horizons included, as ``tests/fleet/test_replay.py`` demands of the
reference), it matches the reference's sequential replay from the same
starts, a constant trace reproduces ``optimize``, and the per-lane fleet
solves equal the single-problem solves they are made of."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the operands are tiny, and the suite runs its files
# in parallel workers, where extra threads only take cores from the others
torch.set_num_threads(1)

import repro.core as jcore  # noqa: E402
import repro.core.multistart as jms  # noqa: E402
import repro.fleet as jfleet  # noqa: E402

import repro_torch.core as tcore  # noqa: E402
import repro_torch.core.multistart as tms  # noqa: E402
import repro_torch.fleet as tfleet  # noqa: E402
from repro_torch.fleet.traces import (constant_trace, diurnal_trace,  # noqa: E402
                                      ramp_trace)

TENANT_RTOL, FLEET_RTOL = 0.05, 2e-2   # tests/fleet/test_solve_fleet.py:113-117
BASE = np.array([8.0, 16.0, 4.0, 100.0])


@pytest.fixture(scope="module")
def catalogs():
    """The tiny catalog of tests/fleet/test_replay.py and a second one of
    another shape (ragged stacking)."""
    full = tcore.make_cloud_catalog()
    return tcore.Catalog(full.instances[::40]), tcore.Catalog(
        full.instances[::50])


def _assert_same_replays(seq, bat):
    """tests/fleet/test_replay.py:155-168 and :235-243, exactly."""
    for rs, rb in zip(seq.tenants, bat.tenants):
        assert len(rs.steps) == len(rb.steps) == rs.spec.trace.shape[0]
        for ss, sb in zip(rs.steps, rb.steps):
            np.testing.assert_array_equal(ss.counts, sb.counts)
            assert ss.metrics.total_cost == sb.metrics.total_cost
            assert ss.churn == sb.churn
            assert ss.replanned == sb.replanned
        assert rs.metrics == rb.metrics
    assert seq.metrics.total_cost_integral == bat.metrics.total_cost_integral


def _replay_both(cat, specs):
    seq = tfleet.replay_fleet(cat, specs, run_ca_baseline=False,
                              replay_mode="sequential", device="cpu")
    bat = tfleet.replay_fleet(cat, specs, run_ca_baseline=False,
                              replay_mode="batched", hot_loop="vmap",
                              device="cpu")
    assert seq.metrics.replay_mode == "sequential"
    assert bat.metrics.replay_mode == "batched"
    return seq, bat


def test_batched_vmap_replay_matches_sequential_exactly(catalogs):
    cat, cat_other = catalogs
    specs = [
        tfleet.TenantSpec(name="a", trace=diurnal_trace(
            BASE, 3, amplitude=0.3, noise=0.0), n_starts=2),
        tfleet.TenantSpec(name="b", trace=ramp_trace(
            BASE * 0.5, 3, end_scale=1.5, noise=0.0), n_starts=2,
            catalog=cat_other, delta_max=4.0),
        tfleet.TenantSpec(name="c", trace=constant_trace(BASE, 3),
                          n_starts=2)]
    _assert_same_replays(*_replay_both(cat, specs))


def test_batched_vmap_ragged_horizons_match_sequential(catalogs):
    cat, cat_other = catalogs
    T = 4
    specs = [
        tfleet.TenantSpec(name="long", trace=diurnal_trace(
            BASE, T, amplitude=0.3, noise=0.0), n_starts=2),
        tfleet.TenantSpec(name="half", trace=ramp_trace(
            BASE * 0.5, T // 2, end_scale=1.5, noise=0.0), n_starts=2,
            catalog=cat_other, delta_max=4.0),
        tfleet.TenantSpec(name="one", trace=constant_trace(BASE, 1),
                          n_starts=2)]
    seq, bat = _replay_both(cat, specs)
    _assert_same_replays(seq, bat)
    assert [len(r.steps) for r in seq.tenants] == [T, T // 2, 1]


TENANTS = [("web", "diurnal", [8, 16, 4, 100.0], 1, 8.0),
           ("launch", "flash_crowd", [4, 8, 2, 50.0], 2, 16.0),
           ("adoption", "ramp", [6, 24, 3, 150.0], 3, 8.0)]


def _specs(TenantSpec, make_trace, ticks=3):
    return [TenantSpec(name=name, trace=make_trace(kind, np.asarray(base),
                                                   ticks, seed=seed),
                       delta_max=dm)
            for name, kind, base, seed, dm in TENANTS]


def test_sequential_replay_matches_reference(monkeypatch):
    """Both packages' sequential engines on the same fleet, the port's cold
    ticks fed the reference's multistart starts; the tolerances of
    tests/test_torch_replay.py::test_batched_replay_matches_reference."""
    jcat = jcore.Catalog(jcore.make_cloud_catalog().instances[::40])
    tcat = tcore.Catalog(tcore.make_cloud_catalog().instances[::40])
    starts = []
    make = jms.make_starts

    def capture(prob, n_starts, seed=0):
        out = make(prob, n_starts, seed)
        starts.append(np.array(out))
        return out

    monkeypatch.setattr(jms, "make_starts", capture)
    ref = jfleet.replay_fleet(jcat, _specs(jfleet.TenantSpec,
                                           jfleet.make_trace),
                              replay_mode="sequential", run_ca_baseline=False)
    fed = iter(starts)
    monkeypatch.setattr(tms, "make_starts",
                        lambda prob, n_starts, seed=0:
                        torch.as_tensor(next(fed)))
    port = tfleet.replay_fleet(tcat, _specs(tfleet.TenantSpec,
                                            tfleet.make_trace),
                               replay_mode="sequential", run_ca_baseline=False,
                               device="cpu")
    assert len(starts) == len(TENANTS) and next(fed, None) is None
    cost_r = np.asarray([t.metrics.cost_integral for t in ref.tenants])
    cost_p = np.asarray([t.metrics.cost_integral for t in port.tenants])
    np.testing.assert_allclose(cost_p, cost_r, rtol=TENANT_RTOL)
    assert abs(cost_p.sum() - cost_r.sum()) / cost_r.sum() < FLEET_RTOL
    for tr, tp in zip(ref.tenants, port.tenants):
        assert len(tp.steps) == len(tr.steps) == 3
        assert ([s.metrics.satisfied for s in tp.steps]
                == [s.metrics.satisfied for s in tr.steps])
        assert [s.replanned for s in tp.steps] == [True, False, False]
        assert tp.metrics.slo_violation_ticks == tr.metrics.slo_violation_ticks
        for s in tp.steps:
            np.testing.assert_array_equal(s.counts, np.round(s.counts))
    assert port.metrics.replay_mode == "sequential"
    assert "3 tenants, 3 ticks" in port.metrics.summary()


def test_constant_trace_reproduces_optimize(catalogs):
    """tests/fleet/test_replay.py:106-129 in the port: tick 0 is the same
    cold multistart solve as optimize(), and the steady state stays at its
    cost."""
    cat, _ = catalogs
    scen = tcore.Scenario(name="const", title="constant", demand=BASE.copy(),
                          allowed_idx=None, pools=[],
                          existing=np.zeros(cat.n))
    ref = tcore.optimize(cat, scen, n_starts=2, seed=0, device="cpu")
    spec = tfleet.TenantSpec(name="t0", trace=constant_trace(BASE, 3),
                             n_starts=2)
    out = tfleet.replay_fleet(cat, [spec], run_ca_baseline=False,
                              device="cpu")
    steps = out.tenants[0].steps
    np.testing.assert_allclose(steps[0].counts, ref.counts, atol=1e-6)
    np.testing.assert_allclose(steps[0].metrics.total_cost,
                               ref.metrics.total_cost, rtol=1e-6)
    for s in steps[1:]:
        assert s.metrics.satisfied
        np.testing.assert_allclose(s.metrics.total_cost,
                                   ref.metrics.total_cost, rtol=0.02)
    assert out.tenants[0].metrics.slo_violation_ticks == 0
    assert out.metrics.replay_mode == "sequential"


def test_replay_tenant_equals_one_tenant_fleet(catalogs):
    cat, _ = catalogs
    spec = tfleet.TenantSpec(name="w", trace=diurnal_trace(
        BASE, 3, amplitude=0.2, noise=0.0), n_starts=2)
    one = tfleet.replay_tenant(cat, spec, device="cpu")
    fleet = tfleet.replay_fleet(cat, [spec], replay_mode="sequential",
                                device="cpu").tenants[0]
    for a, b in zip(one.steps, fleet.steps):
        np.testing.assert_array_equal(a.counts, b.counts)
    assert one.metrics == fleet.metrics
    assert one.ca_metrics == fleet.ca_metrics
    np.testing.assert_array_equal(one.ca_counts, fleet.ca_counts)
    bare = tfleet.replay_tenant(cat, spec, run_ca_baseline=False,
                                device="cpu")
    assert bare.ca_metrics is None and bare.metrics == one.metrics


DEMANDS = [BASE, BASE * 0.5, BASE * 1.5]


@pytest.fixture(scope="module")
def batch(catalogs):
    """Three tenants on two catalogs, stacked ragged."""
    cat, cat_other = catalogs
    probs = [tcore.problem_from_demand(c, d, device="cpu")
             for c, d in zip((cat, cat_other, cat), DEMANDS)]
    return tfleet.stack_problems(probs)


def test_vmap_lane_equals_multistart_of_its_tenant(batch):
    cfg = tcore.SolverConfig(max_iters=120, barrier_rounds=2)
    res = tfleet.solve_fleet(batch, n_starts=3, cfg=cfg, hot_loop="vmap",
                             device="cpu")
    for b in range(batch.B):
        n = int(batch.n_true[b])
        ms = tcore.multistart_solve(tfleet.tenant_problem(batch, b),
                                    n_starts=3, cfg=cfg)
        assert torch.equal(res.x_int[b, :n], ms.x_int)
        assert torch.equal(res.x[b, :n], ms.best.x)
        assert torch.equal(res.fun_int[b], ms.fun_int)
        assert torch.equal(res.x_int_all[b, :, :n], ms.x_int_all)
        assert not res.x_int[b, n:].any()


def test_vmap_step_lane_equals_incremental_solve(batch):
    X_cur = np.zeros((batch.B, batch.n_max), np.float32)
    X_cur[:, 3] = 4.0
    X_cur[:, 11] = 2.0
    active = np.array([True, True, False])
    res = tfleet.solve_fleet_step(batch._replace(active=active), X_cur,
                                  np.array([4.0, 6.0, 4.0]), hot_loop="vmap",
                                  device="cpu")
    np.testing.assert_array_equal(res.x_int[2].numpy(), X_cur[2])
    assert int(res.iters[2]) == 0
    for b, dm in ((0, 4.0), (1, 6.0)):
        n = int(batch.n_true[b])
        pb = tfleet.tenant_problem(batch, b)
        x, it = tcore.solve_incremental_info(pb, torch.as_tensor(
            X_cur[b, :n]), dm)
        assert torch.equal(res.x[b, :n], x) and int(res.iters[b]) == int(it)
        assert torch.equal(res.x_int[b, :n], tcore.round_and_polish(pb, x))
