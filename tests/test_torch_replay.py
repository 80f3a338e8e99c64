"""The slice as a whole: the port's batched fleet replay against the JAX
reference's, on the CPU, from the same starts."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the operands are tiny, and the suite runs its files
# in parallel workers, where extra threads only take cores from the others
torch.set_num_threads(1)

import repro.core as jcore  # noqa: E402
import repro.fleet as jfleet  # noqa: E402
import repro.fleet.replay as jreplay  # noqa: E402

import repro_torch.core as tcore  # noqa: E402
import repro_torch.fleet as tfleet  # noqa: E402
import repro_torch.fleet.replay as treplay  # noqa: E402

T = 3
TENANTS = [("web", "diurnal", [8, 16, 4, 100.0], 1, 8.0),
           ("launch", "flash_crowd", [4, 8, 2, 50.0], 2, 16.0),
           ("adoption", "ramp", [6, 24, 3, 150.0], 3, 8.0)]
TENANT_RTOL, FLEET_RTOL = 0.05, 2e-2   # tests/fleet/test_solve_fleet.py:113-117


def _specs(TenantSpec, make_trace, ticks=T):
    return [TenantSpec(name=name, trace=make_trace(kind, np.asarray(base),
                                                   ticks, seed=seed),
                       delta_max=dm)
            for name, kind, base, seed, dm in TENANTS]


def _replay_pair(monkeypatch, warm_start):
    """Both packages replay the same fleet; the port's cold start is fed the
    reference's starts (jax.random draws differ from torch.Generator's)."""
    jcat = jcore.Catalog(jcore.make_cloud_catalog().instances[::40])
    tcat = tcore.Catalog(tcore.make_cloud_catalog().instances[::40])
    starts = []

    def capture(batch, n_starts, seed=0):
        out = jfleet.make_fleet_starts(batch, n_starts, seed)
        starts.append(np.array(out))
        return out

    monkeypatch.setattr(jreplay, "make_fleet_starts", capture)
    ref = jfleet.replay_fleet(jcat, _specs(jfleet.TenantSpec,
                                           jfleet.make_trace),
                              replay_mode="batched", hot_loop="ref",
                              run_ca_baseline=False, warm_start=warm_start)
    fed = iter(starts)
    monkeypatch.setattr(treplay, "make_fleet_starts",
                        lambda batch, n_starts, seed=0:
                        torch.as_tensor(next(fed)))
    port = tfleet.replay_fleet(tcat, _specs(tfleet.TenantSpec,
                                            tfleet.make_trace),
                               replay_mode="batched", run_ca_baseline=False,
                               warm_start=warm_start, device="cpu")
    assert next(fed, None) is None
    return ref, port


@pytest.mark.parametrize("warm_start", ["counts", "relaxed"])
def test_batched_replay_matches_reference(monkeypatch, warm_start):
    ref, port = _replay_pair(monkeypatch, warm_start)
    cost_r = np.asarray([t.metrics.cost_integral for t in ref.tenants])
    cost_p = np.asarray([t.metrics.cost_integral for t in port.tenants])
    np.testing.assert_allclose(cost_p, cost_r, rtol=TENANT_RTOL)
    assert abs(cost_p.sum() - cost_r.sum()) / cost_r.sum() < FLEET_RTOL
    slo_r = np.asarray([t.metrics.slo_violation_ticks for t in ref.tenants])
    slo_p = np.asarray([t.metrics.slo_violation_ticks for t in port.tenants])
    np.testing.assert_allclose(slo_p, slo_r, rtol=TENANT_RTOL)
    # every committed allocation: the same feasibility, integral counts
    for tr, tp in zip(ref.tenants, port.tenants):
        assert len(tp.steps) == len(tr.steps) == T
        assert ([s.metrics.satisfied for s in tp.steps]
                == [s.metrics.satisfied for s in tr.steps])
        assert [s.replanned for s in tp.steps] == [True] + [False] * (T - 1)
        for s in tp.steps:
            np.testing.assert_array_equal(s.counts, np.round(s.counts))
    assert port.metrics.replay_mode == "batched"
    assert port.metrics.health is None
    assert "3 tenants, 3 ticks" in port.metrics.summary()


def test_ragged_horizons_freeze_finished_tenants():
    cat = tcore.Catalog(tcore.make_cloud_catalog().instances[::40])
    specs = _specs(tfleet.TenantSpec, tfleet.make_trace, ticks=3)
    specs[1] = tfleet.TenantSpec(name="short", trace=specs[1].trace[:1])
    out = tfleet.replay_fleet(cat, specs, replay_mode="batched",
                              run_ca_baseline=False, device="cpu")
    assert [len(t.steps) for t in out.tenants] == [3, 1, 3]
    assert out.metrics.total_tenant_ticks == 7


def test_ca_baseline_runs_by_default():
    """replay_fleet's default run_ca_baseline=True (it raised until the
    baseline was ported): every tenant gets its CA metrics and counts."""
    cat = tcore.Catalog(tcore.make_cloud_catalog().instances[::40])
    out = tfleet.replay_fleet(cat, _specs(tfleet.TenantSpec,
                                          tfleet.make_trace),
                              replay_mode="batched", device="cpu")
    assert len(out.metrics.baseline) == len(TENANTS)
    for r in out.tenants:
        assert r.ca_metrics.name == f"{r.spec.name}/ca"
        assert r.ca_metrics.ticks == T
        assert r.ca_counts.shape == (cat.n,)
        np.testing.assert_array_equal(r.ca_counts, np.round(r.ca_counts))
    base = out.metrics.baseline_cost_integral
    assert base == sum(r.ca_metrics.cost_integral for r in out.tenants) > 0
    assert out.metrics.cost_savings_vs_baseline_pct == pytest.approx(
        100.0 * (base - out.metrics.total_cost_integral) / base)
    assert "savings vs CA" in out.metrics.summary()


def test_sequential_mode_runs_by_default():
    """replay_fleet's default replay_mode="sequential" (it raised until the
    sequential engine was ported): one controller per tenant, every tick
    recorded, the CA baseline beside it."""
    cat = tcore.Catalog(tcore.make_cloud_catalog().instances[::40])
    specs = _specs(tfleet.TenantSpec, tfleet.make_trace, ticks=2)[:2]
    out = tfleet.replay_fleet(cat, specs, device="cpu")
    assert out.metrics.replay_mode == "sequential"
    assert [len(r.steps) for r in out.tenants] == [2, 2]
    assert [[s.replanned for s in r.steps] for r in out.tenants] == [
        [True, False]] * 2
    assert len(out.metrics.baseline) == 2
    assert "savings vs CA" in out.metrics.summary()


def _tight(Config):
    """An anytime budget that truncates every warm solve: a fake clock
    burning 5 ms a reading against 12 ms, 4-iteration chunks."""
    t = [0.0]

    def clock():
        t[0] += 5e-3
        return t[0]

    return Config(deadline_ms=12.0, chunk_iters=4, clock=clock)


OPT_T = 2   # ticks of the options' replays: one cold, one warm


def _options_pair(monkeypatch, mode, option):
    """Both packages replay the fleet with one observer or budget on (the
    port's cold starts fed from the reference's); returns ``(ref, port,
    ref_health, port_health)``."""
    import repro.core.multistart as jms
    import repro.obs as jobs
    import repro_torch.core.multistart as tms
    import repro_torch.obs as tobs
    from repro.core.pgd import AnytimeConfig as JAnytime
    from repro_torch.core.pgd import AnytimeConfig as TAnytime

    jcat = jcore.Catalog(jcore.make_cloud_catalog().instances[::40])
    tcat = tcore.Catalog(tcore.make_cloud_catalog().instances[::40])
    starts = []
    mod_j, mod_t, name = ((jreplay, treplay, "make_fleet_starts")
                          if mode == "batched"
                          else (jms, tms, "make_starts"))
    make = getattr(mod_j, name)

    def capture(*a, **kw):
        out = make(*a, **kw)
        starts.append(np.array(out))
        return out

    monkeypatch.setattr(mod_j, name, capture)
    fed = iter(starts)
    monkeypatch.setattr(mod_t, name,
                        lambda *a, **kw: torch.as_tensor(next(fed)))
    jkw, tkw, health = {}, {}, (None, None)
    if option == "health":
        health = (jobs.HealthMonitor(), tobs.HealthMonitor())
        jkw, tkw = dict(health=health[0]), dict(health=health[1])
    elif option == "trace":
        jkw = tkw = dict(capture_solver_trace=True)
    else:
        jkw, tkw = (dict(anytime=_tight(JAnytime)),
                    dict(anytime=_tight(TAnytime)))
    ref = jfleet.replay_fleet(jcat, _specs(jfleet.TenantSpec,
                                           jfleet.make_trace, OPT_T),
                              replay_mode=mode, run_ca_baseline=False, **jkw)
    port = tfleet.replay_fleet(tcat, _specs(tfleet.TenantSpec,
                                            tfleet.make_trace, OPT_T),
                               replay_mode=mode, run_ca_baseline=False,
                               device="cpu", **tkw)
    assert next(fed, None) is None
    return ref, port, health


@pytest.mark.parametrize("mode,option", [
    ("sequential", "health"), ("batched", "trace"), ("batched", "health"),
    ("batched", "anytime")])
def test_ported_options_match_reference(monkeypatch, mode, option):
    """The options that raised until this slice: each runs in the port and
    returns what the reference's engine returns on the same fleet."""
    ref, port, (hj, ht) = _options_pair(monkeypatch, mode, option)
    for tr, tp in zip(ref.tenants, port.tenants):
        assert len(tp.steps) == len(tr.steps) == OPT_T
        assert ([s.metrics.satisfied for s in tp.steps]
                == [s.metrics.satisfied for s in tr.steps])
        assert ([s.deadline_hit for s in tp.steps]
                == [s.deadline_hit for s in tr.steps]
                == [False] + [option == "anytime"] * (OPT_T - 1))
    cost_r = np.asarray([t.metrics.cost_integral for t in ref.tenants])
    cost_p = np.asarray([t.metrics.cost_integral for t in port.tenants])
    np.testing.assert_allclose(cost_p, cost_r, rtol=TENANT_RTOL)
    if option == "anytime":
        # truncated after 8 iterations in both: the same counts
        for tr, tp in zip(ref.tenants, port.tenants):
            for sr, sp in zip(tr.steps, tp.steps):
                assert sp.solver_iters == sr.solver_iters
                np.testing.assert_array_equal(sp.counts, sr.counts)
    if option == "trace":
        assert len(port.solver_traces) == len(ref.solver_traces) == 3
        for lr, lp, tp in zip(ref.solver_traces, port.solver_traces,
                              port.tenants):
            assert len(lp) == len(lr) == OPT_T - 1   # one per warm tick
            for rr, rp, step in zip(lr, lp, tp.steps[1:]):
                assert rp.merit.shape == np.asarray(rr.merit).shape
                k = int(np.isfinite(rp.merit).sum())
                assert k == step.solver_iters > 0
                assert np.isnan(rp.merit[k:]).all()
                # the first rows agree; later ones part on float32 rounding
                np.testing.assert_allclose(rp.merit[:8],
                                           np.asarray(rr.merit)[:8],
                                           rtol=1e-4, atol=1e-4)
    else:
        assert port.solver_traces is None and ref.solver_traces is None
    if option == "health":
        rj, rt = hj.report(), ht.report()
        assert port.metrics.health is rt
        for f in ("slo_breach_ticks", "churn_violation_ticks",
                  "spot_interruption_ticks", "deadline_truncated_ticks",
                  "nonfinite_events", "ticks_observed",
                  "compile_excluded_ticks", "kkt_ticks_certified"):
            assert getattr(rt, f) == getattr(rj, f), f
        assert rt.kkt_ticks_certified == 3 * OPT_T
        assert np.isfinite(rt.worst_kkt_stationarity)
        assert any("health:" in ln for ln in
                   port.metrics.summary().splitlines())


def test_malformed_specs_and_fleets_raise():
    with pytest.raises(ValueError):
        tfleet.TenantSpec(name="bad", trace=np.ones(4))
    with pytest.raises(ValueError):
        tfleet.TenantSpec(name="bad", trace=np.ones((3, 5)))
    cat = tcore.Catalog(tcore.make_cloud_catalog().instances[::40])
    with pytest.raises(ValueError):
        tfleet.replay_fleet(cat, [], replay_mode="batched",
                            run_ca_baseline=False, device="cpu")
