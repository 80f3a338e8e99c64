"""The port's MPC replay engines against each other on the CPU (the
equalities tests/horizon/test_mpc.py and test_admm_parity.py demand of the
reference, exactly): H = 1 commits the myopic controller's counts in both
engines (``cold_start="window"`` too), the batched engine with
``hot_loop="vmap"`` commits the sequential engine's counts (ragged
horizons, a per-tenant catalog, the window cold start, the ADMM engine
with its traces), and the controller keeps its plan."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.core import Catalog, make_cloud_catalog  # noqa: E402
from repro_torch.fleet import TenantSpec, replay_fleet  # noqa: E402
from repro_torch.fleet.traces import (constant_trace, diurnal_trace,  # noqa: E402
                                      flash_crowd_trace, ramp_trace)
from repro_torch.horizon import (ADMMTrace, HorizonSolverConfig,  # noqa: E402
                                 ModelPredictiveController, make_forecaster)

BASE = np.array([8.0, 16.0, 4.0, 100.0])


@pytest.fixture(scope="module")
def catalogs():
    full = make_cloud_catalog()
    return Catalog(full.instances[::40]), Catalog(full.instances[::50])


def _assert_same(a, b, metrics=True):
    for ra, rb in zip(a.tenants, b.tenants):
        assert len(ra.steps) == len(rb.steps) == ra.spec.trace.shape[0]
        for sa, sb in zip(ra.steps, rb.steps):
            np.testing.assert_array_equal(sa.counts, sb.counts)
            assert sa.churn == sb.churn
            assert sa.replanned == sb.replanned
        if metrics:
            assert ra.metrics == rb.metrics


def _two(cat):
    return [TenantSpec(name="a", trace=diurnal_trace(
                BASE, 4, amplitude=0.3, noise=0.0), n_starts=2),
            TenantSpec(name="b", trace=ramp_trace(
                BASE * 0.5, 3, end_scale=1.5, noise=0.0), n_starts=2,
                delta_max=4.0)]


@pytest.mark.parametrize("mode", ["sequential", "batched"])
def test_h1_is_the_myopic_controller(catalogs, mode):
    cat, _ = catalogs
    specs = _two(cat)
    kw = dict(run_ca_baseline=False, replay_mode=mode, device="cpu")
    myo = replay_fleet(cat, specs, **kw)
    for cold_start in ("myopic", "window"):
        mpc = replay_fleet(cat, specs, controller="mpc", horizon=1,
                           cold_start=cold_start, **kw)
        assert mpc.metrics.controller == "mpc"
        _assert_same(myo, mpc)


def test_batched_vmap_matches_sequential(catalogs):
    """Ragged horizons, a second catalog, Holt-Winters windows."""
    cat, cat_other = catalogs
    specs = [
        TenantSpec(name="a", trace=diurnal_trace(BASE, 4, amplitude=0.3,
                                                 noise=0.0), n_starts=2),
        TenantSpec(name="b", trace=ramp_trace(BASE * 0.5, 2, end_scale=1.5,
                                              noise=0.0), n_starts=2,
                   catalog=cat_other, delta_max=4.0),
        TenantSpec(name="c", trace=constant_trace(BASE, 3), n_starts=2)]
    kw = dict(run_ca_baseline=False, controller="mpc", horizon=3,
              forecaster="holt_winters", forecaster_kwargs=dict(period=24),
              device="cpu")
    seq = replay_fleet(cat, specs, replay_mode="sequential", **kw)
    bat = replay_fleet(cat, specs, replay_mode="batched", hot_loop="vmap",
                       **kw)
    _assert_same(seq, bat)
    assert seq.metrics.total_cost_integral == bat.metrics.total_cost_integral
    it_s = [s.solver_iters for r in seq.tenants for s in r.steps]
    assert it_s == [s.solver_iters for r in bat.tenants for s in r.steps]


def test_window_cold_start_and_admm_engines_agree(catalogs):
    cat, _ = catalogs
    specs = [TenantSpec(name="a", trace=flash_crowd_trace(
                 BASE, 3, burst_scale=2.0, noise=0.0, seed=1), n_starts=3),
             TenantSpec(name="b", trace=ramp_trace(
                 BASE * 0.6, 3, end_scale=1.8, noise=0.0), n_starts=3)]
    kw = dict(run_ca_baseline=False, controller="mpc", horizon=3,
              forecaster="oracle", cold_start="window", device="cpu")
    seq = replay_fleet(cat, specs, replay_mode="sequential", **kw)
    bat = replay_fleet(cat, specs, replay_mode="batched", hot_loop="vmap",
                       **kw)
    _assert_same(seq, bat)
    # ADMM with traces: both engines run it (ADMMTrace rows come back)
    # and commit the same counts
    cfg = HorizonSolverConfig(solver="admm", admm_iters=8, inner_steps=10)
    kw.update(solver_config=cfg, capture_solver_trace=True,
              cold_start="myopic", forecaster="last_value")
    outs = [replay_fleet(cat, specs, replay_mode=m, hot_loop=h, **kw)
            for m, h in (("sequential", "kernel"), ("batched", "vmap"),
                         ("batched", "kernel"))]
    _assert_same(outs[0], outs[1])
    for out in outs:
        warm = [tr for lane in out.solver_traces for tr in lane]
        assert len(warm) == 4
        assert all(isinstance(tr, ADMMTrace) for tr in warm)
        for tr in warm:
            k = int((~np.isnan(tr.primal)).sum())
            assert 1 <= k <= cfg.admm_iters
            assert (tr.inner[:k] > 0).all() and (tr.inner[k:] == -1).all()


def test_window_scores_and_plan_state(catalogs):
    """The window score is Σ_h f_h(candidate) and the cold tick commits its
    winner; the controller keeps its (H, n) plan and warms from it."""
    from repro_torch.core import multistart_solve, objective_value
    from repro_torch.horizon import (select_window_candidate,
                                     window_candidate_scores)
    cat, _ = catalogs
    trace = ramp_trace(BASE * 0.6, 6, end_scale=2.5, noise=0.0)
    ctl = ModelPredictiveController(
        catalog=cat, n_starts=4, horizon=4, cold_start="window",
        forecaster=make_forecaster("oracle", trace=trace), device="cpu")
    probs = ctl.window_problems(ctl.window_demands(trace[0]))
    ms = multistart_solve(probs[0], n_starts=4)
    cands = ms.x_int_all.numpy().astype(np.float64)
    scores = window_candidate_scores(probs, cands)
    for s, cand in zip(scores, cands):
        manual = sum(float(objective_value(pb, torch.as_tensor(
            cand, dtype=torch.float32))) for pb in probs)
        np.testing.assert_allclose(s, manual, rtol=1e-5)
    j = select_window_candidate(scores, ms.feas_int_all.numpy())
    ctl.forecaster = make_forecaster("oracle", trace=trace)
    np.testing.assert_array_equal(ctl.step(trace[0]).counts, cands[j])
    for d in trace[1:3]:
        ctl.step(d)
    assert ctl.plan.shape == (4, cat.n) and len(ctl.history) == 3
    np.testing.assert_array_equal(ctl.shifted_plan()[0], ctl.x_current)
    with pytest.raises(ValueError):
        ModelPredictiveController(catalog=cat, horizon=0, device="cpu")
    with pytest.raises(ValueError):
        ModelPredictiveController(catalog=cat, cold_start="nope",
                                  device="cpu")
