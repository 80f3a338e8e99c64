"""The slice as a whole: ``replay_fleet(controller="mpc")`` in both engines
against the JAX reference's on ``instances[::40]``, from the same cold
starts (the port is fed the reference's: jax.random and torch.Generator
draw differently). Held as tests/test_torch_replay.py holds the myopic
replay: per tenant rtol 0.05, fleet 2e-2, equal per-tick satisfaction
(tests/fleet/test_solve_fleet.py:112-117); the oracle twin's regret to
the same tolerance."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.core as jcore  # noqa: E402
import repro.core.multistart as jms  # noqa: E402
import repro.fleet as jfleet  # noqa: E402
import repro.fleet.replay as jreplay  # noqa: E402

import repro_torch.core as tcore  # noqa: E402
import repro_torch.core.multistart as tms  # noqa: E402
import repro_torch.fleet as tfleet  # noqa: E402
import repro_torch.fleet.replay as treplay  # noqa: E402

T = 3
TENANTS = [("web", "diurnal", [8, 16, 4, 100.0], 1, 8.0),
           ("launch", "flash_crowd", [4, 8, 2, 50.0], 2, 16.0),
           ("adoption", "ramp", [6, 24, 3, 150.0], 3, 8.0)]
TENANT_RTOL, FLEET_RTOL = 0.05, 2e-2   # tests/fleet/test_solve_fleet.py:113-117


def _specs(TenantSpec, make_trace):
    return [TenantSpec(name=name, trace=make_trace(kind, np.asarray(base),
                                                   T, seed=seed),
                       delta_max=dm)
            for name, kind, base, seed, dm in TENANTS]


def _mpc_pair(monkeypatch, mode, jkw=None, tkw=None, **kw):
    """Both packages replay the fleet with the MPC controller (``jkw`` /
    ``tkw`` extra keywords of the reference's and the port's call); every
    cold start of the port is the reference's."""
    jcat = jcore.Catalog(jcore.make_cloud_catalog().instances[::40])
    tcat = tcore.Catalog(tcore.make_cloud_catalog().instances[::40])
    mod_j, mod_t, name = ((jreplay, treplay, "make_fleet_starts")
                          if mode == "batched" else (jms, tms, "make_starts"))
    make = getattr(mod_j, name)
    starts = []

    def capture(*a, **k):
        out = make(*a, **k)
        starts.append(np.array(out))
        return out

    monkeypatch.setattr(mod_j, name, capture)
    fed = iter(starts)
    monkeypatch.setattr(mod_t, name,
                        lambda *a, **k: torch.as_tensor(next(fed)))
    common = dict(replay_mode=mode, controller="mpc", run_ca_baseline=False,
                  **kw)
    ref = jfleet.replay_fleet(jcat, _specs(jfleet.TenantSpec,
                                           jfleet.make_trace),
                              **common, **(jkw or {}))
    port = tfleet.replay_fleet(tcat, _specs(tfleet.TenantSpec,
                                            tfleet.make_trace),
                               device="cpu", **common, **(tkw or {}))
    assert next(fed, None) is None
    return ref, port


def _assert_close(ref, port):
    cost_r = np.asarray([t.metrics.cost_integral for t in ref.tenants])
    cost_p = np.asarray([t.metrics.cost_integral for t in port.tenants])
    np.testing.assert_allclose(cost_p, cost_r, rtol=TENANT_RTOL)
    assert abs(cost_p.sum() - cost_r.sum()) / cost_r.sum() < FLEET_RTOL
    for tr, tp in zip(ref.tenants, port.tenants):
        assert len(tp.steps) == len(tr.steps) == T
        assert ([s.metrics.satisfied for s in tp.steps]
                == [s.metrics.satisfied for s in tr.steps])
        assert [s.replanned for s in tp.steps] == [True] + [False] * (T - 1)
        for s in tp.steps:
            np.testing.assert_array_equal(s.counts, np.round(s.counts))
        assert all(s.solver_iters > 0 for s in tp.steps[1:])
    assert port.metrics.controller == "mpc"


@pytest.mark.parametrize("mode", ["sequential", "batched"])
def test_mpc_replay_matches_reference(monkeypatch, mode):
    """H = 3 on the last-value forecaster, the oracle twin beside it."""
    ref, port = _mpc_pair(monkeypatch, mode, horizon=3,
                          run_oracle_baseline=True)
    _assert_close(ref, port)
    assert port.metrics.replay_mode == mode
    assert len(port.metrics.oracle) == len(TENANTS)
    np.testing.assert_allclose(port.metrics.oracle_cost_integral,
                               ref.metrics.oracle_cost_integral,
                               rtol=FLEET_RTOL)
    assert "regret vs oracle" in port.metrics.summary()


@pytest.mark.parametrize("mode,solver", [("batched", "fixed"),
                                         ("sequential", "admm")])
def test_mpc_replay_engines_match_reference(monkeypatch, mode, solver):
    """The fixed-step and ADMM engines through replay_fleet's
    solver_config, with a Holt-Winters forecast."""
    import repro.horizon as jh
    import repro_torch.horizon as th
    kw = dict(steps=200) if solver == "fixed" else dict(admm_iters=10)
    ref, port = _mpc_pair(
        monkeypatch, mode, horizon=2, forecaster="holt_winters",
        forecaster_kwargs=dict(period=24),
        jkw=dict(solver_config=jh.HorizonSolverConfig(solver=solver, **kw)),
        tkw=dict(solver_config=th.HorizonSolverConfig(solver=solver, **kw)))
    _assert_close(ref, port)
    if solver == "fixed":
        assert all(s.solver_iters == 200 for t in port.tenants
                   for s in t.steps[1:])
