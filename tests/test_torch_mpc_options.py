"""replay_fleet(controller="mpc")'s options in the port on the CPU:
``solver_config`` reaches every warm tick in both engines, the oracle
twin's regret, ``health=`` observes without changing an allocation (bit
for bit), an anytime budget truncates the warm ticks as the reference's
does (the same flags; costs per tenant rtol 0.05,
tests/fleet/test_solve_fleet.py:112-117) and needs the adaptive engine
(the reference's ValueError), and the lookahead keeps serving demand."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.core as jcore  # noqa: E402
import repro.fleet as jfleet  # noqa: E402
from repro.core.pgd import AnytimeConfig as JAnytime  # noqa: E402

from repro_torch.core import Catalog, make_cloud_catalog  # noqa: E402
from repro_torch.core.pgd import AnytimeConfig  # noqa: E402
from repro_torch.fleet import TenantSpec, replay_fleet  # noqa: E402
from repro_torch.fleet.traces import diurnal_trace, flash_crowd_trace  # noqa: E402
from repro_torch.horizon import HorizonSolverConfig  # noqa: E402
from repro_torch.obs import HealthMonitor  # noqa: E402

BASE = np.array([8.0, 16.0, 4.0, 100.0])
TENANT_RTOL = 0.05


@pytest.fixture(scope="module")
def cat():
    return Catalog(make_cloud_catalog().instances[::40])


def _spec(ticks=4, name="t", TenantSpec=TenantSpec, trace=diurnal_trace):
    return TenantSpec(name=name, trace=trace(BASE, ticks, amplitude=0.3,
                                             noise=0.0), n_starts=2)


def _tight(Config):
    """A budget that truncates a warm solve past 8 iterations: a fake
    clock burning 5 ms a reading against 12 ms, 4-iteration chunks."""
    t = [0.0]

    def clock():
        t[0] += 5e-3
        return t[0]

    return Config(deadline_ms=12.0, chunk_iters=4, clock=clock)


@pytest.mark.parametrize("mode", ["sequential", "batched"])
def test_solver_config_reaches_every_warm_tick(cat, mode):
    kw = dict(run_ca_baseline=False, replay_mode=mode, controller="mpc",
              horizon=3, device="cpu")
    out = replay_fleet(cat, [_spec()], solver_config=HorizonSolverConfig(
        steps=7), **kw)
    warm = out.tenants[0].steps[1:]
    assert all(0 < s.solver_iters <= 7 for s in warm)
    assert out.tenants[0].steps[0].solver_iters == 0
    fixed = replay_fleet(cat, [_spec()], solver_config=HorizonSolverConfig(
        solver="fixed", steps=11), **kw)
    assert all(s.solver_iters == 11 for s in fixed.tenants[0].steps[1:])


def test_oracle_regret_plumbing(cat):
    out = replay_fleet(cat, [_spec(3)], run_ca_baseline=False,
                       controller="mpc", horizon=2, forecaster="oracle",
                       run_oracle_baseline=True, device="cpu")
    assert out.metrics.oracle is not None
    assert out.metrics.regret_vs_oracle == 0.0
    assert "regret vs oracle" in out.metrics.summary()
    with pytest.raises(ValueError):
        replay_fleet(cat, [_spec(3)], controller="myopic",
                     run_oracle_baseline=True, device="cpu")


@pytest.mark.parametrize("mode", ["sequential", "batched"])
def test_health_observes_without_changing_allocations(cat, mode):
    specs = [_spec(3, "a"), _spec(3, "b", trace=lambda b, T, **kw:
                                  flash_crowd_trace(b, T, noise=0.0))]
    kw = dict(run_ca_baseline=False, replay_mode=mode, controller="mpc",
              horizon=3, device="cpu")
    off = replay_fleet(cat, specs, **kw)
    mon = HealthMonitor()
    on = replay_fleet(cat, specs, health=mon, **kw)
    for ra, rb in zip(off.tenants, on.tenants):
        for sa, sb in zip(ra.steps, rb.steps):
            np.testing.assert_array_equal(sa.counts, sb.counts)
    rep = mon.report()
    assert on.metrics.health is rep and off.metrics.health is None
    # the sequential engine times each (tenant, tick), the batched one
    # each fleet tick
    assert rep.ticks_observed == (6 if mode == "sequential" else 3)
    assert rep.kkt_ticks_certified == 6
    assert np.isfinite(rep.worst_kkt_stationarity)
    assert any("health:" in ln for ln in on.metrics.summary().splitlines())


@pytest.mark.parametrize("mode", ["sequential", "batched"])
def test_anytime_mpc_matches_reference(mode):
    """The warm ticks the reference's budget truncates are the port's; the
    engines without chunk-resumable state raise the reference's
    ValueError."""
    jcat = jcore.Catalog(jcore.make_cloud_catalog().instances[::40])
    tcat = Catalog(make_cloud_catalog().instances[::40])
    jspec = _spec(3, TenantSpec=jfleet.TenantSpec)
    kw = dict(run_ca_baseline=False, replay_mode=mode, controller="mpc",
              horizon=3)
    ref = jfleet.replay_fleet(jcat, [jspec], anytime=_tight(JAnytime), **kw)
    port = replay_fleet(tcat, [_spec(3)], anytime=_tight(AnytimeConfig),
                        device="cpu", **kw)
    flags = [s.deadline_hit for s in port.tenants[0].steps]
    assert flags == [s.deadline_hit for s in ref.tenants[0].steps]
    assert flags[0] is False and any(flags)
    np.testing.assert_allclose(port.tenants[0].metrics.cost_integral,
                               ref.tenants[0].metrics.cost_integral,
                               rtol=TENANT_RTOL)
    for solver in ("fixed", "admm"):
        with pytest.raises(ValueError, match="adaptive"):
            replay_fleet(tcat, [_spec(2)], anytime=_tight(AnytimeConfig),
                         solver_config=HorizonSolverConfig(solver=solver),
                         device="cpu", **kw)
    with pytest.raises(ValueError):
        replay_fleet(tcat, [_spec(2)], anytime=_tight(AnytimeConfig),
                     capture_solver_trace=True, device="cpu", **kw)


def test_lookahead_serves_demand(cat):
    spec = TenantSpec(name="fc", trace=flash_crowd_trace(
        BASE, 5, burst_scale=2.5, noise=0.0, seed=3), n_starts=2,
        delta_max=16.0)
    out = replay_fleet(cat, [spec], run_ca_baseline=False, controller="mpc",
                       horizon=4, forecaster="oracle", replay_mode="batched",
                       device="cpu")
    assert all(s.metrics.satisfied for s in out.tenants[0].steps)
    assert out.tenants[0].metrics.slo_violation_ticks == 0
