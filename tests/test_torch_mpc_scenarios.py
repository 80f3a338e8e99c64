"""Priced MPC fleets in the port on the CPU — the cases of
tests/fleet/test_scenario_terms.py:95-111: the spot fleet through the
batched MPC engine (windows stacked to the bucket's union term signature,
the availability overlay) commits the sequential MPC engine's counts
(``hot_loop="vmap"``), H = 1 is the myopic controller with SLO pricing
attached, and the batched MPC replay of the priority fleet — mixed term
signatures in one bucket — lies within the reference's tolerances of the
reference's (per tenant rtol 0.05, fleet 2e-2,
tests/fleet/test_solve_fleet.py:112-117)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.core as jcore  # noqa: E402
import repro.fleet as jfleet  # noqa: E402

import repro_torch.core as tcore  # noqa: E402
import repro_torch.fleet as tfleet  # noqa: E402

TENANT_RTOL, FLEET_RTOL = 0.05, 2e-2
BASE = np.array([8.0, 16.0, 4.0, 100.0]) * 25
T = 3


def _fleet(pkg, ticks=T):
    """tests/fleet/test_scenario_terms.py's fleet_specs, ``ticks`` long (5
    there)."""
    return [pkg.TenantSpec(name=f"t{i}",
                           trace=pkg.make_trace("diurnal", BASE * (1 + 0.3 * i),
                                                ticks, seed=i),
                           delta_max=6.0, n_starts=2)
            for i in range(3)]


def _catalog(core):
    return core.Catalog(core.make_cloud_catalog().instances[:24])


def _counts(out):
    return [[s.counts for s in r.steps] for r in out.tenants]


def test_spot_fleet_mpc_engines_agree():
    """A 200-iteration budget keeps the sequential engine's
    per-tenant solves of the n = 48 windows inside the file's time."""
    from repro_torch.horizon import HorizonSolverConfig
    spot_cat, specs = tfleet.make_spot_fleet(_catalog(tcore),
                                             _fleet(tfleet), seed=3)
    kw = dict(run_ca_baseline=False, controller="mpc", horizon=3,
              solver_config=HorizonSolverConfig(steps=200), device="cpu")
    seq = tfleet.replay_fleet(spot_cat, specs, replay_mode="sequential", **kw)
    bat = tfleet.replay_fleet(spot_cat, specs, replay_mode="batched",
                              hot_loop="vmap", **kw)
    for a, b in zip(_counts(seq), _counts(bat)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    # the overlay holds: no interrupted twin is held
    for spec, rep in zip(specs, bat.tenants):
        avail = spec.spot_availability
        for t, step in enumerate(rep.steps):
            down = spec.spot_idx[avail[min(t, len(avail) - 1)] <= 0.0]
            assert np.all(step.counts[down] == 0.0)


def test_mpc_h1_equals_myopic_with_terms():
    cat = _catalog(tcore)
    specs = tfleet.with_slo_pricing(_fleet(tfleet), price=1.2)
    for mode in ("sequential", "batched"):
        kw = dict(run_ca_baseline=False, replay_mode=mode, device="cpu")
        myo = tfleet.replay_fleet(cat, specs, **kw)
        mpc = tfleet.replay_fleet(cat, specs, controller="mpc", horizon=1,
                                  **kw)
        for a, b in zip(_counts(myo), _counts(mpc)):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


def test_priority_mpc_replay_matches_reference():
    """The batched MPC engine over a bucket whose tenants carry different
    term kinds (the critical one none), against the reference's."""
    prio = ["critical", "standard", "batch"]
    out = {}
    for name, pkg, core, kw in (("ref", jfleet, jcore, {}),
                                ("port", tfleet, tcore,
                                 dict(device="cpu"))):
        cat = _catalog(core)
        specs = pkg.with_priority_classes(_fleet(pkg), prio, catalog=cat)
        out[name] = pkg.replay_fleet(cat, specs, replay_mode="batched",
                                     controller="mpc", horizon=3,
                                     run_ca_baseline=False, **kw)
    cost = {k: np.asarray([r.metrics.cost_integral for r in v.tenants])
            for k, v in out.items()}
    np.testing.assert_allclose(cost["port"], cost["ref"], rtol=TENANT_RTOL)
    assert (abs(cost["port"].sum() - cost["ref"].sum()) / cost["ref"].sum()
            < FLEET_RTOL)
    sat = {k: [[s.metrics.satisfied for s in r.steps] for r in v.tenants]
           for k, v in out.items()}
    assert sat["port"] == sat["ref"]
