"""Priced-scenario fleets through the port's replay engines, held to the
JAX reference on the CPU: the scenario builders' specs (terms, spot twins,
availability overlay, CA pools), the batched replay of each scenario
against the reference's batched replay from the reference's starts, the
port's batched engine against its sequential one (equal counts, as
tests/fleet/test_scenario_terms.py:42 demands of the reference), and the
spot overlay holding no interrupted twin."""
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
from repro_torch.bridge import terms_arrays  # noqa: E402

TENANT_RTOL, FLEET_RTOL = 0.05, 2e-2   # tests/fleet/test_solve_fleet.py:113-117
BASE = np.array([8.0, 16.0, 4.0, 100.0]) * 25   # benchmarks/scenario_bench.py
PRIORITIES = ("critical", "standard", "batch")
B, T = 3, 4


def _fleet(pkg, ticks=T):
    """benchmarks/scenario_bench.py::_fleet: alternating diurnal and
    flash_crowd tenants at staggered scales, two starts, churn 6."""
    specs = []
    for s in range(B):
        kind = ("diurnal", "flash_crowd")[s % 2]
        kw = dict(seed=s, noise=0.08)
        kw.update(dict(amplitude=0.45, phase=3.0 * s) if kind == "diurnal"
                  else dict(burst_scale=2.5, decay=5.0))
        specs.append(pkg.TenantSpec(
            name=f"{kind}{s}",
            trace=pkg.make_trace(kind, BASE * (0.7 + 0.2 * (s % 3)), ticks,
                                 **kw),
            n_starts=2, delta_max=6.0))
    return specs


def _scenario(pkg, core, name):
    """(catalog, specs) of one scenario fleet on the small catalog."""
    cat = core.Catalog(core.make_cloud_catalog().instances[::40])
    specs = _fleet(pkg)
    if name == "slo":
        return cat, pkg.with_slo_pricing(specs, price=2.0)
    if name == "priority":
        return cat, pkg.with_priority_classes(specs, PRIORITIES, catalog=cat,
                                              eviction_price=0.6)
    return pkg.make_spot_fleet(cat, specs, interruption_rate=0.08, seed=3)


SCENARIOS = ("slo", "priority", "spot")


@pytest.mark.parametrize("name", SCENARIOS)
def test_builders_match_reference(name):
    jcat, jspecs = _scenario(jfleet, jcore, name)
    tcat, tspecs = _scenario(tfleet, tcore, name)
    assert tcat.n == jcat.n
    np.testing.assert_array_equal(tcat.matrices()[2], jcat.matrices()[2])
    assert all(s.terms == () for s in _fleet(tfleet))   # inputs untouched
    for j, t in zip(jspecs, tspecs):
        assert t.name == j.name
        np.testing.assert_array_equal(t.trace, j.trace)
        jt, tt = terms_arrays(j.terms), terms_arrays(t.terms)
        assert [k for k, _ in tt] == [k for k, _ in jt]
        for (_, pt), (_, pj) in zip(tt, jt):
            for k in pj:
                np.testing.assert_array_equal(pt[k], pj[k])
        for f in ("spot_idx", "spot_availability", "ca_pool_idx",
                  "allowed_idx"):
            a, b = getattr(t, f), getattr(j, f)
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_array_equal(a, b)
    if name == "priority":
        assert tspecs[0].terms == ()
        assert (float(tspecs[2].terms[0].params["price"][0])
                > float(tspecs[1].terms[0].params["price"][0]))


def test_builders_validate_as_reference():
    cat = tcore.Catalog(tcore.make_cloud_catalog().instances[::40])
    specs = _fleet(tfleet)
    with pytest.raises(ValueError, match="unknown priority class"):
        tfleet.with_priority_classes(specs, ["critical", "standard", "nope"],
                                     catalog=cat)
    with pytest.raises(ValueError, match="priorities"):
        tfleet.with_priority_classes(specs, ["critical"], catalog=cat)
    assert tfleet.PRIORITY_CLASSES == jfleet.PRIORITY_CLASSES
    bad = [tfleet.TenantSpec(name="own-cat", trace=specs[0].trace,
                             catalog=cat)]
    with pytest.raises(ValueError, match="per-tenant catalog"):
        tfleet.make_spot_fleet(cat, bad)


def _replay_pair(monkeypatch, name):
    """Both packages' batched replays of one scenario fleet, the CA on; the
    port's cold start is fed the reference's starts."""
    jcat, jspecs = _scenario(jfleet, jcore, name)
    tcat, tspecs = _scenario(tfleet, tcore, name)
    starts = []

    def capture(batch, n_starts, seed=0):
        out = jfleet.make_fleet_starts(batch, n_starts, seed)
        starts.append(np.array(out))
        return out

    monkeypatch.setattr(jreplay, "make_fleet_starts", capture)
    ref = jfleet.replay_fleet(jcat, jspecs, replay_mode="batched",
                              hot_loop="ref")
    fed = iter(starts)
    monkeypatch.setattr(treplay, "make_fleet_starts",
                        lambda batch, n_starts, seed=0:
                        torch.as_tensor(next(fed)))
    port = tfleet.replay_fleet(tcat, tspecs, replay_mode="batched",
                               device="cpu")
    assert next(fed, None) is None
    return ref, port, tspecs


def _assert_no_interrupted_twin(specs, replay):
    """No tick holds a spot twin its availability row marks down."""
    saw = False
    for spec, rep in zip(specs, replay.tenants):
        if spec.spot_idx is None:
            continue
        avail = spec.spot_availability
        for t, step in enumerate(rep.steps):
            down = spec.spot_idx[avail[min(t, len(avail) - 1)] <= 0.0]
            saw |= len(down) > 0
            assert np.all(step.counts[down] == 0.0)
    return saw


@pytest.mark.parametrize("name", SCENARIOS)
def test_batched_scenario_replay_matches_reference(monkeypatch, name):
    ref, port, tspecs = _replay_pair(monkeypatch, name)
    cost_r = np.asarray([t.metrics.cost_integral for t in ref.tenants])
    cost_p = np.asarray([t.metrics.cost_integral for t in port.tenants])
    np.testing.assert_allclose(cost_p, cost_r, rtol=TENANT_RTOL)
    assert abs(cost_p.sum() - cost_r.sum()) / cost_r.sum() < FLEET_RTOL
    for tr, tp in zip(ref.tenants, port.tenants):
        assert ([s.metrics.satisfied for s in tp.steps]
                == [s.metrics.satisfied for s in tr.steps])
        for s in tp.steps:
            np.testing.assert_array_equal(s.counts, np.round(s.counts))
    # the CA never sees terms or twins: its side equals the reference's
    assert port.metrics.baseline_cost_integral == pytest.approx(
        ref.metrics.baseline_cost_integral, rel=1e-12)
    if name == "spot":
        assert _assert_no_interrupted_twin(tspecs, port), \
            "the seed interrupted no twin: the check would be vacuous"


@pytest.mark.parametrize("name", SCENARIOS)
def test_batched_equals_sequential_with_terms(name):
    """The port's engines commit the same counts with terms attached (and,
    for spot, the overlay zeroing interrupted twins)."""
    cat, specs = _scenario(tfleet, tcore, name)
    seq = tfleet.replay_fleet(cat, specs, replay_mode="sequential",
                              run_ca_baseline=False, device="cpu")
    bat = tfleet.replay_fleet(cat, specs, replay_mode="batched",
                              hot_loop="vmap", run_ca_baseline=False,
                              device="cpu")
    for a, b in zip(seq.tenants, bat.tenants):
        assert len(a.steps) == len(b.steps) == T
        for sa, sb in zip(a.steps, b.steps):
            np.testing.assert_array_equal(sa.counts, sb.counts)
    if name == "spot":
        assert _assert_no_interrupted_twin(specs, seq)
        assert _assert_no_interrupted_twin(specs, bat)
