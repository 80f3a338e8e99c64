"""The Cluster-Autoscaler baseline of the port's fleet replay against the
JAX reference's, on the CPU: ``replay_fleet(run_ca_baseline=True)`` on
both packages, ragged traces and a tenant with its own catalog included;
and the port's vectorized CA engine against its sequential oracle."""
from dataclasses import asdict

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

# (name, trace kind, base demand, seed, delta_max, ticks): ragged lengths
TENANTS = [("web", "diurnal", [8, 16, 4, 100.0], 1, 8.0, 3),
           ("launch", "flash_crowd", [4, 8, 2, 50.0], 2, 16.0, 2),
           ("adoption", "ramp", [6, 24, 3, 150.0], 3, 8.0, 3),
           ("batch", "weekly", [16, 64, 6, 300.0], 4, 8.0, 1)]


def _catalogs(core):
    """The fleet catalog and a second one that the last tenant brings."""
    full = core.make_cloud_catalog().instances
    return core.Catalog(full[::40]), core.Catalog(full[7::40])


def _specs(fleet, core, own_catalog):
    specs = [fleet.TenantSpec(name=name,
                              trace=fleet.make_trace(kind, np.asarray(base),
                                                     ticks, seed=seed),
                              delta_max=dm)
             for name, kind, base, seed, dm, ticks in TENANTS]
    specs[-1].catalog = own_catalog
    # explicit pools for one tenant, the peak-sized default for the others
    specs[1].ca_pool_idx = np.array([0, 5, 11, 30])
    return specs


def _fleet(core, fleet):
    cat, other = _catalogs(core)
    return cat, _specs(fleet, core, other)


@pytest.fixture(scope="module")
def pair():
    """Both packages replay the same fleet with the CA baseline; the port's
    cold start is fed the reference's starts (jax.random draws differ from
    torch.Generator's)."""
    mp = pytest.MonkeyPatch()
    starts = []

    def capture(batch, n_starts, seed=0):
        out = jfleet.make_fleet_starts(batch, n_starts, seed)
        starts.append(np.array(out))
        return out

    mp.setattr(jreplay, "make_fleet_starts", capture)
    jcat, jspecs = _fleet(jcore, jfleet)
    ref = jfleet.replay_fleet(jcat, jspecs, replay_mode="batched",
                              hot_loop="ref")
    fed = iter(starts)
    mp.setattr(treplay, "make_fleet_starts",
               lambda batch, n_starts, seed=0: torch.as_tensor(next(fed)))
    tcat, tspecs = _fleet(tcore, tfleet)
    port = tfleet.replay_fleet(tcat, tspecs, replay_mode="batched",
                               device="cpu")
    assert next(fed, None) is None
    mp.undo()
    return ref, port


def test_ca_metrics_and_counts_equal_reference(pair):
    ref, port = pair
    assert len(port.tenants) == len(ref.tenants) == len(TENANTS)
    for r, p in zip(ref.tenants, port.tenants):
        assert asdict(p.ca_metrics) == asdict(r.ca_metrics)
        np.testing.assert_array_equal(p.ca_counts, r.ca_counts)
        assert p.ca_metrics.ticks == len(p.steps) == len(r.steps)
    assert ([asdict(m) for m in port.metrics.baseline]
            == [asdict(m) for m in ref.metrics.baseline])


def test_savings_and_summary_equal_reference(pair):
    ref, port = pair
    # the optimizer side commits the reference's counts (same starts)
    for r, p in zip(ref.tenants, port.tenants):
        for a, b in zip(r.steps, p.steps):
            np.testing.assert_array_equal(b.counts, a.counts)
    assert (port.metrics.baseline_cost_integral
            == ref.metrics.baseline_cost_integral)
    assert (port.metrics.cost_savings_vs_baseline_pct
            == ref.metrics.cost_savings_vs_baseline_pct)
    # every line but the warm ticks' PGD iteration percentiles, which the
    # reference keeps out of its metrics' equality too (compare=False:
    # last-ulp differences move Armijo accepts by a few iterations)
    lines = [ln.splitlines() for ln in (port.metrics.summary(),
                                        ref.metrics.summary())]
    assert len(lines[0]) == len(lines[1])
    for a, b in zip(*lines):
        if "solver iters/tick" not in a:
            assert a == b
    assert any("savings vs CA" in ln for ln in lines[0])


def test_replay_ca_engines_agree():
    """ca_engine="sequential" (the per-tenant oracle) commits what the
    vectorized engine commits, tenant for tenant and tick for tick."""
    cat, specs = _fleet(tcore, tfleet)
    vec, seq = (tfleet.replay_fleet(cat, specs, replay_mode="batched",
                                    ca_engine=engine, device="cpu")
                for engine in ("vectorized", "sequential"))
    assert vec.metrics.baseline == seq.metrics.baseline
    for a, b in zip(vec.tenants, seq.tenants):
        np.testing.assert_array_equal(a.ca_counts, b.ca_counts)
    assert vec.metrics.summary() == seq.metrics.summary()


@pytest.mark.parametrize("mode", ["wave", "incremental"])
@pytest.mark.parametrize("expander", ["random", "first-fit", "least-waste"])
def test_vectorized_ca_equals_sequential_oracle(expander, mode):
    """The CA side alone, over longer ragged traces: the fleet stepper
    against one sequential baseline per tenant, and both against the
    reference's."""
    tcat, tspecs = _fleet(tcore, tfleet)
    jcat, jspecs = _fleet(jcore, jfleet)
    for specs, fleet in ((tspecs, tfleet), (jspecs, jfleet)):
        for s, ticks in zip(specs, (24, 9, 17, 5)):
            s.trace = fleet.make_trace("diurnal", s.trace[0], ticks, seed=ticks)
    vec = treplay._replay_ca_fleet(tcat, tspecs, expander, mode)
    seq = [treplay._ca_baseline(tcat, s, expander, mode) for s in tspecs]
    ref = jreplay._replay_ca_fleet(jcat, jspecs, expander, mode)
    for s, (mv, cv), (ms, cs), (mr, cr) in zip(tspecs, vec, seq, ref):
        assert mv == ms and asdict(mv) == asdict(mr)
        assert mv.ticks == len(s.trace)
        np.testing.assert_array_equal(cv, cs)
        np.testing.assert_array_equal(cv, cr)


def test_unknown_ca_engine_raises():
    cat, specs = _fleet(tcore, tfleet)
    with pytest.raises(ValueError, match="ca_engine"):
        tfleet.replay_fleet(cat, specs, replay_mode="batched",
                            ca_engine="gpu", device="cpu")
