"""The port's numpy copies of the Cluster-Autoscaler simulator and of the
paper's scenarios, pinned equal to the JAX reference's originals: the same
counts, iterations and costs, the same pools and scenarios."""
from dataclasses import asdict

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro.fleet.replay as jreplay  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.fleet.replay as treplay  # noqa: E402

EXPANDERS = ("random", "first-fit", "least-waste")
MODES = ("wave", "incremental")
SCALE_DOWNS = ("utilization", "greedy", "none")


@pytest.fixture(scope="module")
def catalogs():
    """Both packages' catalog trimmed to every 20th instance (n = 94)."""
    return (jcore.Catalog(jcore.make_cloud_catalog().instances[::20]),
            tcore.Catalog(tcore.make_cloud_catalog().instances[::20]))


def _tenants(n_cat, seed, B=5):
    """B random demands and pool sets (some pools pre-deployed, caps from 3
    to 29), as tests/core/test_autoscaler.py draws them."""
    rng = np.random.default_rng(seed)
    demands = (rng.uniform(1, 40, size=(B, 4))
               * np.array([1.0, 2.0, 0.5, 12.0]))
    pools = []
    for _ in range(B):
        k = int(rng.integers(2, 7))
        idx = rng.choice(n_cat, size=k, replace=False)
        existing = {int(j): int(rng.integers(0, 4)) for j in idx[:2]}
        pools.append((idx, existing, int(rng.integers(3, 30))))
    return demands, pools


def _pools(core, cat, spec):
    idx, existing, cap = spec
    return core.default_pools_for(cat, idx, existing=existing, max_count=cap)


def _assert_same(a, b):
    np.testing.assert_array_equal(a.counts, b.counts)
    assert a.iterations == b.iterations
    assert a.satisfied == b.satisfied
    assert a.cost == b.cost


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("expander", EXPANDERS)
def test_simulator_equals_reference(catalogs, expander, mode):
    jcat, tcat = catalogs
    demands, specs = _tenants(jcat.n, 11)
    for seed in range(3):
        for sd in SCALE_DOWNS:
            for d, spec in zip(demands, specs):
                kw = dict(expander=expander, scale_down=sd, mode=mode,
                          seed=seed)
                _assert_same(
                    tcore.simulate_cluster_autoscaler(
                        tcat, _pools(tcore, tcat, spec), d, **kw),
                    jcore.simulate_cluster_autoscaler(
                        jcat, _pools(jcore, jcat, spec), d, **kw))


@pytest.mark.parametrize("scale_down", SCALE_DOWNS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("expander", EXPANDERS)
def test_batch_stepper_equals_sequential_oracle(catalogs, expander, mode,
                                                scale_down):
    """The lockstep stepper consumes each tenant's rng stream in the order
    of its sequential run, so even the random expander agrees."""
    _, tcat = catalogs
    demands, specs = _tenants(tcat.n, 7)
    pools = [_pools(tcore, tcat, s) for s in specs]
    kw = dict(expander=expander, scale_down=scale_down, mode=mode, seed=3)
    seq = [tcore.simulate_cluster_autoscaler(tcat, p, d, **kw)
           for p, d in zip(pools, demands)]
    bat = tcore.simulate_cluster_autoscaler_batch(tcat, pools, demands, **kw)
    assert len(bat) == len(seq)
    for a, b in zip(seq, bat):
        np.testing.assert_array_equal(a.counts, b.counts)
        assert a.iterations == b.iterations and a.satisfied == b.satisfied
        assert a.cost == pytest.approx(b.cost, abs=1e-9)


def test_batch_stepper_shared_pools_and_capped_wave(catalogs):
    jcat, tcat = catalogs
    demand = np.array([64, 128, 16, 500], np.float64)
    idx = tcat.select(lambda t: t.cpu == 2)[:2]
    pools = tcore.default_pools_for(tcat, idx, max_count=3)
    seq = tcore.simulate_cluster_autoscaler(tcat, pools, demand)
    bat, = tcore.simulate_cluster_autoscaler_batch(tcat, pools,
                                                   demand[None, :])
    assert not seq.satisfied
    _assert_same(seq, bat)
    _assert_same(bat, jcore.simulate_cluster_autoscaler_batch(
        jcat, jcore.default_pools_for(jcat, idx, max_count=3),
        demand[None, :])[0])


def test_default_pools_equal(catalogs):
    jcat, tcat = catalogs
    idx = np.array([3, 17, 40, 41])
    existing = {17: 2, 40: 5}
    a = jcore.default_pools_for(jcat, idx, existing=existing, max_count=9)
    b = tcore.default_pools_for(tcat, idx, existing=existing, max_count=9)
    assert [asdict(p) for p in a] == [asdict(p) for p in b]


@pytest.mark.parametrize("demand", [[8, 16, 4, 100.0], [32, 128, 12, 500.0],
                                    [1, 0, 0, 0.0], [2000, 1, 1, 1.0]])
@pytest.mark.parametrize("k", [1, 8])
def test_default_ca_pools_equal(catalogs, demand, k):
    jcat, tcat = catalogs
    np.testing.assert_array_equal(
        treplay.default_ca_pools(tcat, np.asarray(demand), k=k),
        jreplay.default_ca_pools(jcat, np.asarray(demand), k=k))


def _assert_scenarios_equal(a, b):
    assert [s.name for s in a] == [s.name for s in b]
    for x, y in zip(a, b):
        assert (x.name, x.title) == (y.name, y.title)
        np.testing.assert_array_equal(x.demand, y.demand)
        np.testing.assert_array_equal(x.existing, y.existing)
        assert (x.allowed_idx is None) == (y.allowed_idx is None)
        if x.allowed_idx is not None:
            np.testing.assert_array_equal(x.allowed_idx, y.allowed_idx)
        assert [asdict(p) for p in x.pools] == [asdict(p) for p in y.pools]


def test_build_scenarios_equal_full_catalog():
    a = jcore.build_scenarios(jcore.make_cloud_catalog())
    b = tcore.build_scenarios(tcore.make_cloud_catalog())
    assert len(b) == 5
    _assert_scenarios_equal(a, b)


def test_build_and_scale_scenarios_equal_reduced(catalogs):
    jcat, tcat = catalogs
    a, b = jcore.build_scenarios(jcat), tcore.build_scenarios(tcat)
    _assert_scenarios_equal(a, b)
    _assert_scenarios_equal([jcore.scaled_scenario(s, 2.5) for s in a],
                            [tcore.scaled_scenario(s, 2.5) for s in b])
