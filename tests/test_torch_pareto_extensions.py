"""The port's parameter tuning (``repro_torch.core.pareto``: the grid as a
stacked problem, one lane per setting) and the paper's §VII extensions
(``repro_torch.core.extensions``) held to the JAX reference on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the operands are tiny, and the suite runs its files
# in parallel workers, where extra threads only take cores from the others
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import repro.core as jcore  # noqa: E402
import repro.core.extensions as jext  # noqa: E402
import repro.core.pareto as jpareto  # noqa: E402
from repro.testing import make_toy_problem  # noqa: E402

import repro_torch.core as tcore  # noqa: E402
import repro_torch.core.extensions as text  # noqa: E402
import repro_torch.core.pareto as tpareto  # noqa: E402
from repro_torch.bridge import problem_arrays, problem_from_arrays  # noqa: E402

INT_RTOL = 0.05   # integer solutions: tests/fleet/test_solve_fleet.py:113-117
# benchmarks/solver_bench.py's grid
ALPHAS, GAMMAS = (0.005, 0.02, 0.1), (0.001, 0.005, 0.02)
SENS_STEP = 0.1   # sensitivity()'s default rel_step


def _port(jprob):
    return problem_from_arrays(problem_arrays(jprob), device="cpu")


def _s3():
    """s3_enterprise on every 20th type (n = 94), in both packages."""
    jcat = jcore.Catalog(jcore.make_cloud_catalog().instances[::20])
    jp = jcore.problem_from_scenario(jcat, jcore.build_scenarios(jcat)[2])
    return jp, _port(jp)


def _as_rows(points):
    return (np.asarray([p.cost for p in points]),
            np.asarray([p.fragmentation for p in points]),
            np.asarray([p.diversity for p in points]),
            np.asarray([p.objective for p in points]),
            np.asarray([p.on_frontier for p in points]))


def test_pareto_mask_matches_reference():
    rng = np.random.default_rng(0)
    for pts in (np.array([[1.0, 5.0], [2.0, 2.0], [3.0, 3.0], [5.0, 1.0]]),
                rng.integers(0, 5, (30, 2)).astype(np.float64),
                rng.uniform(0, 1, (20, 3))):
        np.testing.assert_array_equal(tpareto.pareto_mask(pts),
                                      jcore.pareto_mask(pts))


@pytest.mark.parametrize("seed", [0, 2])
def test_grid_search_toy_matches_reference(seed):
    jp = make_toy_problem(seed=seed)
    a = jcore.grid_search(jp, alphas=(0.01, 0.1), gammas=(0.001, 0.01))
    b = tcore.grid_search(_port(jp), alphas=(0.01, 0.1),
                          gammas=(0.001, 0.01))
    assert [p.params for p in b] == [p.params for p in a]
    ra, rb = _as_rows(a), _as_rows(b)
    np.testing.assert_allclose(rb[0], ra[0], rtol=INT_RTOL)
    np.testing.assert_array_equal(rb[1], ra[1])
    np.testing.assert_array_equal(rb[2], ra[2])
    np.testing.assert_allclose(rb[3], ra[3], rtol=INT_RTOL)
    np.testing.assert_array_equal(rb[4], ra[4])


def test_grid_search_s3_matches_reference():
    """The solver bench's grid on s3: every point's rounded cost and
    eq. (1) within the integer tolerance of the reference's, equal
    fragmentation and diversity. Near-tied roundings (two allocations
    less than 1% apart) land on either side in the two packages, so the
    frontier is held to the port's own points, and its cheapest cost to
    the reference's."""
    jp, tp = _s3()
    a = jcore.grid_search(jp, alphas=ALPHAS, gammas=GAMMAS)
    b = tcore.grid_search(tp, alphas=ALPHAS, gammas=GAMMAS)
    assert len(b) == len(ALPHAS) * len(GAMMAS)
    ra, rb = _as_rows(a), _as_rows(b)
    np.testing.assert_allclose(rb[0], ra[0], rtol=INT_RTOL)
    np.testing.assert_array_equal(rb[1], ra[1])
    np.testing.assert_array_equal(rb[2], ra[2])
    np.testing.assert_allclose(rb[3], ra[3], rtol=INT_RTOL)
    np.testing.assert_array_equal(rb[4], tpareto.pareto_mask(
        np.stack([rb[0], rb[1].astype(np.float64)], 1)))
    np.testing.assert_allclose(rb[0][rb[4]].min(), ra[0][ra[4]].min(),
                               rtol=INT_RTOL)


def _perturbed(base):
    """The ten settings a central difference of every knob solves, in
    PenaltyParams' field order: each knob scaled by 1 +- SENS_STEP in
    float32, as the reference's ``sensitivity`` builds them."""
    v = [float(a) for a in base]
    out = []
    for i in range(len(v)):
        for scale in (1 + SENS_STEP, 1 - SENS_STEP):
            s = list(v)
            s[i] = float(np.float32(v[i] * scale))
            out.append(s)
    return out


@pytest.mark.parametrize("which", ["toy", "s3"])
def test_sensitivity_matches_reference(which, monkeypatch):
    """What ``sensitivity`` is built from, held to the reference: the ten
    perturbed settings are the reference's, each one's rounded cost lies
    within the integer tolerance of the reference's cost at that setting
    (one jitted solve of all ten there), and every sensitivity is the
    central difference (c+ - c-) / (2 step) of the port's own costs."""
    jp = make_toy_problem(seed=0) if which == "toy" else _s3()[0]
    tp = _port(jp)
    settings = _perturbed(jcore.PenaltyParams.create())
    cfg = jcore.SolverConfig(max_iters=200, barrier_rounds=2)
    grid = jcore.PenaltyParams(*(jnp.asarray(col, jnp.float32)
                                 for col in np.asarray(settings).T))
    want = np.asarray(jpareto._eval_grid(jp, grid, cfg,
                                         jnp.zeros(jp.n, jnp.float32))[0])
    seen = []
    eval_grid = tpareto._eval_grid

    def spy(prob, s, *args):
        out = eval_grid(prob, s, *args)
        seen.append((list(map(list, s)), out[0]))
        return out

    monkeypatch.setattr(tpareto, "_eval_grid", spy)
    got = tcore.sensitivity(tp, tcore.PenaltyParams.create(device="cpu"),
                            rel_step=SENS_STEP)
    assert len(seen) == 1 and seen[0][0] == settings
    cost = seen[0][1]
    np.testing.assert_allclose(cost, want, rtol=INT_RTOL)
    assert list(got) == list(jcore.PenaltyParams._fields)
    for i, k in enumerate(got):
        assert got[k] == float(cost[2 * i] - cost[2 * i + 1]) / (2 * SENS_STEP)


def test_grid_kernel_route_equals_plain(monkeypatch):
    """The grid's eq. (1) through the kernel route (the kernel's plain
    version here) gives the plain route's answer."""
    monkeypatch.setattr(tcore.objective, "_kernel_route",
                        lambda x, use_kernel: use_kernel)
    _, tp = _s3()
    a = _as_rows(tcore.grid_search(tp, alphas=ALPHAS[:2], gammas=GAMMAS[:2],
                                   use_kernel=False))
    b = _as_rows(tcore.grid_search(tp, alphas=ALPHAS[:2], gammas=GAMMAS[:2],
                                   use_kernel=True))
    np.testing.assert_allclose(b[0], a[0], rtol=INT_RTOL)
    np.testing.assert_allclose(b[3], a[3], rtol=INT_RTOL)


def _small():
    """tests/core/test_extensions.py::_small in both packages."""
    demand = np.array([16, 32, 8, 200], np.float64)
    out = []
    for core in (jcore, tcore):
        cat = core.Catalog(core.make_cloud_catalog().instances[::40])
        scen = core.Scenario(name="x", title="x", demand=demand,
                             allowed_idx=None, pools=[],
                             existing=np.zeros(cat.n))
        out.append((cat, scen))
    return out


def _prob(core, cat, scen, **kw):
    if core is tcore:
        kw["device"] = "cpu"
    return core.problem_from_scenario(cat, scen, **kw)


def test_ha_and_zone_spread_match_reference():
    (jcat, jscen), (tcat, tscen) = _small()
    j = int(jcat.select(lambda t: 2 <= t.cpu <= 4)[0])
    assert j == int(tcat.select(lambda t: 2 <= t.cpu <= 4)[0])
    jp = jext.apply_ha(_prob(jcore, jcat, jscen),
                       jext.HAPolicy(min_replicas={j: 3}))
    tp = text.apply_ha(_prob(tcore, tcat, tscen),
                       text.HAPolicy(min_replicas={j: 3}))
    np.testing.assert_array_equal(tp.lb.numpy(), np.asarray(jp.lb))
    jz = jext.zone_replicated_catalog(jcat, 3)
    tz = text.zone_replicated_catalog(tcat, 3)
    assert [i.name for i in tz.instances] == [i.name for i in jz.instances]
    for a, b in zip(tz.matrices(), jz.matrices()):
        np.testing.assert_array_equal(a, b)
    scen = lambda core, z: core.Scenario(name="z", title="z",
                                         demand=jscen.demand,
                                         allowed_idx=None, pools=[],
                                         existing=np.zeros(z.n))
    policy = dict(min_replicas={j: 3}, zones=3)
    jzp = jext.apply_ha(_prob(jcore, jz, scen(jcore, jz)),
                        jext.HAPolicy(**policy), n_base=jcat.n)
    tzp = text.apply_ha(_prob(tcore, tz, scen(tcore, tz)),
                        text.HAPolicy(**policy), n_base=tcat.n)
    np.testing.assert_array_equal(tzp.lb.numpy(), np.asarray(jzp.lb))
    with pytest.raises(ValueError, match="zone-replicated"):
        text.apply_ha(_prob(tcore, tcat, tscen), text.HAPolicy(**policy))


def test_anti_affinity_matches_reference():
    (jcat, jscen), (tcat, tscen) = _small()
    jp, tp = _prob(jcore, jcat, jscen), _prob(tcore, tcat, tscen)
    rng = np.random.default_rng(1)
    for trial in range(3):
        x = rng.integers(0, 3, jcat.n).astype(np.float64)
        used = np.nonzero(x)[0]
        groups = [used[:2].tolist(), used[2:5].tolist()]
        a = jext.enforce_anti_affinity(
            x, jp, jext.HAPolicy(min_replicas={}, anti_affinity=groups))
        b = text.enforce_anti_affinity(
            x, tp, text.HAPolicy(min_replicas={}, anti_affinity=groups))
        np.testing.assert_array_equal(b, np.asarray(a))


def test_pricing_tiers_match_reference():
    (jcat, jscen), (tcat, tscen) = _small()
    tiers = dict(reserved_discount=0.35, spot_interruption_rate=0.07)
    jt, jres, jspot = jext.tiered_catalog(jcat, jext.PricingTiers(**tiers))
    tt, tres, tspot = text.tiered_catalog(tcat, text.PricingTiers(**tiers))
    assert [i.name for i in tt.instances] == [i.name for i in jt.instances]
    for a, b in zip(tt.matrices(), jt.matrices()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tres, jres)
    np.testing.assert_array_equal(tspot, jspot)
    scen = lambda core: core.Scenario(name="t", title="t",
                                      demand=jscen.demand, allowed_idx=None,
                                      pools=[], existing=np.zeros(jt.n))
    cover = np.random.default_rng(2).uniform(0, 6, jt.n)
    jp = jext.cap_reserved(_prob(jcore, jt, scen(jcore)), jres, cover,
                           jext.PricingTiers(**tiers))
    tp = text.cap_reserved(_prob(tcore, tt, scen(tcore)), tres, cover,
                           text.PricingTiers(**tiers))
    np.testing.assert_array_equal(tp.ub.numpy(), np.asarray(jp.ub))
