"""Branch-and-bound in the port against the JAX reference on the CPU: the
cost cuts, the search on the toy problem from the reference's relaxed
start, and ``optimize(use_bnb=True)`` over the five scenarios of a reduced
catalog, the port fed the reference's multistart starts."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the operands are tiny, and the suite runs its files
# in parallel workers, where extra threads only take cores from the others
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.core.branch_bound as jbb  # noqa: E402
import repro.core.multistart as jms  # noqa: E402
import repro.core.objective as jobj  # noqa: E402
from repro.testing import make_toy_problem as j_toy  # noqa: E402

import repro_torch.core as tcore  # noqa: E402
import repro_torch.core.branch_bound as tbb  # noqa: E402
import repro_torch.core.multistart as tms  # noqa: E402
import repro_torch.core.objective as tobj  # noqa: E402
from repro_torch.testing import make_toy_problem as t_toy  # noqa: E402

INT_RTOL = 0.05                       # tests/fleet/test_solve_fleet.py:112-117
TOY_CFG = dict(max_iters=200, barrier_rounds=2)   # tests/core/test_bnb_controller.py:16
SCENARIOS = ["s1_greenfield", "s2_scaling", "s3_enterprise", "s4_memory",
             "s5_constrained"]
BNB_NODES = 3     # three nodes already move s3 and s4 past their multistart


def _feasible(pkg_obj, prob, x, as_array):
    return bool(pkg_obj.is_feasible(prob, as_array(x), 1e-3))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_cost_cuts_equal_reference(seed):
    jp = j_toy(seed=seed, n=40)
    tp = t_toy(seed=seed, n=40, device="cpu")
    rng = np.random.default_rng(seed)
    ub = rng.uniform(0.0, 100.0, 40)
    for val in (np.inf, -1.0, 0.0, 0.37, 5.0, 1e3):
        np.testing.assert_array_equal(tbb._cost_cuts(tp.c.numpy(), ub, val),
                                      jbb._cost_cuts(jp, ub, val))


@pytest.fixture(scope="module")
def toy_runs():
    """Both packages' branch-and-bound on toy problems from the
    reference's relaxed solution, and the port's plain rounding of it."""
    out = {}
    for seed in (0, 1, 2, 3):
        jp = j_toy(seed=seed)
        tp = t_toy(seed=seed, device="cpu")
        x_rel = np.array(jcore.solve_relaxation(
            jp, jnp.zeros(jp.n), jcore.SolverConfig(**TOY_CFG)).x)
        rj = jcore.branch_and_bound(jp, x_rel, max_nodes=16,
                                    cfg=jcore.SolverConfig(**TOY_CFG))
        rt = tcore.branch_and_bound(tp, x_rel, max_nodes=16,
                                    cfg=tcore.SolverConfig(**TOY_CFG))
        f_round = float(tobj.objective(tp, tcore.round_and_polish(
            tp, torch.as_tensor(x_rel))))
        out[seed] = (jp, tp, rj, rt, f_round)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_bnb_matches_reference_on_toy_problems(toy_runs, seed):
    jp, tp, rj, rt, f_round = toy_runs[seed]
    np.testing.assert_allclose(rt.fun, rj.fun, rtol=INT_RTOL)
    np.testing.assert_array_equal(rt.x, np.round(rt.x))
    assert (_feasible(tobj, tp, rt.x, torch.as_tensor)
            == _feasible(jobj, jp, rj.x, jnp.asarray))
    assert _feasible(tobj, tp, rt.x, torch.as_tensor)
    # never worse than the rounding it starts from (test_bnb_controller.py:23)
    assert rt.fun <= f_round + 1e-5
    assert rt.fun == pytest.approx(float(tobj.objective(
        tp, torch.as_tensor(rt.x, dtype=torch.float32))))
    assert 1 <= rt.nodes_explored <= 16 and rt.gap >= 0.0


def test_bnb_improves_the_toy_incumbent(toy_runs):
    """Seed 0 is the toy problem on which the search finds a better
    allocation than the rounding; the reference's does too."""
    _, _, rj, rt, f_round = toy_runs[0]
    assert rj.incumbent_updates >= 1
    assert rt.incumbent_updates >= 1
    assert rt.fun < f_round - 1e-3


def test_bnb_from_zero_start_reports(toy_runs):
    """No relaxed start given: the root solves from zeros, as in
    tests/core/test_bnb_controller.py:30."""
    tp = toy_runs[0][1]
    res = tcore.branch_and_bound(tp, max_nodes=8,
                                 cfg=tcore.SolverConfig(**TOY_CFG))
    assert 1 <= res.nodes_explored <= 8
    assert res.gap >= 0.0
    np.testing.assert_array_equal(res.x, np.round(res.x))


def test_node_bounds_reach_the_solver():
    """A node's box comes from its own lb / ub: with every variable pinned
    to 2 the node solve returns exactly 2 everywhere."""
    tp = t_toy(seed=1, device="cpu")
    pin = np.full(tp.n, 2.0)
    x, f = tbb._solve_node(tp, pin, pin, np.zeros(tp.n),
                           tcore.SolverConfig(**TOY_CFG))
    np.testing.assert_array_equal(x, pin)
    assert f == pytest.approx(float(tobj.objective(
        tp, torch.as_tensor(pin, dtype=torch.float32))))
    assert torch.equal(tp.lb, torch.zeros(tp.n))


@pytest.fixture(scope="module")
def optimized():
    """optimize(use_bnb=True) of both packages on every scenario of the
    reduced catalog, the port fed the reference's starts; the port's run
    without branch-and-bound from the same starts beside it."""
    jcat = jcore.Catalog(jcore.make_cloud_catalog().instances[::20])
    tcat = tcore.Catalog(tcore.make_cloud_catalog().instances[::20])
    starts = []
    make = jms.make_starts

    def capture(prob, n_starts, seed=0):
        out = make(prob, n_starts, seed)
        starts.append(np.array(out))
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(jms, "make_starts", capture)
    mp.setattr(tms, "make_starts",
               lambda prob, n_starts, seed=0: torch.as_tensor(starts[-1]))
    out = {}
    for js, ts in zip(jcore.build_scenarios(jcat),
                      tcore.build_scenarios(tcat)):
        out[js.name] = (
            jcore.optimize(jcat, js, n_starts=6, use_bnb=True,
                           bnb_nodes=BNB_NODES),
            tcore.optimize(tcat, ts, n_starts=6, use_bnb=True,
                           bnb_nodes=BNB_NODES, device="cpu"),
            tcore.optimize(tcat, ts, n_starts=6, device="cpu"))
    mp.undo()
    return out


@pytest.mark.parametrize("name", SCENARIOS)
def test_optimize_with_bnb_matches_reference(optimized, name):
    rj, rt, ms = optimized[name]
    assert rt.used_bnb is True and rj.used_bnb is True
    np.testing.assert_allclose(rt.fun, rj.fun, rtol=INT_RTOL)
    assert rt.metrics.satisfied == rj.metrics.satisfied
    np.testing.assert_array_equal(rt.counts, np.round(rt.counts))
    # the multistart incumbent is kept unless the search beats it
    assert rt.fun <= ms.fun + 1e-7 * abs(ms.fun)
    np.testing.assert_array_equal(rt.relaxed, ms.relaxed)


def test_bnb_moves_s3_and_s4(optimized):
    """The scenarios on which the search changes the answer in the
    reference change in the port too."""
    for name in ("s3_enterprise", "s4_memory"):
        rj, rt, ms = optimized[name]
        assert rt.fun < ms.fun
        assert rj.fun < ms.fun
