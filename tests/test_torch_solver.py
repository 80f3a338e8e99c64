"""The port's solver pieces and its batched fleet solver, held to the JAX
reference on the CPU: phase-1, multistart starts, rounding, the warm
incremental solve, solve_fleet and solve_fleet_step."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the operands are tiny, and the suite runs its files
# in parallel workers, where extra threads only take cores from the others
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.core.objective as jobj  # noqa: E402
import repro.fleet as jfleet  # noqa: E402
from repro.testing import make_toy_problem  # noqa: E402

import repro_torch.core as tcore  # noqa: E402
import repro_torch.core.objective as tobj  # noqa: E402
import repro_torch.fleet as tfleet  # noqa: E402
from repro_torch.bridge import (fleet_batch_from_arrays,  # noqa: E402
                                problem_arrays, problem_from_arrays)

CFG = dict(max_iters=150, barrier_rounds=2)   # test_solve_fleet.py:21
DEMANDS = [np.array([8, 16, 4, 100.0]), np.array([4, 8, 2, 50.0]),
           np.array([6, 24, 3, 150.0])]


def _port(jprob):
    return problem_from_arrays(problem_arrays(jprob), device="cpu")


def _port_batch(jb):
    return fleet_batch_from_arrays(problem_arrays(jb.problem), jb.n_true,
                                   jb.m_true, jb.p_true, active=jb.active,
                                   device="cpu")


@pytest.fixture(scope="module")
def catalogs():
    """The reference's and the port's catalog, trimmed as instances[::40]."""
    return (jcore.Catalog(jcore.make_cloud_catalog().instances[::40]),
            tcore.Catalog(tcore.make_cloud_catalog().instances[::40]))


@pytest.fixture(scope="module")
def fleet(catalogs):
    """Three catalog tenants, stacked by both packages, with the
    reference's starts (its jax.random draws) for both."""
    jcat, tcat = catalogs
    jprobs = [jcore.problem_from_demand(jcat, d) for d in DEMANDS]
    tprobs = [tcore.problem_from_demand(tcat, d, device="cpu")
              for d in DEMANDS]
    jb = jfleet.stack_problems(jprobs)
    starts = np.array(jfleet.make_fleet_starts(jb, 4, seed=0))
    return jprobs, tprobs, jb, starts


def test_problem_from_demand_matches_reference(fleet, catalogs):
    jprobs, tprobs, _, _ = fleet
    for jp, tp in zip(jprobs, tprobs):
        a, b = problem_arrays(jp), problem_arrays(tp)
        for k in ("K", "E", "c", "d", "mu", "g", "lb", "ub", "mask"):
            np.testing.assert_array_equal(a[k], b[k])
        for k in a["params"]:
            np.testing.assert_array_equal(a["params"][k], b["params"][k])
    jcat, tcat = catalogs
    kw = dict(allowed_idx=np.arange(0, 47, 3), existing=np.eye(47)[5] * 2,
              unavailable_idx=np.array([9, 12]))
    a = problem_arrays(jcore.problem_from_demand(jcat, DEMANDS[0], **kw))
    b = problem_arrays(tcore.problem_from_demand(tcat, DEMANDS[0],
                                                 device="cpu", **kw))
    for k in ("K", "mask", "lb", "ub"):
        np.testing.assert_array_equal(a[k], b[k])


def test_phase1_point_matches_reference():
    jp = make_toy_problem(seed=2, m=4, n=25, p=2)
    jp = jp._replace(mu=0.1 * jp.d, g=0.4 * jp.d)
    X = np.random.default_rng(2).uniform(0, 3, (4, 25)).astype(np.float32)
    want = jax.vmap(lambda x: jcore.solver.phase1_point(jp, x))(
        jnp.asarray(X))
    got = tcore.phase1_point(_port(jp), torch.as_tensor(X))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("n_starts", [4, 9])
def test_make_starts_deterministic_rows(fleet, n_starts):
    """Zero and single-type-cover rows equal the reference's; the random
    rows differ by generator (parity tests feed the reference's in)."""
    jprobs, tprobs, _, _ = fleet
    for jp, tp in zip(jprobs, tprobs):
        want = np.asarray(jcore.make_starts(jp, n_starts, seed=0))
        got = tcore.make_starts(tp, n_starts, seed=0).numpy()
        n_det = 1 + min(n_starts // 2, 16)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got[:n_det], want[:n_det])
        assert np.all(got[n_det:] >= 0) and np.all(np.isfinite(got))
        np.testing.assert_array_equal(
            got, tcore.make_starts(tp, n_starts, seed=0).numpy())


def test_rounding_matches_reference(fleet):
    jprobs, tprobs, _, _ = fleet
    rng = np.random.default_rng(3)
    for jp, tp in zip(jprobs, tprobs):
        X = rng.uniform(0, 1.5, (6, jp.n)).astype(np.float32)
        X *= rng.uniform(size=X.shape) < 0.1
        want_g = jax.vmap(lambda x: jcore.greedy_round(jp, x))(jnp.asarray(X))
        want_r = jax.vmap(lambda x: jcore.round_and_polish(jp, x))(
            jnp.asarray(X))
        np.testing.assert_array_equal(
            tcore.greedy_round(tp, torch.as_tensor(X)).numpy(),
            np.asarray(want_g))
        np.testing.assert_array_equal(
            tcore.round_and_polish(tp, torch.as_tensor(X)).numpy(),
            np.asarray(want_r))
        np.testing.assert_array_equal(
            tcore.scale_down(tp, torch.as_tensor(np.ceil(X * 3))).numpy(),
            np.asarray(jax.vmap(lambda x: jcore.scale_down(jp, x))(
                jnp.asarray(np.ceil(X * 3)))))


def test_project_l1_ball_matches_reference():
    rng = np.random.default_rng(4)
    V = rng.normal(size=(5, 40)).astype(np.float32)
    for r in (0.5, 3.0, 100.0):
        want = jax.vmap(lambda v: jcore.project_l1_ball(v, jnp.float32(r)))(
            jnp.asarray(V))
        got = tcore.project_l1_ball(torch.as_tensor(V), torch.tensor(r))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_solve_incremental_info_matches_reference(fleet):
    jprobs, tprobs, _, _ = fleet
    jp, tp = jprobs[1], tprobs[1]
    x_cur = np.zeros(jp.n, np.float32)
    x_cur[[3, 7]] = [2.0, 1.0]
    xj, itj = jcore.solve_incremental_info(jp, jnp.asarray(x_cur), 4.0)
    xt, itt = tcore.solve_incremental_info(tp, torch.as_tensor(x_cur), 4.0)
    fj = float(jobj.objective(jp, xj))
    ft = float(tobj.objective(tp, xt))
    assert abs(ft - fj) <= 1e-3 * abs(fj)
    assert float(torch.abs(xt - torch.as_tensor(x_cur)).sum()) <= 4.0 + 1e-3
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-2,
                               atol=1e-2)
    assert abs(int(itt) - int(itj)) <= 0.1 * int(itj) + 2


def test_solve_fleet_ref_matches_reference(fleet):
    """The hand-batched hot loop, plain eq. (1), against the reference's
    "ref" loop from the same starts: test_solve_fleet.py:112-117 bounds."""
    _, _, jb, starts = fleet
    rj = jfleet.solve_fleet(jb, cfg=jcore.SolverConfig(**CFG),
                            starts=jnp.asarray(starts), hot_loop="ref")
    rt = tfleet.solve_fleet(_port_batch(jb), cfg=tcore.SolverConfig(**CFG),
                            starts=torch.as_tensor(starts), hot_loop="ref",
                            device="cpu")
    np.testing.assert_array_equal(rt.feasible.numpy(), np.asarray(rj.feasible))
    np.testing.assert_allclose(rt.fun.numpy(), np.asarray(rj.fun), rtol=0.1)
    np.testing.assert_allclose(rt.fun_int.numpy(), np.asarray(rj.fun_int),
                               rtol=0.05)
    agg_t, agg_j = float(rt.fun_int.sum()), float(np.sum(rj.fun_int))
    assert abs(agg_t - agg_j) / agg_j < 2e-2
    X = rt.x_int.numpy()
    np.testing.assert_array_equal(X, np.round(X))


def test_solve_fleet_matches_reference_pallas_kernel_loop():
    """The reference's Pallas hot loop (interpret mode), as
    test_solve_fleet.py:120-132 runs it, against the port's kernel loop
    (its plain versions on the CPU)."""
    probs = [make_toy_problem(seed=s, m=3 + s % 2, n=9 + 2 * (s % 4),
                              p=2 + s % 2) for s in range(2)]
    jb = jfleet.stack_problems(probs)
    starts = np.zeros((2, 2, jb.n_max), np.float32)
    for b, p in enumerate(probs):
        starts[b, :, : p.n] = np.asarray(jcore.make_starts(p, 2, seed=0))
    cfg = dict(max_iters=40, barrier_rounds=1)
    rj = jfleet.solve_fleet(jb, cfg=jcore.SolverConfig(**cfg),
                            starts=jnp.asarray(starts), hot_loop="kernel",
                            interpret=True)
    rt = tfleet.solve_fleet(_port_batch(jb), cfg=tcore.SolverConfig(**cfg),
                            starts=torch.as_tensor(starts), device="cpu")
    assert bool(rt.feasible.all())
    np.testing.assert_array_equal(rt.feasible.numpy(), np.asarray(rj.feasible))
    np.testing.assert_allclose(rt.fun_int.numpy(), np.asarray(rj.fun_int),
                               rtol=0.05)


def test_solve_fleet_step_matches_reference(fleet):
    """The warm tick on a ragged-live batch: frozen lanes keep their warm
    start, live lanes match the reference to solver tolerance."""
    jprobs, _, _, _ = fleet
    active = np.array([True, False, True])
    jb = jfleet.stack_problems(jprobs, active=active)
    X_cur = np.zeros((3, jb.n_max), np.float32)
    X_cur[:, 5] = 3.0
    X_cur[:, 20] = 1.0
    rj = jfleet.solve_fleet_step(jb, X_cur, np.array([4.0, 4.0, 8.0]))
    rt = tfleet.solve_fleet_step(_port_batch(jb), X_cur,
                                 np.array([4.0, 4.0, 8.0]), device="cpu")
    np.testing.assert_array_equal(rt.x_int[1].numpy(), X_cur[1])
    assert int(rt.iters[1]) == 0
    np.testing.assert_array_equal(rt.feasible.numpy(), np.asarray(rj.feasible))
    np.testing.assert_allclose(rt.fun_int.numpy(), np.asarray(rj.fun_int),
                               rtol=0.05)


def test_solve_fleet_accepts_lists_and_rejects_unknown_loops(fleet):
    """A list of problems is stacked; hot_loop="vmap" (it raised until it
    was ported) solves each tenant alone, as multistart_solve does."""
    _, tprobs, _, _ = fleet
    small = tcore.SolverConfig(max_iters=20, barrier_rounds=1)
    lanes = tfleet.solve_fleet(tprobs, n_starts=2, cfg=small,
                               hot_loop="vmap", device="cpu")
    ms = tcore.multistart_solve(tprobs[1], n_starts=2, cfg=small)
    assert torch.equal(lanes.x_int[1], ms.x_int)
    assert torch.equal(lanes.fun_int[1], ms.fun_int)
    with pytest.raises(ValueError):
        tfleet.solve_fleet(tprobs, hot_loop="pallas", device="cpu")
    res = tfleet.solve_fleet(tprobs, n_starts=2, device="cpu",
                             cfg=tcore.SolverConfig(max_iters=20,
                                                    barrier_rounds=1))
    assert res.x_int.shape == (3, tprobs[0].n)
    assert bool(torch.isfinite(res.fun_int).all())
