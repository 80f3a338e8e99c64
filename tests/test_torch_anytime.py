"""The port's anytime and traced PGD engines on the CPU: the contract of
``tests/core/test_pgd_anytime.py`` held on ``repro_torch``, and the port
against the JAX reference under the same fake clock."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the operands are tiny, and the suite runs its files
# in parallel workers, where extra threads only take cores from the others
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.core.pgd import AnytimeConfig as JAnytime  # noqa: E402

import repro_torch.core as tcore  # noqa: E402
from repro_torch.bridge import problem_arrays, problem_from_arrays  # noqa: E402
from repro_torch.core import objective as tobj  # noqa: E402
from repro_torch.core.pgd import (AnytimeConfig, PGDConfig,  # noqa: E402
                                  run_anytime)
from repro_torch.testing import make_toy_problem  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)      # tests/kernels/test_kernels.py:32-33
BASE = np.array([8.0, 16.0, 4.0, 100.0])
DELTA = 64.0


def _fake_clock(step_ms: float):
    state = {"t": 0.0}

    def clock():
        state["t"] += step_ms / 1e3
        return state["t"]

    return clock


def _warm_setup(seed=0):
    """A toy warm tick with a deliberately poor warm start."""
    prob = make_toy_problem(seed=seed, device="cpu")
    x_cur = torch.full((prob.n,), 2.0)
    return prob, x_cur, torch.tensor(50.0)


def _solve(prob, x_cur, delta, **kw):
    return tcore.solve_incremental_info(prob, x_cur, delta, **kw)


def _f(prob, x) -> float:
    return float(tobj.objective(prob, x))


def test_disabled_config_is_bit_identical_to_no_config():
    prob, x_cur, delta = _warm_setup()
    x_off, it_off = _solve(prob, x_cur, delta)
    x_none, it_none = _solve(prob, x_cur, delta,
                             anytime=AnytimeConfig(deadline_ms=None))
    assert torch.equal(x_off, x_none) and int(it_off) == int(it_none)


@pytest.mark.parametrize("chunk", [1, 16, 37])
def test_generous_deadline_matches_monolithic_solve_bit_exactly(chunk):
    prob, x_cur, delta = _warm_setup()
    x_off, it_off = _solve(prob, x_cur, delta)
    x_any, it_any, report = _solve(
        prob, x_cur, delta,
        anytime=AnytimeConfig(deadline_ms=1e9, chunk_iters=chunk))
    assert not report.deadline_hit
    assert report.chunks == -(-int(it_off) // chunk)
    assert int(it_any) == int(it_off)
    assert torch.equal(x_any, x_off)


def test_traced_solve_equals_untraced_bit_for_bit():
    prob, x_cur, delta = _warm_setup()
    x_off, it_off = _solve(prob, x_cur, delta)
    x_tr, it_tr, trace = _solve(prob, x_cur, delta, capture_trace=True)
    assert torch.equal(x_tr, x_off) and int(it_tr) == int(it_off)
    k = int(it_tr)
    assert trace.merit.shape == (600,)
    assert float(trace.merit[k - 1]) == pytest.approx(_f(prob, x_tr),
                                                      rel=1e-6)
    # the validity sentinel past iters
    assert torch.isnan(trace.merit[k:]).all() and torch.isnan(
        trace.move[k:]).all()
    assert not trace.accepted[k:].any() and (trace.rung[k:] == -1).all()
    assert ((trace.rung[:k] >= 0) == trace.accepted[:k]).all()


def test_truncated_best_so_far_is_merit_argmin_prefix():
    prob, x_cur, delta = _warm_setup()
    _, _, trace = _solve(prob, x_cur, delta, capture_trace=True)
    merit = trace.merit.double().numpy()
    f0 = _f(prob, x_cur)
    # (the port stops this solve at 144 iterations: budgets stay below it)
    for budget_ms, chunk in [(2.0, 4), (6.0, 8), (8.0, 16)]:
        x_best, iters, report = _solve(
            prob, x_cur, delta,
            anytime=AnytimeConfig(deadline_ms=budget_ms, chunk_iters=chunk,
                                  clock=_fake_clock(1.0)))
        k = int(iters)
        assert report.deadline_hit and 0 < k < 600
        np.testing.assert_allclose(_f(prob, x_best),
                                   min([f0] + list(merit[:k])), rtol=1e-6)


def test_zero_budget_returns_feasible_projected_warm_start():
    prob, x_cur, delta = _warm_setup()
    x_best, iters, report = _solve(
        prob, x_cur, delta,
        anytime=AnytimeConfig(deadline_ms=0.5, chunk_iters=4,
                              clock=_fake_clock(10.0)))
    assert report.deadline_hit and int(iters) <= 4
    assert _f(prob, x_best) <= _f(prob, x_cur) + 1e-6
    x_int = tcore.round_and_polish(prob, x_best)
    assert bool(tcore.is_feasible(prob, x_int, 1e-3))


def test_spent_budget_returns_the_projected_warm_start_itself():
    """A budget spent before the first chunk runs no chunk at all: the
    answer is the projected warm start."""
    prob, x_cur, delta = _warm_setup()
    x_best, iters, report = _solve(
        prob, x_cur, delta,
        anytime=AnytimeConfig(deadline_ms=0.0, clock=_fake_clock(1.0)))
    assert report.deadline_hit and report.chunks == 0 and int(iters) == 0
    want = tcore.project_incremental(prob, x_cur, x_cur, delta)
    assert torch.equal(x_best, want)


def test_tighter_budgets_never_return_better_merit():
    prob, x_cur, delta = _warm_setup()
    merits = []
    for budget_ms in (1.0, 4.0, 16.0, 64.0):
        x_best, _, _ = _solve(
            prob, x_cur, delta,
            anytime=AnytimeConfig(deadline_ms=budget_ms, chunk_iters=8,
                                  clock=_fake_clock(0.5)))
        merits.append(_f(prob, x_best))
    assert all(b <= a + 1e-6 for a, b in zip(merits, merits[1:]))


def test_anytime_and_capture_trace_are_mutually_exclusive():
    prob, x_cur, delta = _warm_setup()
    with pytest.raises(ValueError, match="mutually exclusive"):
        _solve(prob, x_cur, delta, capture_trace=True,
               anytime=AnytimeConfig(deadline_ms=5.0))


def test_run_anytime_requires_a_deadline():
    with pytest.raises(ValueError):
        run_anytime(lambda: None, lambda s, e: s, PGDConfig(),
                    AnytimeConfig(deadline_ms=None))


def test_stacked_lanes_follow_their_single_trajectories():
    """The chunked engine over a stack of lanes: each lane is bit for bit
    the lane solved alone (lanes are independent in the lane loop)."""
    probs = [make_toy_problem(seed=s, device="cpu") for s in range(3)]
    from repro_torch.fleet import stack_problems
    batch = stack_problems(probs, device="cpu")
    X = torch.full((3, probs[0].n), 2.0)
    cfg = AnytimeConfig(deadline_ms=1e9, chunk_iters=8)
    xs, its, _ = _solve(batch.problem, X, torch.tensor(50.0), anytime=cfg)
    for b, pb in enumerate(probs):
        x1, it1, _ = _solve(pb, X[b], torch.tensor(50.0), anytime=cfg)
        assert torch.equal(xs[b], x1) and int(its[b]) == int(it1)


# ---------------------------------------------------------------------------
# against the reference, same inputs, same fake clock
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def warm_pair():
    """The serve bench's degradation instance on the reduced catalog: a
    demand jump x3 from the multistart answer at the base demand (the
    reference's), the same problem in both packages."""
    jcat = jcore.Catalog(jcore.make_cloud_catalog().instances[::40])
    x_cur = np.array(jcore.multistart_solve(
        jcore.problem_from_demand(jcat, BASE), n_starts=4).x_int, np.float32)
    jp = jcore.problem_from_demand(jcat, BASE * 3.0)
    tp = problem_from_arrays(problem_arrays(jp), device="cpu")
    return jp, tp, x_cur


@pytest.mark.parametrize("budget_ms", [0.5, 1.0, 2.0, 1e9])
def test_anytime_matches_reference_under_the_same_clock(warm_pair, budget_ms):
    jp, tp, x_cur = warm_pair
    xj, itj, rj = jcore.solve_incremental_info(
        jp, jnp.asarray(x_cur), jnp.float32(DELTA),
        anytime=JAnytime(deadline_ms=budget_ms, chunk_iters=8,
                         clock=_fake_clock(0.25)))
    xt, itt, rt = tcore.solve_incremental_info(
        tp, torch.as_tensor(x_cur), DELTA,
        anytime=AnytimeConfig(deadline_ms=budget_ms, chunk_iters=8,
                              clock=_fake_clock(0.25)))
    ft = _f(tp, xt)
    if budget_ms < 1e9:
        # truncated inside the prefix where the two trajectories agree
        assert (rt.chunks, rt.deadline_hit, int(itt)) == (
            rj.chunks, rj.deadline_hit, int(itj))
        assert rt.elapsed_ms == pytest.approx(rj.elapsed_ms)
        np.testing.assert_allclose(ft, float(jcore.objective_value(jp, xj)),
                                   **TOL)
    else:
        # untruncated: both converge (at their own iteration counts; BB
        # steps are chaotic in the last ulps) to the same merit
        assert not rt.deadline_hit and not rj.deadline_hit
        np.testing.assert_allclose(ft, float(jcore.objective_value(jp, xj)),
                                   rtol=1e-3)
    assert bool(tcore.is_feasible(tp, tcore.round_and_polish(tp, xt), 1e-3))


def test_traced_rows_match_reference(warm_pair):
    jp, tp, x_cur = warm_pair
    _, itj, trj = jcore.solve_incremental_info(
        jp, jnp.asarray(x_cur), jnp.float32(DELTA), capture_trace=True)
    _, itt, trt = tcore.solve_incremental_info(
        tp, torch.as_tensor(x_cur), DELTA, capture_trace=True)
    # the 56-iteration prefix the budget-2 ms run above deploys from
    k = 48
    assert min(int(itj), int(itt)) > k
    np.testing.assert_allclose(trt.merit[:k].numpy(),
                               np.asarray(trj.merit)[:k], **TOL)
    np.testing.assert_array_equal(trt.accepted[:k].numpy(),
                                  np.asarray(trj.accepted)[:k])
    np.testing.assert_array_equal(trt.rung[:k].numpy(),
                                  np.asarray(trj.rung)[:k])
    # the sentinel rows past each package's own iteration count
    for tr, it in ((trt.merit.numpy(), int(itt)),
                   (np.asarray(trj.merit), int(itj))):
        assert np.isnan(tr[it:]).all() and np.isfinite(tr[:it]).all()
