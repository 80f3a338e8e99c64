"""The port's horizon solver on the CPU: against the reference's from the
same windows and warm start (relaxed window objective rtol 0.1, committed
integer objective rtol 0.05 with equal feasibility,
tests/fleet/test_solve_fleet.py:112-117), and the exact equalities within
the port: H = 1 is ``solve_incremental_info`` / ``solve_fleet_step`` bit
for bit (untraced, traced and under an anytime budget, adaptive and ADMM
configs), and the fleet step is one ``solve_horizon`` per lane on a ragged
fleet."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import repro.core.objective as jobj  # noqa: E402
import repro.horizon as jh  # noqa: E402
from repro.testing import make_toy_problem as jtoy  # noqa: E402

import repro_torch.horizon as th  # noqa: E402
from repro_torch.bridge import horizon_arrays, horizon_from_arrays  # noqa: E402
from repro_torch.core import objective as tobj  # noqa: E402
from repro_torch.core.incremental import solve_incremental_info  # noqa: E402
from repro_torch.core.pgd import AnytimeConfig  # noqa: E402
from repro_torch.fleet import solve_fleet_step, stack_problems  # noqa: E402
from repro_torch.testing import make_toy_problem as ttoy  # noqa: E402

RELAXED_RTOL, INT_RTOL = 0.1, 0.05   # tests/fleet/test_solve_fleet.py:112-117
DELTA = 8.0


def _windows(seed: int, H: int):
    jhp = jh.expand_problems([jtoy(seed=seed + 3 * h,
                                   demand_scale=1.0 + 0.05 * h)
                              for h in range(H)])
    return jhp, horizon_from_arrays(horizon_arrays(jhp), "cpu")


@pytest.mark.parametrize("solver,H,seed", [
    ("adaptive", 4, 0), ("adaptive", 4, 2), ("adaptive", 8, 1),
    ("fixed", 4, 0), ("fixed", 8, 1)])
def test_solve_horizon_matches_reference(solver, H, seed):
    jhp, thp = _windows(seed, H)
    n = thp.n
    rng = np.random.default_rng(seed)
    xc = rng.uniform(0.0, 2.0, size=n).astype(np.float32)
    x_init = np.tile(xc, (H, 1)) + rng.uniform(0.0, 0.5, size=(H, n)).astype(
        np.float32)
    rj = jh.solve_horizon_info(jhp, jnp.asarray(xc), DELTA,
                               x_init=jnp.asarray(x_init),
                               cfg=jh.HorizonSolverConfig(solver=solver))
    rt = th.solve_horizon_info(thp, torch.as_tensor(xc), DELTA,
                               x_init=torch.as_tensor(x_init),
                               cfg=th.HorizonSolverConfig(solver=solver))
    assert rt.plan.shape == (H, n)
    np.testing.assert_allclose(
        float(th.horizon_objective(thp, rt.plan)),
        float(jh.horizon_objective(jhp, rj.plan)), rtol=RELAXED_RTOL)
    if solver == "fixed":
        assert int(rt.iters) == int(rj.iters) == 600
    # the committed tick after plan-respecting rounding
    pj, pt = jh.tick_problem(jhp, 0), th.tick_problem(thp, 0)
    ij = jh.round_committed(pj, rj.plan[0], True)
    it = th.round_committed(pt, rt.plan[0], True)
    np.testing.assert_allclose(float(tobj.objective(pt, it)),
                               float(jobj.objective(pj, ij)), rtol=INT_RTOL)
    assert (bool(tobj.is_feasible(pt, it, 1e-3))
            == bool(jobj.is_feasible(pj, ij, 1e-3)))
    # the committed row keeps the hard churn ball
    assert float((rt.plan[0] - torch.as_tensor(xc)).abs().sum()) <= (
        DELTA * (1 + 1e-5))


@pytest.mark.parametrize("solver", ["adaptive", "admm"])
def test_h1_is_solve_incremental_bit_for_bit(solver):
    """One tick: solve_horizon hands the engine solve_incremental's triple
    (untraced, traced, anytime), and the fleet step is solve_fleet_step."""
    cfg = th.HorizonSolverConfig(solver=solver)
    for seed in (5, 13):
        prob = ttoy(seed=seed, device="cpu")
        hp = th.expand_problems([prob])
        xc = torch.full((prob.n,), 1.0)
        x, iters = solve_incremental_info(prob, xc, 6.0)
        r = th.solve_horizon_info(hp, xc, 6.0, cfg=cfg)
        assert torch.equal(r.plan[0], x) and int(r.iters) == int(iters)
        assert r.diag is None
        _, _, tr = solve_incremental_info(prob, xc, 6.0, capture_trace=True)
        rt = th.solve_horizon_info(hp, xc, 6.0, cfg=cfg, capture_trace=True)
        assert torch.equal(rt.plan[0], x)
        for a, b in zip(rt.trace, tr):
            assert torch.equal(a, b) or (a.is_floating_point() and torch.equal(
                torch.nan_to_num(a, 7.0), torch.nan_to_num(b, 7.0)))
    if solver == "adaptive":
        budget = AnytimeConfig(deadline_ms=12.0, chunk_iters=4,
                               clock=_fake_clock())
        xa, ia, rep = solve_incremental_info(prob, xc, 6.0, anytime=budget)
        ra = th.solve_horizon_info(hp, xc, 6.0, cfg=cfg,
                                   anytime=budget._replace(
                                       clock=_fake_clock()))
        assert torch.equal(ra.plan[0], xa) and int(ra.iters) == int(ia)
        assert ra.deadline_hit == rep.deadline_hit is True
    # the fleet tick: ragged lanes, one frozen
    probs = [ttoy(seed=s, device="cpu") for s in (1, 2, 3)]
    batch = stack_problems(probs)
    X = torch.as_tensor(np.random.default_rng(0).uniform(
        0.0, 2.0, size=(3, 12)).astype(np.float32))
    active = np.array([True, False, True])
    fs = solve_fleet_step(batch, X, 6.0, active=active, device="cpu",
                          capture_trace=True)
    hs = th.solve_horizon_fleet_step(th.stack_windows([[p] for p in probs]),
                                     X, 6.0, active=active, cfg=cfg,
                                     capture_trace=True, device="cpu")
    assert torch.equal(fs.x, hs.plan[:, 0])
    for f in ("x_int", "fun_int", "feasible", "iters"):
        assert torch.equal(getattr(fs, f), getattr(hs, f)), f
    assert torch.equal(torch.nan_to_num(fs.trace.merit, 7.0),
                       torch.nan_to_num(hs.trace.merit, 7.0))


def _fake_clock():
    t = [0.0]

    def clock():
        t[0] += 5e-3
        return t[0]

    return clock


@pytest.mark.parametrize("solver", ["adaptive", "admm", "fixed"])
def test_fleet_step_is_one_solve_per_lane(solver):
    """A fleet of windows with a frozen lane: each live lane's plan and
    commit equal a solve_horizon of that lane alone (bit for bit, batched
    and with hot_loop="vmap"); the frozen lane keeps x_current."""
    cfg = th.HorizonSolverConfig(solver=solver, steps=200, admm_iters=8,
                                 inner_steps=10)
    seeds = [[5, 9, 2, 7], [13, 4, 19, 8], [1, 3, 18, 27]]
    wins = [[ttoy(seed=s, device="cpu") for s in ss] for ss in seeds]
    fleet = th.stack_windows(wins)
    X = torch.stack([torch.full((12,), float(i)) for i in range(3)])
    active = np.array([True, False, True])
    for hot_loop in ("kernel", "vmap"):
        fr = th.solve_horizon_fleet_step(fleet, X, 6.0, active=active,
                                         cfg=cfg, hot_loop=hot_loop,
                                         device="cpu")
        assert (fr.diag is not None) == (solver == "admm")
        for i, w in enumerate(wins):
            if not active[i]:
                assert torch.equal(fr.x_int[i], X[i])
                assert torch.equal(fr.plan[i], X[i].expand(4, 12))
                assert int(fr.iters[i]) == 0
                continue
            hp = th.expand_problems(w)
            sq = th.solve_horizon_info(hp, X[i], 6.0, cfg=cfg)
            assert torch.equal(fr.plan[i], sq.plan), (hot_loop, i)
            assert int(fr.iters[i]) == int(sq.iters)
            xi = th.round_committed(th.tick_problem(hp, 0), sq.plan[0], True)
            assert torch.equal(fr.x_int[i], xi)


def test_engine_contracts():
    """Iterations reported as spent (the fixed engine bills its budget, a
    zero-budget adaptive solve 0), the fixed engine refuses a trace, the
    anytime budget wants the adaptive engine, and plan-respecting rounding
    never commits below floor(x_rel_0)."""
    hp = th.expand_problems([ttoy(seed=2 + 3 * h, device="cpu")
                             for h in range(4)])
    xc = torch.full((hp.n,), 1.0)
    cfg = th.HorizonSolverConfig
    assert int(th.solve_horizon_info(hp, xc, 6.0, cfg=cfg(
        solver="fixed", steps=40)).iters) == 40
    assert 0 < int(th.solve_horizon_info(hp, xc, 6.0,
                                         cfg=cfg(steps=40)).iters) <= 40
    assert int(th.solve_horizon_info(hp, xc, 6.0,
                                     cfg=cfg(steps=0)).iters) == 0
    assert torch.equal(th.solve_horizon(hp, xc, 6.0, cfg=cfg(steps=40)),
                       th.solve_horizon_info(hp, xc, 6.0,
                                             cfg=cfg(steps=40)).plan)
    with pytest.raises(ValueError):
        th.solve_horizon_info(hp, xc, 6.0, cfg=cfg(solver="fixed"),
                              capture_trace=True)
    for solver in ("fixed", "admm"):
        with pytest.raises(ValueError, match="adaptive"):
            th.solve_horizon_info(hp, xc, 6.0, cfg=cfg(solver=solver),
                                  anytime=AnytimeConfig(deadline_ms=5.0))
    r = th.solve_horizon_info(hp, xc, 6.0, cfg=cfg(steps=40),
                              capture_trace=True)
    k = int(r.iters)
    assert r.trace.merit.shape == (40,)
    assert torch.isfinite(r.trace.merit[:k]).all()
    assert torch.isnan(r.trace.merit[k:]).all()
    p0 = th.tick_problem(hp, 0)
    x_rel = r.plan[0] + 0.7
    held = th.round_committed(p0, x_rel, True)
    assert bool((held >= torch.clamp(torch.floor(x_rel), p0.lb, p0.ub)).all())
    with pytest.raises(ValueError):
        th.solve_horizon_fleet_step(th.stack_windows([[p0]]), xc[None], 6.0,
                                    hot_loop="nope", device="cpu")


@pytest.mark.parametrize("hot_loop", ["kernel", "vmap"])
def test_fleet_step_under_anytime(hot_loop):
    """A budget that never expires gives the untruncated fleet step's
    plans and commits bit for bit (the best-so-far iterate is the last);
    a tight one truncates every live lane, one clock for the fleet."""
    wins = [[ttoy(seed=s, device="cpu") for s in ss]
            for ss in ([5, 9, 2], [13, 4, 19], [1, 3, 18])]
    fleet = th.stack_windows(wins)
    X = torch.stack([torch.full((12,), float(i)) for i in range(3)])
    active = np.array([True, False, True])
    kw = dict(active=active, hot_loop=hot_loop, device="cpu",
              cfg=th.HorizonSolverConfig(steps=120))
    full = th.solve_horizon_fleet_step(fleet, X, 6.0, **kw)
    never = AnytimeConfig(deadline_ms=1e12, chunk_iters=16)
    same = th.solve_horizon_fleet_step(fleet, X, 6.0, anytime=never, **kw)
    assert same.deadline_hit is False
    for f in ("plan", "x_int", "iters"):
        assert torch.equal(getattr(full, f), getattr(same, f)), f
    tight = th.solve_horizon_fleet_step(
        fleet, X, 6.0, anytime=AnytimeConfig(deadline_ms=12.0, chunk_iters=4,
                                             clock=_fake_clock()), **kw)
    assert tight.deadline_hit is True
    assert [int(i) for i in tight.iters] == [8, 0, 8]
