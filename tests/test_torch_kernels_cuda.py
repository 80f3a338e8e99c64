"""The ``alloc_objective`` CUDA kernel against its plain PyTorch version, on
the card. These tests import no JAX, so they also run where only the port
is installed; without a CUDA device they skip. On a machine with a card:

    python -m pytest -q --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import objective as obj  # noqa: E402
from repro_torch.core.problem import AllocationProblem, PenaltyParams  # noqa: E402
from repro_torch.fleet.batching import stack_problems  # noqa: E402
from repro_torch.kernels.alloc_objective import ops, ref  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = dict(rtol=1e-4, atol=1e-4)   # tests/kernels/test_kernels.py:32-33


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _problem(seed, m, n, p, device):
    rng = np.random.default_rng(seed)
    K = rng.uniform(0.2, 2.0, size=(m, n)).astype(np.float32)
    c = (K.sum(axis=0) * rng.uniform(0.05, 0.2, size=n)).astype(np.float32)
    E = np.zeros((p, n), np.float32)
    E[rng.integers(0, p, size=n), np.arange(n)] = 1.0
    d = rng.uniform(1.0, 4.0, size=m).astype(np.float32)
    params = PenaltyParams.create(alpha=0.02, beta1=1.0, beta2=0.1,
                                  beta3=10.0, gamma=0.005, device=device)
    return AllocationProblem.create(K, E, c, d, params=params,
                                    ub_default=100.0, device=device)


def _close(got, want):
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)


def _batch(B, m, n, p, device):
    return stack_problems([_problem(s, m, n, p, device) for s in range(B)])


def _points(B, T, n, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    return 5.0 * torch.rand((B, T, n), generator=gen, device=device)


# (B, T, m, n, p): the replay's four shapes at the bucketed n = 2048; the
# ragged catalog n = 1880, also at B = 1 with T = 1 and 12 (the sequential
# controller's warm tick); n % 4 != 0 (the kernel's 4-byte path); n < 32;
# stages that must be tiled at m = p = 8 (17 n floats over 227 KB), on the
# 16-byte path (n = 4096) and the 4-byte path (n = 3501); m, p over
# {2, 3, 4, 8}, 3 through the runtime-bounded instantiation
@pytest.mark.parametrize("B,T,m,n,p", [
    (64, 48, 4, 2048, 2), (64, 12, 4, 2048, 2), (64, 4, 4, 2048, 2),
    (64, 1, 4, 2048, 2), (2, 1, 4, 1880, 2), (1, 1, 4, 1880, 2),
    (1, 12, 4, 1880, 2), (3, 5, 3, 37, 3),
    (1, 300, 8, 513, 8), (5, 9, 4, 513, 2), (4, 6, 2, 7, 2),
    (3, 3, 4, 16, 4), (3, 5, 8, 4096, 8), (2, 3, 8, 3501, 8),
    (6, 7, 2, 300, 8), (6, 7, 8, 300, 2), (6, 7, 3, 300, 4),
    (6, 7, 4, 300, 3), (6, 7, 2, 300, 2), (6, 7, 8, 300, 8)])
def test_fleet_kernel_matches_plain(cuda, B, T, m, n, p):
    P = _batch(B, m, n, p, cuda).problem
    X = _points(B, T, n, cuda, B * T)
    args = (P.K, P.E, P.c, P.d, *P.params)
    f, g = ops.fleet_value_and_grad(P, X)
    fr, gr = ref.alloc_objective_fleet_ref(X, *args)
    _close(f, fr)
    _close(g, gr)
    _close(ops.fleet_value(P, X), ref.alloc_objective_fleet_value(X, *args))


# S = 72 and 6: the scenario pipeline's shapes (6 starts x the 12-rung
# Armijo ladder, and the 6 iterates' gradient) over the full catalog; 12
# and 1: a branch-and-bound node's ladder and gradient; 48 and 4: the
# sequential controller's cold tick (4 starts)
@pytest.mark.parametrize("S,m,n,p", [(13, 4, 37, 2), (128, 4, 1880, 2),
                                     (1, 2, 16, 2), (72, 4, 1880, 2),
                                     (6, 4, 1880, 2), (12, 4, 1880, 2),
                                     (1, 4, 1880, 2), (48, 4, 1880, 2),
                                     (4, 4, 1880, 2)])
def test_single_kernel_matches_plain(cuda, S, m, n, p):
    prob = _problem(S, m, n, p, cuda)
    gen = torch.Generator(device=cuda).manual_seed(S)
    X = 5.0 * torch.rand((S, n), generator=gen, device=cuda)
    f, g = ops.batched_value_and_grad(prob, X)
    fr, gr = ref.alloc_objective_ref(X, prob.K, prob.E, prob.c, prob.d,
                                     *prob.params)
    _close(f, fr)
    _close(g, gr)


def test_batched_equals_per_lane_bitwise(cuda):
    """No atomics: a lane's result does not depend on its batch."""
    batch = stack_problems([_problem(s, 4, 300, 2, cuda) for s in range(5)])
    X = torch.rand((5, 7, 300), device=cuda)
    f, g = ops.fleet_value_and_grad(batch.problem, X)
    one = stack_problems([_problem(2, 4, 300, 2, cuda)])
    f1, g1 = ops.fleet_value_and_grad(one.problem, X[2:3].contiguous())
    assert torch.equal(f[2:3], f1) and torch.equal(g[2:3], g1)


@pytest.mark.parametrize("m,n,p", [(4, 2048, 2), (3, 513, 3), (8, 4096, 8)])
def test_rows_do_not_depend_on_batch_or_plan_bitwise(cuda, m, n, p):
    """A lane's f and g are the same bits whether its rows run in a
    (64, 48) call (16 rows a block, two a warp), alone at B = 1, seven at
    a time (T = 7) or one at a time (T = 1)."""
    P = _batch(64, m, n, p, cuda).problem
    X = _points(64, 48, n, cuda, 7)
    assert len({ops.launch_plan(B, T, n, m, p).rows_per_block
                for B, T in ((64, 48), (64, 7), (1, 1))}) == 3
    f, g = ops.fleet_value_and_grad(P, X)
    one = stack_problems([_problem(5, m, n, p, cuda)]).problem
    f1, g1 = ops.fleet_value_and_grad(one, X[5:6].contiguous())
    assert torch.equal(f[5:6], f1) and torch.equal(g[5:6], g1)
    for t in (0, 17, 47):
        ft, gt = ops.fleet_value_and_grad(one, X[5:6, t:t + 1].contiguous())
        assert torch.equal(f[5, t], ft[0, 0]) and torch.equal(g[5, t], gt[0, 0])
    f7 = ops.fleet_value(P, X[:, :7].contiguous())
    assert torch.equal(f[:, :7], f7)


@pytest.mark.parametrize("B,T,m,n,p", [
    (64, 48, 4, 2048, 2), (64, 1, 4, 2048, 2), (3, 5, 3, 37, 3),
    (2, 3, 8, 3501, 8)])
def test_value_only_equals_value_and_grad_bitwise(cuda, B, T, m, n, p):
    P = _batch(B, m, n, p, cuda).problem
    X = _points(B, T, n, cuda, T)
    assert torch.equal(ops.fleet_value(P, X),
                       ops.fleet_value_and_grad(P, X)[0])


def test_core_objective_routes_cuda_tensors_to_the_kernel(cuda):
    batch = stack_problems([_problem(s, 4, 64, 2, cuda) for s in range(3)])
    X = torch.rand((3, 2, 64), device=cuda)
    ops.reset_launches()
    f = obj.objective(batch.problem, X)
    g = obj.grad_objective(batch.problem, X)
    assert ops.LAUNCHES["alloc_objective_fleet_value"] == 1
    assert ops.LAUNCHES["alloc_objective_fleet"] == 1
    _close(f, obj.objective(batch.problem, X, use_kernel=False))
    _close(g, obj.grad_objective(batch.problem, X, use_kernel=False))


def test_wrapper_rejects_bad_operands(cuda):
    batch = stack_problems([_problem(0, 4, 64, 2, cuda)])
    X = torch.rand((1, 2, 64), device=cuda)
    with pytest.raises(TypeError):
        ops.fleet_value(batch.problem, X.double())
    with pytest.raises(ValueError):
        ops.fleet_value(batch.problem, X.transpose(1, 2).contiguous()
                        .transpose(1, 2))
    wide = stack_problems([_problem(0, 9, 64, 2, cuda)])
    with pytest.raises(ValueError):
        ops.fleet_value(wide.problem, X)


def test_optimize_runs_the_single_problem_kernel(cuda):
    """The scenario pipeline on the card evaluates eq. (1) with the
    single-problem form only; use_kernel=False launches nothing, and both
    commit allocations of the same objective."""
    from repro_torch.core import (Catalog, SolverConfig, build_scenarios,
                                  make_cloud_catalog, optimize)
    cat = Catalog(make_cloud_catalog().instances[::20])
    cfg = SolverConfig(max_iters=100, barrier_rounds=2)
    for scenario in build_scenarios(cat)[:2]:
        ops.reset_launches()
        kern = optimize(cat, scenario, n_starts=6, cfg=cfg, device=cuda)
        launches = dict(ops.LAUNCHES)
        ops.reset_launches()
        plain = optimize(cat, scenario, n_starts=6, cfg=cfg,
                         use_kernel=False, device=cuda)
        assert launches["alloc_objective"] > 0
        assert launches["alloc_objective_fleet"] == 0
        assert launches["alloc_objective_fleet_value"] == 0
        assert not any(ops.LAUNCHES.values())
        assert kern.metrics.satisfied and plain.metrics.satisfied
        np.testing.assert_array_equal(kern.counts, np.round(kern.counts))
        assert (np.array_equal(kern.counts, plain.counts)
                or abs(kern.fun - plain.fun) <= 1e-4 * abs(plain.fun))


def test_branch_and_bound_kernel_against_plain(cuda):
    """The search on the toy problem with the kernel and plain: only the
    single-problem form runs, and the two find allocations of the same
    objective (tests/fleet/test_solve_fleet.py:112-117) and feasibility."""
    from repro_torch.core import SolverConfig, branch_and_bound
    from repro_torch.testing import make_toy_problem
    prob = make_toy_problem(seed=0, device=cuda)
    cfg = SolverConfig(max_iters=200, barrier_rounds=2)
    ops.reset_launches()
    kern = branch_and_bound(prob, max_nodes=16, cfg=cfg)
    launches = dict(ops.LAUNCHES)
    ops.reset_launches()
    plain = branch_and_bound(prob, max_nodes=16, cfg=cfg, use_kernel=False)
    assert launches["alloc_objective"] > 0
    assert launches["alloc_objective_fleet"] == 0
    assert launches["alloc_objective_fleet_value"] == 0
    assert not any(ops.LAUNCHES.values())
    np.testing.assert_allclose(kern.fun, plain.fun, rtol=0.05)
    for res in (kern, plain):
        x = torch.as_tensor(res.x, dtype=torch.float32, device=cuda)
        assert bool(obj.is_feasible(prob, x, 1e-3))
        np.testing.assert_array_equal(res.x, np.round(res.x))
    assert kern.incumbent_updates >= 1


def test_sequential_replay_equals_vmap_on_the_card(cuda):
    """Two tenants, three ticks: the sequential engine and the batched one
    with hot_loop="vmap" commit the same counts bit for bit (the kernel
    has no atomics), and both launch the kernel."""
    from repro_torch.core import Catalog, make_cloud_catalog
    from repro_torch.fleet import TenantSpec, make_trace, replay_fleet
    cat = Catalog(make_cloud_catalog().instances[::40])
    specs = [TenantSpec(name=k, trace=make_trace(k, np.array(
        [8, 16, 4, 100.0]), 3, seed=i), n_starts=2)
        for i, k in enumerate(("diurnal", "ramp"))]
    runs = []
    for mode, hot_loop in (("sequential", "kernel"), ("batched", "vmap")):
        ops.reset_launches()
        runs.append(replay_fleet(cat, specs, replay_mode=mode,
                                 hot_loop=hot_loop, run_ca_baseline=False,
                                 device=cuda))
        assert ops.LAUNCHES["alloc_objective"] > 0
        assert ops.LAUNCHES["alloc_objective_fleet"] > 0
    seq, lanes = runs
    for a, b in zip(seq.tenants, lanes.tenants):
        assert len(a.steps) == len(b.steps) == 3
        for sa, sb in zip(a.steps, b.steps):
            np.testing.assert_array_equal(sa.counts, sb.counts)
        assert a.metrics == b.metrics


def _warm_fleet(device, B=4, stride=40, scale=3.0):
    """B warm lanes on a catalog: the problems at ``scale`` x the base
    demand, warm-started from a rounded cold answer at the base demand."""
    from repro_torch.core import (Catalog, make_cloud_catalog,
                                  multistart_solve, problem_from_demand)
    cat = Catalog(make_cloud_catalog().instances[::stride])
    base = np.array([8.0, 16.0, 4.0, 100.0])
    probs, X = [], []
    for b in range(B):
        d = base * (0.6 + 0.3 * b)
        X.append(multistart_solve(problem_from_demand(cat, d, device=device),
                                  n_starts=2).x_int.cpu().numpy())
        probs.append(problem_from_demand(cat, d * scale, device=device))
    return stack_problems(probs, device=device), np.stack(X)


def test_anytime_chunks_on_the_kernel_equal_the_monolithic_step(cuda):
    """The chunked anytime engine on the card, through the fleet kernel:
    a budget that never expires gives the untruncated step bit for bit
    (x, x_int, iters), and the chunk loop launches the kernel (the count
    differs from the monolithic loop's by its frozen trailing
    iterations)."""
    from repro_torch.core.pgd import AnytimeConfig
    from repro_torch.fleet import solve_fleet_step
    batch, X = _warm_fleet(cuda)
    ops.reset_launches()
    off = solve_fleet_step(batch, X, 64.0, device=cuda)
    launches_off = dict(ops.LAUNCHES)
    for chunk in (8, 32):
        ops.reset_launches()
        on = solve_fleet_step(batch, X, 64.0, device=cuda,
                              anytime=AnytimeConfig(deadline_ms=1e9,
                                                    chunk_iters=chunk))
        assert on.deadline_hit is False
        for f in ("x", "x_int", "iters", "fun_int", "feasible"):
            assert torch.equal(getattr(on, f), getattr(off, f)), f
        assert ops.LAUNCHES["alloc_objective_fleet"] > 0
        assert ops.LAUNCHES["alloc_objective_fleet_value"] > 0
    assert launches_off["alloc_objective_fleet"] > 0
    assert launches_off["alloc_objective_fleet_value"] > 0
    # a spent budget: the projected warm start, feasible after rounding
    ops.reset_launches()
    cut = solve_fleet_step(batch, X, 64.0, device=cuda,
                           anytime=AnytimeConfig(deadline_ms=0.0))
    assert cut.deadline_hit and int(cut.iters.max()) == 0
    assert bool(cut.feasible.all())
    assert ops.LAUNCHES["alloc_objective_fleet"] > 0


def test_traced_step_equals_untraced_on_the_card(cuda):
    from repro_torch.fleet import solve_fleet_step
    batch, X = _warm_fleet(cuda)
    off = solve_fleet_step(batch, X, 64.0, device=cuda)
    ops.reset_launches()
    on = solve_fleet_step(batch, X, 64.0, device=cuda, capture_trace=True)
    assert ops.LAUNCHES["alloc_objective_fleet"] > 0
    for f in ("x", "x_int", "iters", "fun_int"):
        assert torch.equal(getattr(on, f), getattr(off, f)), f
    merit = on.trace.merit
    assert merit.shape == (batch.B, 600) and merit.is_cuda
    written = torch.isfinite(merit).sum(1)
    assert torch.equal(written, on.iters)
    last = merit.gather(1, (on.iters - 1)[:, None])[:, 0]
    f_rel = obj.objective(batch.problem, on.x)
    torch.testing.assert_close(last, f_rel, rtol=1e-6, atol=0)


def test_serve_session_kernel_against_plain(cuda):
    """A 2-lane ServeEngine session on the card with the kernel and with
    hot_loop="ref": the same feasibility and objectives within the
    replay's tolerance per decision; the plain session launches nothing."""
    from repro_torch.core import Catalog, make_cloud_catalog
    from repro_torch.serve import ServeEngine
    cat = Catalog(make_cloud_catalog().instances[::40])
    base = np.array([8.0, 16.0, 4.0, 100.0])
    sessions = {}
    for hot_loop in ("kernel", "ref"):
        ops.reset_launches()
        eng = ServeEngine(cat, 2, hot_loop=hot_loop, device=cuda)
        eng.register("a", demand=base)
        eng.register("b", demand=base * 0.6)
        eng.tick()
        for t in range(3):
            eng.submit("a", base * (1.1 + 0.2 * t))
            if t != 1:
                eng.submit("b", base * (0.7 + 0.1 * t))
            eng.tick()
        sessions[hot_loop] = (eng.records, dict(ops.LAUNCHES))
    (kern, k_l), (plain, p_l) = sessions["kernel"], sessions["ref"]
    assert k_l["alloc_objective"] > 0 and k_l["alloc_objective_fleet"] > 0
    assert not any(p_l.values())
    assert len(kern) == len(plain) == 7
    for rk, rp in zip(kern, plain):
        assert (rk.tenant, rk.cold, rk.staleness, rk.feasible) == (
            rp.tenant, rp.cold, rp.staleness, rp.feasible)
        np.testing.assert_allclose(rk.objective, rp.objective, rtol=0.05)


def test_kkt_report_on_the_card_against_the_cpu(cuda):
    """The certificate on the card (its gradient one launch of the
    single-problem kernel) against the same certificate on the CPU."""
    from repro_torch.core import (Catalog, make_cloud_catalog,
                                  multistart_solve, problem_from_demand)
    from repro_torch.core.kkt import kkt_report
    from repro_torch.core.problem import problem_to
    cat = Catalog(make_cloud_catalog().instances[::10])
    prob = problem_from_demand(cat, np.array([8.0, 16.0, 4.0, 100.0]),
                               device=cuda)
    x = multistart_solve(prob, n_starts=2).best.x
    ops.reset_launches()
    got = kkt_report(prob, x)
    assert ops.LAUNCHES["alloc_objective"] == 1
    want = kkt_report(problem_to(prob, "cpu"), x.cpu())
    for f in want._fields:
        np.testing.assert_allclose(getattr(got, f).cpu().numpy(),
                                   getattr(want, f).numpy(), rtol=1e-3,
                                   atol=1e-4, err_msg=f)


def _with_all_terms(prob, seed):
    """``prob`` with the three scenario terms attached at random prices."""
    from repro_torch.core.terms import make_term, with_terms
    rng = np.random.default_rng(seed)
    return with_terms(prob, [
        make_term("slo_penalty", price=2.0),
        make_term("priority_eviction",
                  price=rng.uniform(0.0, 0.5, prob.n).astype(np.float32)),
        make_term("spot_risk",
                  risk=rng.uniform(0.0, 0.2, prob.n).astype(np.float32))])


@pytest.mark.parametrize("B,T", [(8, 1), (8, 12), (1, 72)])
def test_terms_kernel_route_matches_plain_at_4096(cuda, B, T):
    """eq. (1) with every scenario term attached at the spot fleet's width:
    the kernel route (the kernel's base terms plus the terms in PyTorch)
    against the plain route, single (B = 1, n = 3760) and stacked (padded
    to n = 4096). The points run from deep shortage to full cover, so the
    SLO hinge is live."""
    probs = [_with_all_terms(_problem(s, 4, 3760, 2, cuda), s)
             for s in range(B)]
    gen = torch.Generator(device=cuda).manual_seed(B * T)
    scale = torch.logspace(-3, 1.5, T, device=cuda)[:, None] / 3760
    if B == 1:
        prob = probs[0]
        X = torch.rand((T, prob.n), generator=gen, device=cuda) * scale
    else:
        prob = stack_problems(probs, n_max=4096).problem
        X = (torch.rand((B, T, 4096), generator=gen, device=cuda) * scale
             * prob.mask[:, None, :])
    ops.reset_launches()
    fk, gk = obj.value_and_grad(prob, X)
    assert sum(ops.LAUNCHES.values()) == 1
    fp, gp = obj.value_and_grad(prob, X, use_kernel=False)
    _close(fk, fp)
    _close(gk, gp)
    _close(obj.objective(prob, X), fp)
    _close(obj.grad_objective(prob, X), gp)
    bare = obj.objective(prob._replace(terms=()), X)
    assert not torch.allclose(bare, fk)


@pytest.mark.parametrize("B,H,T", [(8, 8, 1), (8, 8, 12), (3, 5, 12)])
def test_horizon_window_route_matches_plain(cuda, B, H, T):
    """The horizon solver's eq. (1) route on the card: every tick of B
    windows of H ticks (the B·H stack, lane-major) and the planned ticks'
    B·(H-1) stack of the ADMM prox, each in one kernel launch, against the
    plain version; gradient at T = 1, ladder values at T = 12."""
    from repro_torch.horizon import stack_windows
    from repro_torch.horizon.problem import flatten_lanes, tick_grads, tick_values
    from repro_torch.horizon.solver import _window
    wins = [[_problem(10 * b + h, 4, 1880, 2, cuda) for h in range(H)]
            for b in range(B)]
    hp = stack_windows(wins, n_max=2048, m_max=4, p_max=2)
    gen = torch.Generator(device=cuda).manual_seed(B * H + T)
    mask = hp.problem.mask
    lead = (T,) if T > 1 else ()
    X = 5.0 * torch.rand((B, *lead, H, 2048), generator=gen, device=cuda)
    X = X * (mask[:, None] if T > 1 else mask)
    P = flatten_lanes(hp.problem)
    ops.reset_launches()
    got = tick_values(P, X)
    assert sum(ops.LAUNCHES.values()) == 1
    assert got.shape == (B, *lead, H)
    _close(got, tick_values(P, X, use_kernel=False))
    if T == 1:
        ops.reset_launches()
        g = tick_grads(P, X)
        assert ops.LAUNCHES["alloc_objective_fleet"] == 1
        _close(g, tick_grads(P, X, use_kernel=False))
    rest = _window(hp.problem, hp.coupling_w, hp.coupling_eps, B, H).rest
    assert rest.K.shape[0] == B * (H - 1)
    Xr = X[..., 1:, :].movedim(-2, 1).reshape(B * (H - 1), *lead, 2048)
    ops.reset_launches()
    fr = obj.objective(rest, Xr)
    assert sum(ops.LAUNCHES.values()) == 1
    _close(fr, obj.objective(rest, Xr, use_kernel=False))


@pytest.mark.parametrize("solver", ["adaptive", "admm"])
def test_horizon_h1_fleet_step_is_the_myopic_step_on_the_card(cuda, solver):
    """H = 1 on the kernel: solve_horizon_fleet_step commits exactly what
    solve_fleet_step commits (plan, counts, objectives, iterations), and
    both launch the fleet kernel."""
    from repro_torch.fleet import solve_fleet_step
    from repro_torch.horizon import (HorizonSolverConfig,
                                     solve_horizon_fleet_step, stack_windows)
    from repro_torch.fleet.batching import tenant_problem
    batch, X = _warm_fleet(cuda)
    ops.reset_launches()
    fs = solve_fleet_step(batch, X, 6.0, device=cuda)
    assert ops.LAUNCHES["alloc_objective_fleet"] > 0
    hp = stack_windows([[tenant_problem(batch, b)] for b in range(batch.B)])
    ops.reset_launches()
    hs = solve_horizon_fleet_step(hp, X, 6.0,
                                  cfg=HorizonSolverConfig(solver=solver),
                                  device=cuda)
    assert ops.LAUNCHES["alloc_objective_fleet"] > 0
    assert torch.equal(fs.x, hs.plan[:, 0])
    for f in ("x_int", "fun_int", "feasible", "iters"):
        assert torch.equal(getattr(fs, f), getattr(hs, f)), f
