"""The horizon package's numpy copy and its time-expanded program: the
port's forecasters equal the reference's, the coupling / commit / churn-
bound terms and the window objective agree with the reference on the same
windows (rtol = atol = 1e-4, tests/kernels/test_kernels.py:32-33), each
analytic gradient agrees with torch.autograd within the port (the
reference's tests/horizon/test_problem.py tolerances), zero coupling
decouples the window, and padding a window changes nothing."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from hypothesis import given, settings, strategies as st  # noqa: E402

import jax.numpy as jnp  # noqa: E402

import repro.horizon as jh  # noqa: E402
import repro.horizon.forecast as jfc  # noqa: E402
from repro.testing import make_toy_problem as jtoy  # noqa: E402

import repro_torch.horizon as th  # noqa: E402
import repro_torch.horizon.forecast as tfc  # noqa: E402
from repro_torch.bridge import horizon_arrays, horizon_from_arrays  # noqa: E402
from repro_torch.core import objective as tobj  # noqa: E402
from repro_torch.testing import make_toy_problem as ttoy  # noqa: E402

RTOL = ATOL = 1e-4


def _pair(seed: int, H: int, n: int = 10, m: int = 3, **kw):
    """One window of H toy problems in both packages."""
    jhp = jh.expand_problems([jtoy(seed=seed + h, n=n, m=m)
                              for h in range(H)], **kw)
    return jhp, horizon_from_arrays(horizon_arrays(jhp), "cpu")


@pytest.mark.parametrize("kind,kw", [("last_value", {}), ("ewma", {}),
                                     ("ewma", {"alpha": 0.7}),
                                     ("holt_winters", {"period": 5}),
                                     ("oracle", {})])
def test_forecasters_equal_the_reference(kind, kw):
    """Every kind's observe / predict sequence, exactly (a numpy copy)."""
    rng = np.random.default_rng(3)
    trace = rng.uniform(1.0, 9.0, size=(12, 4))
    fj = jfc.make_forecaster(kind, trace=trace, **kw)
    ft = tfc.make_forecaster(kind, trace=trace, **kw)
    for d in trace:
        fj.observe(d)
        ft.observe(d)
        for k in (1, 3, 7):
            np.testing.assert_array_equal(ft.predict(k), fj.predict(k))
    assert tfc.FORECASTER_KINDS.keys() == jfc.FORECASTER_KINDS.keys()
    assert tfc.FORECAST_FLOOR == jfc.FORECAST_FLOOR
    with pytest.raises(ValueError):
        tfc.make_forecaster("nope")
    with pytest.raises(ValueError):
        tfc.make_forecaster("oracle")


@settings(max_examples=6, deadline=None, database=None)
@given(seed=st.integers(0, 10_000), H=st.integers(2, 5))
def test_window_terms_match_the_reference(seed, H):
    """coupling, commit coupling and the churn bound, value and gradient,
    and the window objective with its split, against the reference at
    1e-4."""
    jhp, thp = _pair(seed, H, coupling_w=0.3)
    rng = np.random.default_rng(seed)
    X = rng.normal(scale=3.0, size=(H, 10)).astype(np.float32)
    xc = rng.normal(size=10).astype(np.float32)
    Xj, Xt = jnp.asarray(X), torch.as_tensor(X)
    xcj, xct = jnp.asarray(xc), torch.as_tensor(xc)
    w, eps, dm, dpw = 0.3, 1e-4, 4.0, 5.0
    pairs = [
        (jh.coupling_penalty(Xj, w, eps), th.coupling_penalty(Xt, w, eps)),
        (jh.coupling_grad(Xj, w, eps), th.coupling_grad(Xt, w, eps)),
        (jh.commit_coupling_penalty(Xj, xcj, w, eps),
         th.commit_coupling_penalty(Xt, xct, w, eps)),
        (jh.commit_coupling_grad(Xj, xcj, w, eps),
         th.commit_coupling_grad(Xt, xct, w, eps)),
        (jh.smoothed_churn(Xj, eps), th.smoothed_churn(Xt, eps)),
        (jh.churn_bound_penalty(Xj, dm, dpw, eps),
         th.churn_bound_penalty(Xt, dm, dpw, eps)),
        (jh.churn_bound_grad(Xj, dm, dpw, eps),
         th.churn_bound_grad(Xt, dm, dpw, eps))]
    Xp = np.abs(X)
    pairs.append((jh.horizon_objective(jhp, jnp.asarray(Xp)),
                  th.horizon_objective(thp, torch.as_tensor(Xp))))
    split_j = jh.horizon_objective_terms(jhp, jnp.asarray(Xp))
    split_t = th.horizon_objective_terms(thp, torch.as_tensor(Xp))
    pairs += [(split_j[k], split_t[k]) for k in ("per_tick", "coupling")]
    defs_j = jh.coupling_term_defs(jhp, xcj, dm, dpw)
    defs_t = th.coupling_term_defs(thp, xct, dm, dpw)
    assert [d.name for d in defs_t] == [d.name for d in defs_j]
    for dj, dt in zip(defs_j, defs_t):
        pairs += [(dj.value(Xj), dt.value(Xt)), (dj.grad(Xj), dt.grad(Xt))]
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)


@settings(max_examples=6, deadline=None, database=None)
@given(seed=st.integers(0, 10_000), H=st.integers(2, 5))
def test_analytic_grads_match_autograd(seed, H):
    """Each hand-written gradient against torch.autograd of its value, at
    the reference's tolerances (tests/horizon/test_problem.py: 1e-4 / 1e-6
    for the smoothed |.|, 1e-3 / 1e-4 for the churn-bound hinge)."""
    rng = np.random.default_rng(seed)
    X = torch.as_tensor(rng.normal(size=(H, 7)).astype(np.float32))
    Xbig = torch.as_tensor(rng.normal(scale=3.0, size=(H, 7)).astype(
        np.float32))
    xc = torch.as_tensor(rng.normal(size=7).astype(np.float32))
    w, eps = torch.tensor(0.3), torch.tensor(1e-4)

    def auto(fn, x):
        x = x.clone().requires_grad_(True)
        fn(x).backward()
        return x.grad

    cases = [
        (lambda x: th.coupling_penalty(x, w, eps),
         th.coupling_grad(X, w, eps), X, 1e-4, 1e-6),
        (lambda x: th.commit_coupling_penalty(x, xc, w, eps),
         th.commit_coupling_grad(X, xc, w, eps), X, 1e-4, 1e-6),
        (lambda x: th.churn_bound_penalty(x, 4.0, 5.0, eps),
         th.churn_bound_grad(Xbig, 4.0, 5.0, eps), Xbig, 1e-3, 1e-4)]
    for fn, grad, x, rtol, atol in cases:
        np.testing.assert_allclose(grad.numpy(), auto(fn, x).numpy(),
                                   rtol=rtol, atol=atol)


@settings(max_examples=8, deadline=None, database=None)
@given(seed=st.integers(0, 10_000), H=st.integers(1, 6))
def test_zero_coupling_decouples_into_per_tick_objectives(seed, H):
    """coupling_w == 0: the window objective is the sum of the per-tick
    objectives (rtol 1e-6, the reference's)."""
    probs = [ttoy(seed=seed + h, n=10, m=3, device="cpu") for h in range(H)]
    hp = th.expand_problems(probs, coupling_w=0.0)
    rng = np.random.default_rng(seed)
    X = torch.as_tensor(rng.uniform(0.0, 5.0, size=(H, 10)).astype(
        np.float32))
    per_tick = sum(float(tobj.objective(pb, X[h]))
                   for h, pb in enumerate(probs))
    np.testing.assert_allclose(float(th.horizon_objective(hp, X)), per_tick,
                               rtol=1e-6)


def test_padding_and_slicing_are_exact():
    """A window padded to bucket dims gives the embedded plan the same
    objective (rtol 1e-6), tick_problem slices each tick back out, the
    churn bound is inert within its budget, a constant plan has no
    coupling, and a held committed row has no commit price."""
    probs = [ttoy(seed=7 + h, n=10, m=3, device="cpu") for h in range(3)]
    hp = th.expand_problems(probs, coupling_w=0.2)
    hp_pad = th.expand_problems(probs, coupling_w=0.2, n_max=16, m_max=4,
                                p_max=4)
    X = torch.as_tensor(np.random.default_rng(0).uniform(
        0.0, 4.0, size=(3, 10)).astype(np.float32))
    X_pad = torch.nn.functional.pad(X, (0, 6))
    np.testing.assert_allclose(float(th.horizon_objective(hp, X)),
                               float(th.horizon_objective(hp_pad, X_pad)),
                               rtol=1e-6)
    assert hp.H == 3 and hp.n == 10 and hp_pad.n == 16
    for h, pb in enumerate(probs):
        back = th.tick_problem(hp, h)
        assert torch.equal(back.K, pb.K) and torch.equal(back.d, pb.d)
    flat = torch.zeros((2, 5))
    flat[1] = 0.5                                   # churn 2.5 < 4
    assert float(th.churn_bound_penalty(flat, 4.0, 10.0, 1e-6)) < 1e-4
    assert float(th.churn_bound_grad(flat, 4.0, 10.0, 1e-6).abs().max()) == 0
    assert float(th.coupling_penalty(torch.full((4, 6), 3.0), 1.0,
                                     1e-6)) == 0.0
    xc = torch.tensor([2.0, 3.0, 1.0])
    plan = torch.stack([xc, xc * 4.0, xc * 0.5])
    assert float(th.commit_coupling_penalty(plan, xc, 1.0, 1e-6)) == 0.0
    assert float(th.commit_coupling_grad(plan, xc, 1.0, 1e-6).abs().max()) == 0


def test_stacked_windows_are_lane_major():
    """stack_windows puts lane b's ticks contiguous, so the B·H stack is a
    view of the (B, H, ...) leaves, and each lane equals its own window."""
    wins = [[ttoy(seed=10 * b + h, device="cpu") for h in range(3)]
            for b in range(2)]
    fleet = th.stack_windows(wins, n_max=16, m_max=4, p_max=2)
    assert fleet.problem.K.shape == (2, 3, 4, 16)
    flat = th.problem.flatten_lanes(fleet.problem)
    assert flat.K.data_ptr() == fleet.problem.K.data_ptr()
    for b, w in enumerate(wins):
        alone = th.expand_problems(w, n_max=16, m_max=4, p_max=2)
        assert torch.equal(fleet.problem.K[b], alone.problem.K)
        assert torch.equal(flat.c[3 * b:3 * b + 3], alone.problem.c)
