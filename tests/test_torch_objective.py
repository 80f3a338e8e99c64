"""The port's eq. (1) objective, gradient and constraint machinery, and the
plain versions of the alloc_objective kernel, held to the JAX reference
(and to its Pallas kernel in interpret mode) on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the operands are tiny, and the suite runs its files
# in parallel workers, where extra threads only take cores from the others
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.objective as jobj  # noqa: E402
from repro.fleet import stack_problems as jstack  # noqa: E402
from repro.kernels.alloc_objective import ops as jops  # noqa: E402
from repro.kernels.alloc_objective import ref as jref  # noqa: E402
from repro.testing import make_toy_problem  # noqa: E402

import repro_torch.core.objective as tobj  # noqa: E402
from repro_torch.bridge import (fleet_batch_from_arrays,  # noqa: E402
                                problem_arrays, problem_from_arrays)
from repro_torch.kernels.alloc_objective import ops as tops  # noqa: E402
from repro_torch.kernels.alloc_objective import ref as tref  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)   # tests/kernels/test_kernels.py:32-33


def _port(jprob):
    return problem_from_arrays(problem_arrays(jprob), device="cpu")


def _points(seed, shape, hi=5.0):
    return np.random.default_rng(seed).uniform(0, hi, shape).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


# ---------------------------------------------------------------------------
# core.objective
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,m,n,p,S", [(0, 3, 12, 2, 5), (1, 4, 37, 2, 7),
                                          (2, 4, 200, 3, 3), (3, 2, 16, 2, 1)])
def test_objective_grad_value_and_grad_match_reference(seed, m, n, p, S):
    jp = make_toy_problem(seed=seed, m=m, n=n, p=p)
    tp = _port(jp)
    X = _points(seed, (S, n))
    fj = jax.vmap(lambda x: jobj.objective(jp, x))(jnp.asarray(X))
    gj = jax.vmap(lambda x: jobj.grad_objective(jp, x))(jnp.asarray(X))
    Xt = torch.as_tensor(X)
    _close(tobj.objective(tp, Xt), fj)
    _close(tobj.grad_objective(tp, Xt), gj)
    f, g = tobj.value_and_grad(tp, Xt)
    _close(f, fj)
    _close(g, gj)
    terms_j = jobj.objective_terms(jp, jnp.asarray(X[0]))
    terms_t = tobj.objective_terms(tp, Xt[0])
    assert list(terms_j) == list(terms_t)
    for k in terms_j:
        _close(terms_t[k], terms_j[k])


def test_stacked_objective_matches_per_tenant_reference():
    """A padded stack evaluates every tenant exactly as its own problem."""
    probs = [make_toy_problem(seed=s, m=3 + s % 2, n=9 + 2 * s, p=2 + s % 2)
             for s in range(3)]
    jb = jstack(probs)
    tb = fleet_batch_from_arrays(problem_arrays(jb.problem), jb.n_true,
                                 jb.m_true, jb.p_true, device="cpu")
    X = _points(5, (3, 4, jb.n_max)) * np.asarray(jb.problem.mask)[:, None]
    f = tobj.objective(tb.problem, torch.as_tensor(X))
    g = tobj.grad_objective(tb.problem, torch.as_tensor(X))
    for b, jp in enumerate(probs):
        xs = jnp.asarray(X[b, :, : jp.n])
        _close(f[b], jax.vmap(lambda x: jobj.objective(jp, x))(xs))
        _close(g[b, :, : jp.n], jax.vmap(
            lambda x: jobj.grad_objective(jp, x))(xs))


def test_gradient_matches_autograd():
    tp = _port(make_toy_problem(seed=4, m=4, n=50, p=3))
    X = torch.as_tensor(_points(4, (6, 50)), dtype=torch.float64)
    tp64 = tp._replace(**{k: getattr(tp, k).double() for k in
                          ("K", "E", "c", "d", "mu", "g", "lb", "ub", "mask")},
                       params=type(tp.params)(*(a.double() for a in tp.params)))
    X.requires_grad_(True)
    f = tobj.objective(tp64, X)
    (auto,) = torch.autograd.grad(f.sum(), X)
    _close(tobj.grad_objective(tp64, X.detach()).numpy(), auto.numpy(),
           rtol=1e-9, atol=1e-9)


def test_constraints_and_projection_match_reference():
    jp = make_toy_problem(seed=6, m=4, n=30, p=2)
    jp = jp._replace(mu=0.3 * jp.d, g=0.5 * jp.d, lb=jnp.full(30, 0.5),
                     ub=jnp.full(30, 3.0),
                     mask=jnp.asarray((np.arange(30) % 4 != 0), jnp.float32))
    tp = _port(jp)
    X = _points(6, (8, 30), hi=4.0) - 0.5
    for x in X:
        lo_j, hi_j = jobj.constraint_residuals(jp, jnp.asarray(x))
        lo_t, hi_t = tobj.constraint_residuals(tp, torch.as_tensor(x))
        _close(lo_t, lo_j)
        _close(hi_t, hi_j)
        _close(tobj.project(tp, torch.as_tensor(x)),
               jobj.project(jp, jnp.asarray(x)))
        for tol in (1e-4, 1e-3, 10.0):
            assert bool(tobj.is_feasible(tp, torch.as_tensor(x), tol)) == bool(
                jobj.is_feasible(jp, jnp.asarray(x), tol))


# ---------------------------------------------------------------------------
# the kernel's plain versions (kernels/alloc_objective/ref.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,m,n,p,S", [
    (0, 4, 37, 2, 13), (1, 3, 128, 2, 64), (2, 4, 200, 3, 32),
    (3, 2, 16, 2, 1), (4, 4, 1880, 2, 8)])   # test_kernels.py:18-21
def test_alloc_objective_ref_matches_jnp_ref(seed, m, n, p, S):
    jp = make_toy_problem(seed=seed, m=m, n=n, p=p)
    X = _points(seed, (S, n))
    P = jp.params
    fj, gj = jref.alloc_objective_ref(jnp.asarray(X), jp.K, jp.E, jp.c, jp.d,
                                      P.alpha, P.beta1, P.beta2, P.beta3,
                                      P.gamma)
    tp = _port(jp)
    Q = tp.params
    ft, gt = tref.alloc_objective_ref(torch.as_tensor(X), tp.K, tp.E, tp.c,
                                      tp.d, *Q)
    _close(ft, fj)
    _close(gt, gj)
    f, g = tops.batched_value_and_grad(tp, torch.as_tensor(X))
    _close(f, fj)
    _close(g, gj)


@pytest.mark.parametrize("B,T,n", [(3, 5, 37), (2, 48, 1880)])
def test_fleet_ref_and_value_match_jnp_ref(B, T, n):
    probs = [make_toy_problem(seed=s, m=4, n=n, p=2) for s in range(B)]
    jb = jstack(probs).problem
    P = jb.params
    X = _points(B * T, (B, T, n))
    args_j = (jb.K, jb.E, jb.c, jb.d, P.alpha, P.beta1, P.beta2, P.beta3,
              P.gamma)
    fj, gj = jref.alloc_objective_fleet_ref(jnp.asarray(X), *args_j)
    vj = jref.alloc_objective_fleet_value(jnp.asarray(X), *args_j)
    tb = problem_from_arrays(problem_arrays(jb), device="cpu")
    Xt = torch.as_tensor(X)
    args_t = (tb.K, tb.E, tb.c, tb.d, *tb.params)
    ft, gt = tref.alloc_objective_fleet_ref(Xt, *args_t)
    _close(ft, fj)
    _close(gt, gj)
    _close(tref.alloc_objective_fleet_value(Xt, *args_t), vj)
    f, g = tops.fleet_value_and_grad(tb, Xt)
    _close(f, fj)
    _close(g, gj)
    _close(tops.fleet_value(tb, Xt), vj)


def test_plain_versions_match_pallas_kernel_interpret():
    """The Pallas TPU kernels, run as the reference's tests run them."""
    probs = [make_toy_problem(seed=s, m=4, n=37, p=2) for s in range(2)]
    jb = jstack(probs).problem
    X = _points(11, (2, 3, 37))
    fj, gj = jops.fleet_value_and_grad(jb, jnp.asarray(X), use_kernel=True,
                                       interpret=True)
    tb = problem_from_arrays(problem_arrays(jb), device="cpu")
    f, g = tops.fleet_value_and_grad(tb, torch.as_tensor(X))
    _close(f, fj)
    _close(g, gj)
    _close(tops.fleet_value(tb, torch.as_tensor(X)), fj)

    jp = probs[0]
    Xs = _points(12, (5, 37))
    fs, gs = jops.batched_value_and_grad(jp, jnp.asarray(Xs), interpret=True)
    f1, g1 = tops.batched_value_and_grad(_port(jp), torch.as_tensor(Xs))
    _close(f1, fs)
    _close(g1, gs)


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrappers run the plain version and launch nothing."""
    tp = _port(make_toy_problem(seed=0))
    tops.reset_launches()
    tops.batched_value_and_grad(tp, torch.rand(3, tp.n))
    tobj.objective(tp, torch.rand(3, tp.n))
    assert not any(tops.LAUNCHES.values())
    with pytest.raises(ValueError, match="CUDA"):
        tops._launch("alloc_objective", torch.rand(1, 2, tp.n), tp.K[None],
                     tp.E[None], tp.c[None], tp.d[None], torch.zeros(1, 8),
                     with_grad=True)
