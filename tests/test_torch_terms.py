"""The port's scenario terms (``repro_torch.core.terms``: SLO pricing,
priority eviction, spot risk) held to the JAX reference's on the CPU:
each term's value and gradient, single and stacked, the objective with
terms on both of the port's routes, zero params as an exact no-op,
padding exactness under union stacking, and the validation the reference
does."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the operands are tiny, and the suite runs its files
# in parallel workers, where extra threads only take cores from the others
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.objective as jobj  # noqa: E402
import repro.core.terms as jterms  # noqa: E402
from repro.fleet import stack_problems as jstack  # noqa: E402
from repro.testing import make_toy_problem  # noqa: E402

import repro_torch.core.objective as tobj  # noqa: E402
import repro_torch.core.terms as tterms  # noqa: E402
from repro_torch.bridge import (fleet_batch_from_arrays,  # noqa: E402
                                problem_arrays, problem_from_arrays,
                                terms_arrays)
from repro_torch.fleet.batching import (stack_problems,  # noqa: E402
                                        tenant_problem, union_term_kinds)

TERM_TOL = dict(rtol=1e-5, atol=1e-6)   # tests/core/test_terms.py:139-140
KERNEL_TOL = dict(rtol=1e-4, atol=1e-4)  # tests/kernels/test_kernels.py:32-33


def _params(n, m, kind, seed, zero=False):
    """Random (or zero) params of an attachable kind at shape (n, m)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, ax in jterms.TERM_DEFS[kind].param_axes.items():
        shape = {"": (), "n": (n,), "m": (m,)}[ax]
        out[k] = (np.zeros(shape, np.float32) if zero
                  else rng.uniform(0.05, 0.5, size=shape).astype(np.float32))
    return out


def _ref_problem(seed, kinds=jterms.SCENARIO_TERMS, zero=False, **shape):
    jp = make_toy_problem(seed=seed, **shape)
    return jterms.with_terms(jp, [
        jterms.make_term(k, **_params(jp.n, jp.m, k, seed + 10, zero))
        for k in kinds])


def _port(jprob):
    return problem_from_arrays(problem_arrays(jprob), device="cpu")


def _points(seed, shape, hi=3.0):
    return np.random.default_rng(seed).uniform(0, hi, shape).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


@pytest.mark.parametrize("kind", jterms.SCENARIO_TERMS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scenario_term_value_and_grad_match_reference(kind, seed):
    jp = _ref_problem(seed, kinds=(kind,))
    tp = _port(jp)
    assert tterms.term_signature(tp) == (kind,)
    X = _points(seed, (4, jp.n))
    jt, tt = jp.terms[0], tp.terms[0]
    jtd, ttd = jterms.TERM_DEFS[kind], tterms.TERM_DEFS[kind]
    for x in X:
        xj, xt = jnp.asarray(x), torch.as_tensor(x)
        _close(ttd.value(tp, tt.params, xt, tp.K @ xt, tp.E @ xt),
               jtd.value(jp, jt.params, xj, jp.K @ xj, jp.E @ xj), TERM_TOL)
        _close(ttd.grad(tp, tt.params, xt, tp.K @ xt, tp.E @ xt).expand(
            jp.n), jnp.broadcast_to(
            jtd.grad(jp, jt.params, xj, jp.K @ xj, jp.E @ xj), (jp.n,)),
            TERM_TOL)
    # and the additive hook over all points at once
    Xj = jnp.asarray(X)
    _close(tterms.active_value(tp, torch.as_tensor(X)),
           jax.vmap(lambda x: jterms.active_value(jp, x))(Xj), TERM_TOL)
    _close(tterms.active_grad(tp, torch.as_tensor(X)),
           jax.vmap(lambda x: jterms.active_grad(jp, x))(Xj), TERM_TOL)


@pytest.mark.parametrize("seed", [0, 3])
def test_objective_with_all_terms_matches_reference(seed):
    jp = _ref_problem(seed, n=17, m=3)
    tp = _port(jp)
    X = _points(seed, (5, jp.n))
    Xj, Xt = jnp.asarray(X), torch.as_tensor(X)
    fj = jax.vmap(lambda x: jobj.objective(jp, x))(Xj)
    gj = jax.vmap(lambda x: jobj.grad_objective(jp, x))(Xj)
    f, g = tobj.value_and_grad(tp, Xt)
    _close(f, fj, TERM_TOL)
    _close(g, gj, TERM_TOL)
    _close(tobj.objective(tp, Xt), fj, TERM_TOL)
    _close(tobj.grad_objective(tp, Xt), gj, TERM_TOL)
    names_j = list(jobj.objective_terms(jp, Xj[0]))
    assert list(tobj.objective_terms(tp, Xt[0])) == names_j


def test_stacked_terms_match_reference_per_tenant():
    """A padded stack whose tenants carry different kinds evaluates each
    tenant as the reference evaluates it alone."""
    probs = [_ref_problem(0, kinds=("slo_penalty",), n=9, m=3),
             _ref_problem(1, kinds=("spot_risk", "priority_eviction"),
                          n=14, m=4, p=3),
             make_toy_problem(seed=2, n=11, m=2)]
    jb = jstack(probs)
    tb = fleet_batch_from_arrays(problem_arrays(jb.problem), jb.n_true,
                                 jb.m_true, jb.p_true, device="cpu")
    # the port stacks the same union, in the same order, with the same bits
    pb = stack_problems([_port(p) for p in probs]).problem
    assert [t.kind for t in pb.terms] == list(union_term_kinds(probs))
    for (kind, a), (_, b) in zip(terms_arrays(pb.terms),
                                 terms_arrays(jb.problem.terms)):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    X = _points(5, (3, 4, jb.n_max)) * np.asarray(jb.problem.mask)[:, None]
    Xt = torch.as_tensor(X)
    f, g = tobj.value_and_grad(tb.problem, Xt)
    av, ag = tterms.active_value(pb, Xt), tterms.active_grad(pb, Xt)
    for b, jp in enumerate(probs):
        xs = jnp.asarray(X[b, :, : jp.n])
        _close(f[b], jax.vmap(lambda x: jobj.objective(jp, x))(xs), TERM_TOL)
        _close(g[b, :, : jp.n],
               jax.vmap(lambda x: jobj.grad_objective(jp, x))(xs), TERM_TOL)
        _close(av[b], jax.vmap(lambda x: jterms.active_value(jp, x))(xs),
               TERM_TOL)
        _close(ag[b, :, : jp.n],
               jax.vmap(lambda x: jterms.active_grad(jp, x))(xs), TERM_TOL)


def test_forced_term_kinds_match_reference():
    """``stack_problems(term_kinds=)`` forces the stacked signature: a kind
    that no tenant carries is stacked as zeros, and the params equal the
    reference's bit for bit, in the forced order."""
    probs = [_ref_problem(0, kinds=("slo_penalty",), n=9, m=3),
             make_toy_problem(seed=2, n=11, m=2)]
    kinds = tuple(reversed(jterms.SCENARIO_TERMS))
    jb = jstack(probs, term_kinds=kinds)
    pb = stack_problems([_port(p) for p in probs], term_kinds=kinds).problem
    assert tterms.term_signature(pb) == kinds
    assert [k for k, _ in terms_arrays(jb.problem.terms)] == list(kinds)
    for (_, a), (_, b) in zip(terms_arrays(pb.terms),
                              terms_arrays(jb.problem.terms)):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_zero_params_exact_noop():
    base = make_toy_problem(seed=2)
    tp0 = _port(base)
    tpz = _port(_ref_problem(2, zero=True))
    X = torch.as_tensor(_points(3, (3, base.n)))
    assert torch.equal(tobj.objective(tpz, X), tobj.objective(tp0, X))
    assert torch.equal(tobj.grad_objective(tpz, X),
                       tobj.grad_objective(tp0, X))
    assert torch.equal(tterms.active_value(tpz, X), torch.zeros(3))
    assert torch.equal(tterms.active_grad(tpz, X), torch.zeros_like(X))


def test_padding_exact_with_union_of_kinds():
    """A tenant padded to a wider stack, with a kind it lacks at zero
    params, gives the same bits on its true coordinates, and slices back
    with the batch's signature."""
    a = _port(_ref_problem(0, kinds=("slo_penalty",), n=10))
    b = _port(_ref_problem(1, kinds=("spot_risk",), n=6))
    batch = stack_problems([a, b])
    for i, orig in enumerate((a, b)):
        x = torch.as_tensor(_points(7, (orig.n,)))
        x_pad = torch.zeros(batch.n_max)
        x_pad[: orig.n] = x
        sub = tenant_problem(batch, i)
        assert tterms.term_signature(sub) == ("slo_penalty", "spot_risk")
        for prob, xv in ((sub, x), (orig, x)):
            assert float(tobj.objective(prob, xv)) == float(
                tobj.objective(orig, x))
        row = tobj.objective(batch.problem, torch.stack(
            [x_pad if j == i else torch.zeros(batch.n_max)
             for j in range(2)]))
        assert float(row[i]) == float(tobj.objective(orig, x))
        assert torch.equal(tobj.grad_objective(sub, x),
                           tobj.grad_objective(orig, x))


def test_kernel_route_equals_plain_route(monkeypatch):
    """The kernel route (the kernel's base terms plus ``active_value`` /
    ``active_grad``), run through the kernel's plain version on the CPU,
    against the plain route (the registry sum), single and stacked: no
    term counted twice or left out."""
    monkeypatch.setattr(tobj, "_kernel_route", lambda x, use_kernel:
                        use_kernel)
    jp = _ref_problem(4, n=23, m=4)
    tp = _port(jp)
    X = torch.as_tensor(_points(4, (6, jp.n)))
    stacked = stack_problems([tp, _port(_ref_problem(
        5, kinds=("priority_eviction",), n=15))]).problem
    XS = torch.as_tensor(_points(6, (2, 3, 23))) * stacked.mask[:, None]
    for prob, x in ((tp, X), (stacked, XS)):
        fk, gk = tobj.value_and_grad(prob, x, use_kernel=True)
        fp, gp = tobj.value_and_grad(prob, x, use_kernel=False)
        _close(fk, fp, KERNEL_TOL)
        _close(gk, gp, KERNEL_TOL)
        _close(tobj.objective(prob, x, use_kernel=True), fp, KERNEL_TOL)
        _close(tobj.grad_objective(prob, x, use_kernel=True), gp, KERNEL_TOL)
        # the terms' share is really there: dropping them moves the value
        bare = prob._replace(terms=())
        assert not torch.allclose(tobj.objective(bare, x, use_kernel=True),
                                  fk)
    fj = jax.vmap(lambda x: jobj.objective(jp, x))(jnp.asarray(X.numpy()))
    _close(tobj.objective(tp, X, use_kernel=True), fj, KERNEL_TOL)


def test_make_term_validation():
    with pytest.raises(ValueError, match="unknown term kind"):
        tterms.make_term("nope", price=1.0)
    with pytest.raises(ValueError, match="implicit"):
        tterms.make_term("base_cost")
    with pytest.raises(ValueError, match="expects params"):
        tterms.make_term("slo_penalty", prices=1.0)
    with pytest.raises(ValueError, match="expects params"):
        tterms.make_term("slo_penalty")
    t = tterms.make_term("slo_penalty", price=2)
    assert t.params["price"].dtype == torch.float32
    assert tterms.SCENARIO_TERMS == jterms.SCENARIO_TERMS
    assert tterms.BASE_TERMS == jterms.BASE_TERMS
    for kind in jterms.TERM_DEFS:
        assert (dict(tterms.TERM_DEFS[kind].param_axes)
                == dict(jterms.TERM_DEFS[kind].param_axes))


def test_with_terms_and_create_validation():
    tp = _port(make_toy_problem(seed=0))
    with pytest.raises(ValueError, match="expected shape"):
        tterms.with_terms(tp, [tterms.make_term(
            "spot_risk", risk=np.ones(tp.n + 1, np.float32))])
    with pytest.raises(ValueError, match="duplicate"):
        tterms.with_terms(tp, [tterms.make_term("slo_penalty", price=1.0),
                               ("slo_penalty", {"price": 2.0})])
    probT = tterms.with_terms(tp, [("slo_penalty", {"price": 1.5})])
    assert tterms.term_signature(probT) == ("slo_penalty",)
    assert [t.kind for t in tterms.normalize_terms(probT.terms)] == [
        "slo_penalty"]
    # AllocationProblem.create attaches through the same checks
    from repro_torch.core.problem import AllocationProblem
    arr = problem_arrays(make_toy_problem(seed=0))
    made = AllocationProblem.create(arr["K"], arr["E"], arr["c"], arr["d"],
                                    terms=[("slo_penalty", {"price": 0.5})],
                                    device="cpu")
    assert float(made.terms[0].params["price"]) == 0.5
    with pytest.raises(ValueError, match="expected shape"):
        AllocationProblem.create(arr["K"], arr["E"], arr["c"], arr["d"],
                                 terms=[("spot_risk", {"risk": [1.0]})],
                                 device="cpu")


def test_register_term_validation():
    fn = tterms.TERM_DEFS["base_cost"].value
    with pytest.raises(ValueError, match="already registered"):
        tterms.register_term("base_cost", fn, fn)
    with pytest.raises(ValueError, match="invalid param axes"):
        tterms.register_term("bad_axes", fn, fn, {"w": "q"})
    assert "bad_axes" not in tterms.TERM_DEFS


def test_terms_cross_the_bridge_both_ways():
    """Reference terms -> port -> numpy -> reference: the same params."""
    jp = _ref_problem(6)
    tp = _port(jp)
    back = [jterms.make_term(kind, **params)
            for kind, params in terms_arrays(tp.terms)]
    jp2 = jterms.with_terms(make_toy_problem(seed=6), back)
    x = jnp.asarray(_points(6, (jp.n,)))
    assert float(jobj.objective(jp2, x)) == float(jobj.objective(jp, x))
    moved = tterms.make_term("slo_penalty", price=1.0).to("cpu")
    assert moved.params["price"].device.type == "cpu"
