"""The port's shape-bucketed stacking (``bucket_problems``,
``scatter_from_buckets``, ``padding_stats``, ``solve_fleet_bucketed``) and
the ``stack/padding_waste`` gauge of ``stack_problems``, held to the JAX
reference on the CPU, from the reference's starts."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the operands are tiny, and the suite runs its files
# in parallel workers, where extra threads only take cores from the others
torch.set_num_threads(1)

import repro.core.terms as jterms  # noqa: E402
import repro.fleet as jfleet  # noqa: E402
import repro.fleet.solver as jsolver  # noqa: E402
from repro.obs.telemetry import telemetry as jtelemetry  # noqa: E402
from repro.core import SolverConfig as JConfig  # noqa: E402
from repro.testing import make_toy_problem  # noqa: E402

import repro_torch.fleet as tfleet  # noqa: E402
import repro_torch.fleet.solver as tsolver  # noqa: E402
from repro_torch.obs.telemetry import (  # noqa: E402
    telemetry as ttelemetry)
from repro_torch.bridge import problem_arrays, problem_from_arrays  # noqa: E402
from repro_torch.core import SolverConfig as TConfig  # noqa: E402

TENANT_RTOL, FLEET_RTOL = 0.05, 2e-2   # tests/fleet/test_solve_fleet.py:113-117
CFG = dict(max_iters=100, barrier_rounds=2)   # tests/fleet/test_bucketing.py:23


def _ragged(B, seed0=0, terms=False):
    """The reference's ragged toy fleet (tests/fleet/test_bucketing.py:26);
    with ``terms`` every other tenant carries a scenario term."""
    out = []
    for s in range(B):
        jp = make_toy_problem(seed=seed0 + s, n=6 + 7 * (s % 4),
                              m=2 + s % 3, p=2 + s % 2)
        if terms and s % 2 == 0:
            rng = np.random.default_rng(s)
            kind = jterms.SCENARIO_TERMS[s % 3]
            ax = jterms.TERM_DEFS[kind].param_axes
            params = {k: rng.uniform(0.05, 0.5, {"": (), "n": (jp.n,),
                                                 "m": (jp.m,)}[a]
                                     ).astype(np.float32)
                      for k, a in ax.items()}
            jp = jterms.with_terms(jp, [jterms.make_term(kind, **params)])
        out.append(jp)
    return out


def _port(jprobs):
    return [problem_from_arrays(problem_arrays(p), device="cpu")
            for p in jprobs]


def _assert_same_arrays(a, b):
    assert set(a) == set(b)
    for k in a:
        if k == "params":
            for f in a[k]:
                np.testing.assert_array_equal(a[k][f], b[k][f])
        elif k == "terms":
            assert [t for t, _ in a[k]] == [t for t, _ in b[k]]
            for (_, pa), (_, pb) in zip(a[k], b[k]):
                for name in pa:
                    np.testing.assert_array_equal(pa[name], pb[name])
        else:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("B,seed0", [(5, 0), (9, 17), (12, 40)])
def test_bucket_problems_matches_reference_bit_for_bit(B, seed0):
    jprobs = _ragged(B, seed0, terms=True)
    jb = jfleet.bucket_problems(jprobs)
    tb = tfleet.bucket_problems(_port(jprobs))
    assert tb.n_buckets == jb.n_buckets and tb.B == jb.B == B
    for ti, ji in zip(tb.tenant_idx, jb.tenant_idx):
        np.testing.assert_array_equal(ti, np.asarray(ji))
    for tbatch, jbatch in zip(tb.batches, jb.batches):
        _assert_same_arrays(problem_arrays(tbatch.problem),
                            problem_arrays(jbatch.problem))
        for f in ("n_true", "m_true", "p_true"):
            np.testing.assert_array_equal(getattr(tbatch, f),
                                          getattr(jbatch, f))
        for i in range(tbatch.B):
            _assert_same_arrays(
                problem_arrays(tfleet.tenant_problem(tbatch, i)),
                problem_arrays(jfleet.tenant_problem(jbatch, i)))


def test_scatter_round_trip_is_exact():
    tprobs = _port(_ragged(11, 3))
    bucketed = tfleet.bucket_problems(tprobs)
    flat = np.concatenate(bucketed.tenant_idx)
    assert sorted(flat.tolist()) == list(range(11))
    payload = [[f"tenant-{int(b)}" for b in idx]
               for idx in bucketed.tenant_idx]
    assert tfleet.scatter_from_buckets(bucketed, payload) == [
        f"tenant-{b}" for b in range(11)]
    for batch, idx in zip(bucketed.batches, bucketed.tenant_idx):
        xs = [np.arange(tprobs[int(b)].n, dtype=np.float32) for b in idx]
        back = tfleet.unstack_solution(batch,
                                       tfleet.embed_solutions(batch, xs))
        for a, c in zip(xs, back):
            np.testing.assert_array_equal(a, c)
        for i, b in enumerate(idx):
            orig = tprobs[int(b)]
            back_p = tfleet.tenant_problem(batch, i)
            for leaf in ("K", "E", "c", "d", "mu", "g", "lb", "ub", "mask"):
                assert torch.equal(getattr(back_p, leaf), getattr(orig, leaf))
    with pytest.raises(ValueError, match="rows for a bucket"):
        tfleet.scatter_from_buckets(bucketed, [[]] * bucketed.n_buckets)


@pytest.mark.parametrize("B,seed0", [(3, 0), (8, 11), (16, 50)])
def test_padding_stats_match_reference(B, seed0):
    jprobs = _ragged(B, seed0)
    tprobs = _port(jprobs)
    assert tfleet.padding_stats(tprobs) == jfleet.padding_stats(jprobs)
    assert (tfleet.padding_stats(tprobs, tfleet.bucket_problems(tprobs))
            == jfleet.padding_stats(jprobs, jfleet.bucket_problems(jprobs)))


def test_padding_gauge_matches_reference():
    """With a recorder installed, each stacking samples
    ``stack/padding_waste`` as the reference's does; without one the
    stack is the same."""
    jprobs = _ragged(7, 5, terms=True)
    tprobs = _port(jprobs)
    with jtelemetry() as jrec:
        jfleet.stack_problems(jprobs)
        jfleet.stack_problems(jprobs[:3], n_max=64, m_max=8, p_max=4)
    with ttelemetry() as trec:
        on = tfleet.stack_problems(tprobs)
        tfleet.stack_problems(tprobs[:3], n_max=64, m_max=8, p_max=4)
    want = [v for _, v in jrec.gauges["stack/padding_waste"]]
    got = [v for _, v in trec.gauges["stack/padding_waste"]]
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=1e-12)
    off = tfleet.stack_problems(tprobs)
    _assert_same_arrays(problem_arrays(on.problem), problem_arrays(off.problem))


def _bucketed_pair(monkeypatch, jprobs, hot_loop):
    """Both packages' solve_fleet_bucketed on the same fleet, the port fed
    the reference's per-bucket starts."""
    starts = []

    def capture(batch, n_starts, seed=0):
        out = jsolver_make_starts(batch, n_starts, seed)
        starts.append(np.array(out))
        return out

    jsolver_make_starts = jsolver.make_fleet_starts
    monkeypatch.setattr(jsolver, "make_fleet_starts", capture)
    ref = jfleet.solve_fleet_bucketed(jprobs, n_starts=2, cfg=JConfig(**CFG),
                                      hot_loop="ref")
    fed = iter(starts)
    monkeypatch.setattr(tsolver, "make_fleet_starts",
                        lambda batch, n_starts, seed=0:
                        torch.as_tensor(next(fed)))
    port = tfleet.solve_fleet_bucketed(_port(jprobs), n_starts=2,
                                       cfg=TConfig(**CFG), hot_loop=hot_loop,
                                       device="cpu")
    assert next(fed, None) is None
    return ref, port


@pytest.mark.parametrize("terms", [False, True])
def test_solve_fleet_bucketed_matches_reference(monkeypatch, terms):
    jprobs = _ragged(7, terms=terms)
    ref, port = _bucketed_pair(monkeypatch, jprobs, "kernel")
    fr = np.asarray(ref.fun_int)
    fp = port.fun_int.numpy()
    np.testing.assert_allclose(fp, fr, rtol=TENANT_RTOL)
    assert abs(fp.sum() - fr.sum()) / abs(fr.sum()) < FLEET_RTOL
    np.testing.assert_array_equal(port.feasible.numpy(),
                                  np.asarray(ref.feasible))
    n_max = max(p.n for p in jprobs)
    assert tuple(port.x_int.shape) == (7, n_max)
    assert tuple(port.x_int_all.shape) == (7, 2, n_max)
    x_int = port.x_int.numpy()
    np.testing.assert_array_equal(x_int, np.round(x_int))
    for b, p in enumerate(jprobs):
        assert not x_int[b, p.n:].any()


@pytest.mark.parametrize("hot_loop", ["vmap", "kernel"])
def test_bucketed_equals_unbucketed_fun_int(hot_loop):
    """Bucketing does not change what is solved: the port's bucketed and
    globally padded solves give the same integer objectives and
    allocations (tests/fleet/test_bucketing.py:128-130)."""
    tprobs = _port(_ragged(7))
    flat = tfleet.solve_fleet(tfleet.stack_problems(tprobs), n_starts=2,
                              cfg=TConfig(**CFG), hot_loop=hot_loop,
                              device="cpu")
    buck = tfleet.solve_fleet_bucketed(tprobs, n_starts=2, cfg=TConfig(**CFG),
                                       hot_loop=hot_loop, device="cpu")
    assert torch.equal(buck.fun_int, flat.fun_int)
    assert torch.equal(buck.x_int, flat.x_int)
    np.testing.assert_allclose(buck.fun.numpy(), flat.fun.numpy(), rtol=5e-3)
    assert bool(buck.feasible.all())
