"""The port's solver-trace helpers against the reference's: the same
seeded records through both (jnp to the reference, torch on the CPU to the
port) give equal outputs, sentinels included; and a traced replay of the
same fleet in both packages, the port fed the reference's starts, gives
summaries that agree where the trajectories do."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the operands are tiny, and the suite runs its files
# in parallel workers, where extra threads only take cores from the others
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.fleet as jfleet  # noqa: E402
import repro.fleet.replay as jreplay  # noqa: E402
import repro.obs as jobs  # noqa: E402
from repro.core.pgd import PGDTrace as JPGDTrace  # noqa: E402
from repro.horizon.admm import ADMMTrace as JADMMTrace  # noqa: E402

import repro_torch.core as tcore  # noqa: E402
import repro_torch.fleet as tfleet  # noqa: E402
import repro_torch.fleet.replay as treplay  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
from repro_torch.core.pgd import PGDTrace as TPGDTrace  # noqa: E402
from repro_torch.horizon.admm import ADMMTrace as TADMMTrace  # noqa: E402

B, L = 4, 12
# lanes' executed rows: a full lane, two partial ones, and an empty one
ITERS = (L, 7, 3, 0)
FIRST_ROWS = dict(rtol=1e-4, atol=1e-4)   # tests/test_torch_replay.py:227


def _pgd_arrays(seed):
    """A (B, L) PGD record with the engine's sentinels past each lane's
    iterations; lane 2 never accepts (mean_rung None)."""
    rng = np.random.default_rng(seed)
    merit = np.full((B, L), np.nan, np.float32)
    step = np.full((B, L), np.nan, np.float32)
    move = np.full((B, L), np.nan, np.float32)
    accepted = np.zeros((B, L), bool)
    rung = np.full((B, L), -1, np.int32)
    for b, k in enumerate(ITERS):
        merit[b, :k] = np.sort(rng.uniform(1.0, 5.0, k))[::-1]
        step[b, :k] = rng.uniform(0.01, 1.0, k)
        acc = rng.random(k) < 0.7 if b != 2 else np.zeros(k, bool)
        accepted[b, :k] = acc
        rung[b, :k] = np.where(acc, rng.integers(0, 12, k), -1)
        move[b, :k] = np.where(acc, rng.uniform(0.0, 3.0, k), 0.0)
    return merit, step, accepted, rung, move


def _admm_arrays(seed):
    rng = np.random.default_rng(seed)
    primal = np.full((B, L), np.nan, np.float32)
    dual = np.full((B, L), np.nan, np.float32)
    inner = np.full((B, L), -1, np.int32)
    for b, k in enumerate(ITERS):
        primal[b, :k] = rng.uniform(0.01, 1.0, k)
        dual[b, :k] = rng.uniform(0.01, 1.0, k)
        inner[b, :k] = rng.integers(1, 40, k)
    return primal, dual, inner


def _pair(kind, seed=0):
    """The same record as the reference's (jnp) and the port's (torch)."""
    if kind == "pgd":
        arrs = _pgd_arrays(seed)
        return (JPGDTrace(*(jnp.asarray(a) for a in arrs)),
                TPGDTrace(*(torch.from_numpy(a) for a in arrs)))
    arrs = _admm_arrays(seed)
    return (JADMMTrace(*(jnp.asarray(a) for a in arrs)),
            TADMMTrace(*(torch.from_numpy(a) for a in arrs)))


def _same_record(got, want):
    assert type(got).__name__ == type(want).__name__
    assert got._fields == want._fields
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray)
        assert g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, np.asarray(w))   # NaN == NaN here


def _same_summary(got, want):
    """Equal dicts, value types too, a NaN equal to a NaN (an explicit
    ``iters`` past a lane's executed rows reads its sentinels)."""
    assert list(got) == list(want)
    for k in want:
        g, w = got[k], want[k]
        assert type(g) is type(w), k
        assert g == w or (isinstance(w, float) and np.isnan(w)
                          and np.isnan(g)), (k, g, w)


@pytest.mark.parametrize("kind", ["pgd", "admm"])
def test_trace_length_and_lane_trace_equal(kind):
    j, t = _pair(kind)
    if kind == "pgd":   # the PGD schema's helper, in both packages
        assert tobs.trace_length(t) == jobs.trace_length(j) == L
    for b in range(B):
        _same_record(tobs.lane_trace(t, b), jobs.lane_trace(j, b))


@pytest.mark.parametrize("kind", ["pgd", "admm"])
def test_lane_trace_raises_on_a_single_lane_in_both(kind):
    j, t = _pair(kind)
    for mod, rec in ((jobs, j), (tobs, t)):
        lane = mod.lane_trace(rec, 0)
        with pytest.raises(ValueError, match="single-lane"):
            mod.lane_trace(lane, 0)
    with pytest.raises(ValueError, match="single-lane"):
        tobs.lane_trace(type(t)(*(f[0] for f in t)), 0)   # (L,) tensors


@pytest.mark.parametrize("iters", [None, 2])
def test_trim_and_summary_equal(iters):
    j, t = _pair("pgd", seed=1)
    with pytest.raises(ValueError, match="lane_trace first"):
        tobs.trim_trace(t)
    with pytest.raises(ValueError, match="lane_trace first"):
        jobs.trim_trace(j)
    for b in range(B):
        want_iters = ITERS[b] if iters is None else iters
        jl, tl = jobs.lane_trace(j, b), tobs.lane_trace(t, b)
        # the port's helpers take a lane as tensors or as numpy alike
        tl_tensors = TPGDTrace(*(torch.from_numpy(f) for f in tl))
        for rec in (tl, tl_tensors):
            _same_record(tobs.trim_trace(rec, iters),
                         jobs.trim_trace(jl, iters))
            got, want = (tobs.trace_summary(rec, iters),
                         jobs.trace_summary(jl, iters))
            _same_summary(got, want)
            assert got["iters"] == want_iters
        if want_iters == 0:
            assert got["merit_first"] is None
        if b == 2:
            assert got["mean_rung"] is None


def test_traces_to_dict_equal():
    j, t = _pair("pgd", seed=2)
    jl = [jobs.lane_trace(j, b) for b in range(B)]
    tl = [tobs.lane_trace(t, b) for b in range(B)]
    got, want = tobs.traces_to_dict(tl), jobs.traces_to_dict(jl)
    assert got == want
    assert [d["iters"] for d in got] == list(ITERS)


@pytest.mark.parametrize("iters", [None, 5])
def test_admm_trim_and_summary_equal(iters):
    j, t = _pair("admm", seed=3)
    with pytest.raises(ValueError, match="lane_trace first"):
        tobs.trim_admm_trace(t)
    for b in range(B):
        jl, tl = jobs.lane_trace(j, b), tobs.lane_trace(t, b)
        _same_record(tobs.trim_admm_trace(tl, iters),
                     jobs.trim_admm_trace(jl, iters))
        got, want = (tobs.admm_trace_summary(tl, iters),
                     jobs.admm_trace_summary(jl, iters))
        _same_summary(got, want)
        if iters is None and ITERS[b] == 0:
            assert got == {"admm_iters": 0, "primal_first": None,
                           "primal_final": None, "dual_first": None,
                           "dual_final": None, "inner_total": 0}


def test_solver_trace_names():
    assert tobs.SolverTrace is TPGDTrace
    assert tobs.ADMMTrace is TADMMTrace
    from repro_torch.obs import solver_trace
    assert solver_trace.ADMMTrace is TADMMTrace
    with pytest.raises(AttributeError):
        solver_trace.NotARecord  # noqa: B018


# ---------------------------------------------------------------------------
# a traced replay in both packages
# ---------------------------------------------------------------------------

TENANTS = [("web", "diurnal", [8, 16, 4, 100.0], 1, 8.0),
           ("launch", "flash_crowd", [4, 8, 2, 50.0], 2, 16.0)]
TICKS = 3


def _specs(TenantSpec, make_trace):
    return [TenantSpec(name=name, trace=make_trace(kind, np.asarray(base),
                                                   TICKS, seed=seed),
                       delta_max=dm)
            for name, kind, base, seed, dm in TENANTS]


@pytest.fixture(scope="module")
def traced_pair():
    """Both packages replay the fleet with ``capture_solver_trace=True``;
    the port's cold start is fed the reference's starts."""
    jcat = jcore.Catalog(jcore.make_cloud_catalog().instances[::40])
    tcat = tcore.Catalog(tcore.make_cloud_catalog().instances[::40])
    starts = []

    def capture(batch, n_starts, seed=0):
        out = jfleet.make_fleet_starts(batch, n_starts, seed)
        starts.append(np.array(out))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jreplay, "make_fleet_starts", capture)
        ref = jfleet.replay_fleet(
            jcat, _specs(jfleet.TenantSpec, jfleet.make_trace),
            replay_mode="batched", run_ca_baseline=False,
            capture_solver_trace=True)
        fed = iter(starts)
        mp.setattr(treplay, "make_fleet_starts",
                   lambda batch, n_starts, seed=0: torch.as_tensor(next(fed)))
        port = tfleet.replay_fleet(
            tcat, _specs(tfleet.TenantSpec, tfleet.make_trace),
            replay_mode="batched", run_ca_baseline=False,
            capture_solver_trace=True, device="cpu")
        assert next(fed, None) is None
    return ref, port


def test_replay_trace_summaries(traced_pair):
    ref, port = traced_pair
    assert len(port.solver_traces) == len(ref.solver_traces) == len(TENANTS)
    for lr, lp, tenant in zip(ref.solver_traces, port.solver_traces,
                              port.tenants):
        assert len(lp) == len(lr) == TICKS - 1      # one per warm tick
        for rr, rp, step in zip(lr, lp, tenant.steps[1:]):
            got, want = tobs.trace_summary(rp), jobs.trace_summary(rr)
            assert got["iters"] == step.solver_iters > 0
            np.testing.assert_allclose(got["merit_first"],
                                       want["merit_first"], **FIRST_ROWS)
        dumped = tobs.traces_to_dict(lp)
        assert ([d["iters"] for d in dumped]
                == [s.solver_iters for s in tenant.steps[1:]])
