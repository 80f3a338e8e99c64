"""The port's control loop against the JAX reference's on the CPU:
``InfrastructureOptimizationController.step`` (cold multistart, then warm
incremental ticks) from the reference's starts, the churn bound,
``replan_on_failure``, and the pinned copies ``core.workloads`` and
``testing.make_toy_problem``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the operands are tiny, and the suite runs its files
# in parallel workers, where extra threads only take cores from the others
torch.set_num_threads(1)

import repro.core as jcore  # noqa: E402
import repro.core.multistart as jms  # noqa: E402
import repro.core.workloads as jwl  # noqa: E402
from repro.testing import make_toy_problem as j_toy  # noqa: E402

import repro_torch.core as tcore  # noqa: E402
import repro_torch.core.multistart as tms  # noqa: E402
import repro_torch.core.workloads as twl  # noqa: E402
from repro_torch.bridge import problem_arrays  # noqa: E402
from repro_torch.testing import make_toy_problem as t_toy  # noqa: E402

INT_RTOL = 0.05                       # tests/fleet/test_solve_fleet.py:112-117
BASE = np.array([8.0, 16.0, 4.0, 100.0])
DEMANDS = [BASE, BASE * 1.1, BASE * 0.8, BASE * 1.4]


@pytest.fixture(scope="module")
def catalogs():
    return (jcore.Catalog(jcore.make_cloud_catalog().instances[::40]),
            tcore.Catalog(tcore.make_cloud_catalog().instances[::40]))


def _controllers(catalogs, **kw):
    jcat, tcat = catalogs
    return (jcore.InfrastructureOptimizationController(catalog=jcat, **kw),
            tcore.InfrastructureOptimizationController(catalog=tcat,
                                                       device="cpu", **kw))


@pytest.fixture(scope="module")
def stepped(catalogs):
    """Both controllers stepped through the same demands, the port's cold
    tick fed the reference's multistart starts."""
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
    jc, tc = _controllers(catalogs, delta_max=5.0, n_starts=2)
    steps = [(jc.step(d), tc.step(d)) for d in DEMANDS]
    mp.undo()
    return jc, tc, steps


@pytest.mark.parametrize("tick", range(len(DEMANDS)))
def test_step_matches_reference(stepped, tick):
    _, _, steps = stepped
    sj, st = steps[tick]
    assert st.replanned == sj.replanned == (tick == 0)
    assert st.metrics.satisfied == sj.metrics.satisfied
    np.testing.assert_allclose(st.metrics.total_cost, sj.metrics.total_cost,
                               rtol=INT_RTOL)
    np.testing.assert_array_equal(st.counts, np.round(st.counts))
    assert st.counts.dtype == np.float64
    np.testing.assert_array_equal(st.demand, DEMANDS[tick])
    if tick:
        assert st.solver_iters > 0
        assert st.churn_violation == max(0.0, st.churn - 5.0)
    else:
        assert st.solver_iters == 0 and st.churn_violation == 0.0


def test_controller_state_after_steps(stepped):
    jc, tc, steps = stepped
    assert len(tc.history) == len(DEMANDS)
    np.testing.assert_array_equal(tc.x_current, steps[-1][1].counts)
    assert tc.last_x_rel.shape == tc.x_current.shape
    assert tc.total_cost() == sum(s.metrics.total_cost for s in tc.history)
    assert tc.total_churn() == sum(s.churn for s in tc.history)
    np.testing.assert_allclose(tc.total_cost(), jc.total_cost(),
                               rtol=INT_RTOL)


def test_controller_churn_bounded(catalogs):
    """tests/core/test_bnb_controller.py:33-46 (slow there)."""
    _, tc = _controllers(catalogs, delta_max=5.0, n_starts=2)
    first = tc.step(BASE)
    assert first.metrics.satisfied
    second = tc.step(BASE * 1.1)
    assert second.metrics.satisfied
    assert second.churn <= 5.0 + 8.0  # delta + rounding slack


def test_controller_failure_replan(catalogs):
    """tests/core/test_bnb_controller.py:49-60 (slow there): half the fleet
    dies; the replan relaxes the churn bound by the failure, then puts it
    back."""
    _, tc = _controllers(catalogs, delta_max=4.0, n_starts=2)
    d = np.array([16, 32, 8, 200], np.float64)
    with pytest.raises(RuntimeError, match="no allocation yet"):
        tc.replan_on_failure(np.ones(tc.catalog.n), d)
    tc.step(d)
    failed = np.ceil(tc.x_current * 0.5)
    st = tc.replan_on_failure(failed, d)
    assert st.metrics.satisfied
    assert not st.replanned
    assert tc.delta_max == 4.0
    assert len(tc.history) == 2


def test_warm_step_takes_an_initial_point(catalogs):
    """step(x_init=...) warm-starts the incremental solve from it; from the
    current counts it is the plain step."""
    _, a = _controllers(catalogs, delta_max=5.0, n_starts=2)
    _, b = _controllers(catalogs, delta_max=5.0, n_starts=2)
    a.step(BASE)
    b.step(BASE)
    sa = a.step(BASE * 1.1)
    sb = b.step(BASE * 1.1, x_init=b.x_current)
    np.testing.assert_array_equal(sa.counts, sb.counts)


def test_plain_switch_equals_default_on_the_cpu(catalogs):
    _, a = _controllers(catalogs, delta_max=5.0, n_starts=2)
    b = tcore.InfrastructureOptimizationController(
        catalog=catalogs[1], delta_max=5.0, n_starts=2, device="cpu",
        use_kernel=False)
    for d in DEMANDS[:2]:
        np.testing.assert_array_equal(a.step(d).counts, b.step(d).counts)


# ---------------------------------------------------------------------------
# the pinned copies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(seed=0), dict(seed=1), dict(seed=7, m=4, n=37, p=3),
    dict(seed=2, alpha=0.1, beta3=3.0, demand_scale=2.5, gamma=0.01)])
def test_make_toy_problem_equals_reference(kw):
    a = problem_arrays(j_toy(**kw))
    b = problem_arrays(t_toy(**kw, device="cpu"))
    assert a.keys() == b.keys()
    for k in a:
        if k == "params":
            for f in a[k]:
                np.testing.assert_array_equal(b[k][f], a[k][f])
        else:
            np.testing.assert_array_equal(b[k], a[k])


JOBS = [dict(name="j", hlo_flops=197e12 * 100, hlo_bytes=1e12,
             collective_bytes=50e9, bytes_per_device=8e9, devices=256,
             step_budget_s=1.0, host_ram_gb=64),
        dict(name="k", hlo_flops=3.3e15, hlo_bytes=2e11,
             collective_bytes=7e8, bytes_per_device=1.5e10, devices=64,
             step_budget_s=0.25)]
RECORDS = [{"cell": "x__train_4k", "flops": 1e12, "bytes_accessed": 1e11,
            "collective_bytes": 1e10, "bytes_per_device": 4e9,
            "devices": 256},
           {"flops": 5e14, "devices": 8}]


@pytest.mark.parametrize("job", JOBS)
def test_demand_from_job_equals_reference(job):
    np.testing.assert_array_equal(twl.demand_from_job(twl.JobSpec(**job)),
                                  jwl.demand_from_job(jwl.JobSpec(**job)))


@pytest.mark.parametrize("budget", [1.0, 0.5])
def test_dryrun_demand_equals_reference(budget):
    for rec in RECORDS:
        np.testing.assert_array_equal(
            twl.demand_from_dryrun_record(rec, budget),
            jwl.demand_from_dryrun_record(rec, budget))
    np.testing.assert_array_equal(twl.fleet_demand(RECORDS, budget),
                                  jwl.fleet_demand(RECORDS, budget))
    assert (twl.PEAK_FLOPS_BF16, twl.HBM_BW, twl.ICI_LINK_BW) == (
        jwl.PEAK_FLOPS_BF16, jwl.HBM_BW, jwl.ICI_LINK_BW)
    assert tcore.workloads is twl
