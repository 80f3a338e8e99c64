"""Every ported subpackage exports the reference's names, in the
reference's order; and ``core.solve_incremental``, the last of ``core``'s
missing exports, is ``solve_incremental_info(...)[0]`` and agrees with the
reference's on a warm tick."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402

import repro_torch.core as tcore  # noqa: E402
from repro_torch.bridge import problem_arrays, problem_from_arrays  # noqa: E402
from repro_torch.core import objective as tobj  # noqa: E402
from repro_torch.core.pgd import PGDConfig  # noqa: E402

# names of the reference's __all__ still waiting in ROADMAP queue 1; empty
# for every subpackage checked here (``models`` and ``launch`` wait whole
# for queue 1, item 9, and are not checked)
PENDING = {"core": (), "fleet": (), "horizon": (), "serve": (), "obs": ()}
# names the port exports beyond the reference's __all__ (each lives in the
# reference's module of that name, unexported there)
PORT_ONLY = {"fleet": ("TenantReplay", "replay_tenant"),
             "horizon": ("stack_windows",)}

TOL = dict(rtol=1e-4, atol=1e-4)      # tests/kernels/test_kernels.py:32-33
BASE = np.array([8.0, 16.0, 4.0, 100.0])
DELTA = 64.0


@pytest.mark.parametrize("sub", sorted(PENDING))
def test_all_equals_the_reference(sub):
    ref = importlib.import_module(f"repro.{sub}")
    port = importlib.import_module(f"repro_torch.{sub}")
    want = [n for n in ref.__all__ if n not in PENDING[sub]]
    got = [n for n in port.__all__ if n not in PORT_ONLY.get(sub, ())]
    assert got == want
    for name in port.__all__:
        assert getattr(port, name) is not None, name
    assert set(PORT_ONLY.get(sub, ())) <= set(port.__all__)


def test_missing_core_exports_import():
    from repro_torch.core import (make_tpu_catalog, per_dim_utilization,
                                  solve_incremental)
    assert make_tpu_catalog().n == jcore.make_tpu_catalog().n
    cat = tcore.Catalog(tcore.make_cloud_catalog().instances[::40])
    counts = np.arange(cat.n, dtype=np.float64) % 3
    np.testing.assert_array_equal(
        per_dim_utilization(cat, counts, BASE),
        jcore.per_dim_utilization(
            jcore.Catalog(jcore.make_cloud_catalog().instances[::40]),
            counts, BASE))
    assert callable(solve_incremental)


@pytest.fixture(scope="module")
def warm_pair():
    """A warm tick: the reference's cold counts at the base demand, then
    three times the demand, the same problem in both packages."""
    jcat = jcore.Catalog(jcore.make_cloud_catalog().instances[::40])
    x_cur = np.array(jcore.multistart_solve(
        jcore.problem_from_demand(jcat, BASE), n_starts=4).x_int, np.float32)
    jp = jcore.problem_from_demand(jcat, BASE * 3.0)
    tp = problem_from_arrays(problem_arrays(jp), device="cpu")
    return jp, tp, x_cur


def test_solve_incremental_is_the_info_solution(warm_pair):
    _, tp, x_cur = warm_pair
    xc = torch.as_tensor(x_cur)
    x = tcore.solve_incremental(tp, xc, DELTA, steps=40)
    x_info, _ = tcore.solve_incremental_info(tp, xc, DELTA, steps=40)
    assert torch.equal(x, x_info)
    x_cfg = tcore.solve_incremental(tp, xc, DELTA,
                                    cfg=PGDConfig(max_iters=40))
    assert torch.equal(x, x_cfg)
    x_init = xc + 0.5
    assert torch.equal(
        tcore.solve_incremental(tp, xc, DELTA, x_init=x_init, steps=40),
        tcore.solve_incremental_info(tp, xc, DELTA, x_init=x_init,
                                     steps=40)[0])


@pytest.mark.parametrize("steps", [40, 600])
def test_solve_incremental_matches_reference(warm_pair, steps):
    jp, tp, x_cur = warm_pair
    xj = jcore.solve_incremental(jp, jnp.asarray(x_cur), jnp.float32(DELTA),
                                 steps=steps)
    xt = tcore.solve_incremental(tp, torch.as_tensor(x_cur), DELTA,
                                 steps=steps)
    fj = float(jcore.objective_value(jp, xj))
    ft = float(tobj.objective(tp, xt))
    if steps == 40:
        # inside the 48-iteration prefix where the trajectories agree
        # (tests/test_torch_anytime.py::test_traced_rows_match_reference)
        np.testing.assert_allclose(ft, fj, **TOL)
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), **TOL)
    else:
        # converged, each at its own iteration count: the same merit
        np.testing.assert_allclose(ft, fj, rtol=1e-3)
    churn = float(torch.sum(torch.abs(xt - torch.as_tensor(x_cur))))
    assert churn <= DELTA * (1 + 1e-5)
