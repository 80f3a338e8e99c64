"""The reference's own branch-and-bound answer on the full-catalog
s4_memory under one-ulp changes of the problem: ``chip_smoke.py`` holds the
port's kernel and plain runs to this spread where they part (its
``REF_S4_BNB``), so the spread is reproduced here with the JAX package.

``optimize(use_bnb=True, n_starts=6, seed=0)`` as the reference runs it:
the multistart once, then ``branch_and_bound`` (the smoke's
``BNB_NODES`` nodes) from its best relaxed start on the problem with ``c``
or ``d`` scaled by 1 +- 2^-23, each answer eq. (1) at the committed counts
on the unchanged problem."""
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core.objective as jobj  # noqa: E402
from repro.core import api as japi  # noqa: E402
from repro.core.branch_bound import branch_and_bound  # noqa: E402
from repro.core.catalog import make_cloud_catalog  # noqa: E402
from repro.core.multistart import multistart_solve  # noqa: E402
from repro.core.scenarios import build_scenarios  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
UP, DOWN = np.float32(1 + 2.0 ** -23), np.float32(1 - 2.0 ** -23)
PERTURBATIONS = {"none": {}, "c+": {"c": UP}, "c-": {"c": DOWN},
                 "d+": {"d": UP}, "d-": {"d": DOWN}}


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke as module
    finally:
        sys.path.remove(str(ROOT))
    yield module
    sys.modules.pop("chip_smoke", None)


@pytest.fixture(scope="module")
def s4():
    catalog = make_cloud_catalog()
    scenario = {s.name: s for s in build_scenarios(catalog)}["s4_memory"]
    prob = japi.problem_from_scenario(catalog, scenario)
    return prob, multistart_solve(prob, n_starts=6, seed=0)


def _answer(prob, ms, scale, nodes):
    perturbed = prob._replace(**{k: getattr(prob, k) * s
                                 for k, s in scale.items()})
    bnb = branch_and_bound(perturbed, np.asarray(ms.best.x), max_nodes=nodes)
    x = np.asarray(ms.x_int) if float(ms.fun_int) < bnb.fun else bnb.x
    return float(jobj.objective(prob, jnp.asarray(x, jnp.float32)))


@pytest.mark.parametrize("name", list(PERTURBATIONS))
def test_reference_answer_under_one_ulp_change(name, s4, chip_smoke):
    prob, ms = s4
    got = _answer(prob, ms, PERTURBATIONS[name], chip_smoke.BNB_NODES)
    np.testing.assert_allclose(got, chip_smoke.REF_S4_BNB[name], rtol=1e-6)


def test_one_ulp_moves_the_reference_past_the_integer_tolerance(chip_smoke):
    """The spread the smoke's gate allows is one the reference shows: its
    answers on problems one ulp apart differ by more than TENANT_RTOL."""
    answers = sorted(set(chip_smoke.REF_S4_BNB.values()))
    assert chip_smoke.REF_S4_BNB["none"] == answers[0]
    assert (answers[-1] - answers[0]) / answers[0] > chip_smoke.TENANT_RTOL
