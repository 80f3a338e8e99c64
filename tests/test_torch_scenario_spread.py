"""The reference's own answer for the priority-class scenario fleet's
tenant 2 under one-ulp changes of its demand: ``chip_smoke.py`` holds a
scenario replay whose kernel run parts from its plain run to the answers
the plain replay's one-ulp demand twins reach (``ULP_STEPS``), and the
priority fleet's tenant 2 is where it parts. This shows, with the JAX
package, that the reference's own answer there moves past the integer
tolerance under such a change.

The fleet is the smoke's (``scenario_base_specs``, built here with the
reference's ``TenantSpec`` and ``make_trace``, priced by its
``with_priority_classes``) on the full catalog (n = 1880). Tenant 2 is
replayed alone by the reference's sequential engine (``replay_tenant``,
CA off), with its trace scaled by 1 + k 2^-23 for k = 0 and each of
``ULP_STEPS``; each answer is the tenant's cost integral."""
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import make_cloud_catalog  # noqa: E402
from repro.fleet import TenantSpec, make_trace  # noqa: E402
from repro.fleet.replay import replay_tenant  # noqa: E402
from repro.fleet.scenarios import with_priority_classes  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TENANT = 2
# the reference's cost integral ($/hr summed over the ticks) by k
REF_TENANT2 = {0: 27.866350430995226, 1: 27.866350430995226,
               -1: 34.00226056948304}


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
def answers(chip_smoke):
    catalog = make_cloud_catalog()
    fleet = with_priority_classes(
        chip_smoke.scenario_base_specs(TenantSpec, make_trace),
        chip_smoke.SCENARIO_PRIORITIES, catalog=catalog,
        eviction_price=chip_smoke.EVICTION_PRICE)
    spec = fleet[TENANT]
    assert chip_smoke.SCENARIO_PRIORITIES[TENANT] == "batch"
    out = {}
    for k in (0,) + tuple(chip_smoke.ULP_STEPS):
        scale = 1 + k * 2.0 ** -23
        twin = replace(spec, trace=np.asarray(spec.trace) * scale)
        out[k] = replay_tenant(catalog, twin,
                               run_ca_baseline=False).metrics.cost_integral
    return out


@pytest.mark.parametrize("k", sorted(REF_TENANT2))
def test_reference_answer_under_one_ulp_demand_change(k, answers):
    np.testing.assert_allclose(answers[k], REF_TENANT2[k], rtol=1e-6)


def test_one_ulp_moves_the_reference_past_the_tenant_tolerance(answers,
                                                               chip_smoke):
    """The spread the smoke's fallback allows is one the reference shows:
    its answers for demands one ulp apart differ by more than
    TENANT_RTOL."""
    lo, hi = min(answers.values()), max(answers.values())
    assert (hi - lo) / lo > chip_smoke.TENANT_RTOL
