"""The port's numpy copies (catalog, traces, snapshot metrics) are pinned
bit-equal to the JAX reference's originals."""
import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core.catalog as jcat  # noqa: E402
import repro.core.metrics as jmet  # noqa: E402
import repro.fleet.traces as jtr  # noqa: E402
import repro_torch.core.catalog as tcat  # noqa: E402
import repro_torch.core.metrics as tmet  # noqa: E402
import repro_torch.fleet.traces as ttr  # noqa: E402


def _assert_catalogs_equal(a, b):
    assert [vars(i) for i in a.instances] == [vars(i) for i in b.instances]
    for x, y in zip(a.matrices(), b.matrices()):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("seed,n_per_provider", [(0, 940), (3, 57)])
def test_cloud_catalog_matrices_bit_equal(seed, n_per_provider):
    _assert_catalogs_equal(jcat.make_cloud_catalog(seed, n_per_provider),
                           tcat.make_cloud_catalog(seed, n_per_provider))


def test_tpu_and_spot_catalogs_bit_equal():
    _assert_catalogs_equal(jcat.make_tpu_catalog(), tcat.make_tpu_catalog())
    base_j = jcat.Catalog(jcat.make_cloud_catalog().instances[::40])
    base_t = tcat.Catalog(tcat.make_cloud_catalog().instances[::40])
    (cj, ij), (ct, it) = jcat.spot_catalog(base_j), tcat.spot_catalog(base_t)
    _assert_catalogs_equal(cj, ct)
    np.testing.assert_array_equal(ij, it)
    np.testing.assert_array_equal(jcat.spot_risk_prices(cj, ij),
                                  tcat.spot_risk_prices(ct, it))


@pytest.mark.parametrize("kind", ["diurnal", "flash_crowd", "ramp", "weekly",
                                  "constant", "spot_interruption"])
@pytest.mark.parametrize("seed", [0, 7])
def test_traces_bit_equal(kind, seed):
    base = np.array([8.0, 16.0, 4.0, 100.0])
    kw = {} if kind == "constant" else {"seed": seed}
    a = jtr.make_trace(kind, base, 50, **kw)
    b = ttr.make_trace(kind, base, 50, **kw)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


def test_trace_registry_rejects_unknown_kind():
    with pytest.raises(ValueError):
        ttr.make_trace("sawtooth", np.ones(4), 5)


def test_evaluate_equal():
    cat_j = jcat.Catalog(jcat.make_cloud_catalog().instances[::20])
    cat_t = tcat.Catalog(tcat.make_cloud_catalog().instances[::20])
    rng = np.random.default_rng(1)
    for _ in range(5):
        counts = rng.integers(0, 3, cat_j.n).astype(np.float64)
        demand = rng.uniform(1, 50, 4)
        assert (jmet.evaluate(cat_j, counts, demand).as_dict()
                == tmet.evaluate(cat_t, counts, demand).as_dict())
