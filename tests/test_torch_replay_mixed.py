"""The port's batched fleet replay against the JAX reference's on a mixed
fleet, on the CPU, from the same starts: five tenants over ragged horizons
of 2 to 4 ticks, one on a second catalog, one restricted to approved types
(``allowed_idx``), one whose spot pools are interrupted at ticks 1 to 3.

With ``warm_start="counts"`` every committed count and cost integral must
be the reference's. ``"relaxed"`` starts each tick from the previous tick's
relaxed solution, which the reference calls "an optimization knob, not an
equivalence mode" (tests/fleet/test_replay.py:214): the float32 rounding of
that solution (XLA's and PyTorch's sums differ in order) reaches the next
rounding. On this fleet it tips one near-tied rounding, the second
catalog's tenant from tick 2 on; every other tenant must commit the
reference's counts at every tick, and that tenant must commit what the
reference itself commits when its cold starts are scaled by 1 + 5e-7."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the operands are tiny, and the suite runs its files
# in parallel workers, where extra threads only take cores from the others
torch.set_num_threads(1)

import repro.core as jcore  # noqa: E402
import repro.core.catalog as jcatalog  # noqa: E402
import repro.fleet as jfleet  # noqa: E402
import repro.fleet.replay as jreplay  # noqa: E402

import repro_torch.core as tcore  # noqa: E402
import repro_torch.core.catalog as tcatalog  # noqa: E402
import repro_torch.fleet as tfleet  # noqa: E402
import repro_torch.fleet.replay as treplay  # noqa: E402

# name, trace kind, base demand, trace seed, ticks, delta_max
TENANTS = [("web", "diurnal", [8, 16, 4, 100.0], 1, 4, 8.0),
           ("launch", "flash_crowd", [4, 8, 2, 50.0], 2, 3, 16.0),
           ("other-catalog", "ramp", [6, 24, 3, 150.0], 3, 4, 8.0),
           ("approved", "weekly", [16, 64, 6, 300.0], 4, 2, 8.0),
           ("spot", "diurnal", [10, 20, 5, 120.0], 5, 4, 8.0)]


def _fleet(pkg, catalog_mod, fleet_pkg):
    """The fleet catalog (a tenth of the cloud catalog's types and a spot
    twin of each) and the five tenants, built from one package's copies."""
    cloud = pkg.make_cloud_catalog()
    cat, spot_idx = catalog_mod.spot_catalog(pkg.Catalog(cloud.instances[::40]))
    second = pkg.Catalog(cloud.instances[13::40])
    rng = np.random.default_rng(7)
    avail = np.ones((4, len(spot_idx)))
    for t in (1, 2, 3):                 # half the pools down at ticks 1-3
        avail[t, rng.choice(len(spot_idx), len(spot_idx) // 2,
                            replace=False)] = 0.0
    specs = []
    for name, kind, base, seed, ticks, dm in TENANTS:
        extra = {}
        if name == "other-catalog":
            extra = dict(catalog=second)
        elif name == "approved":
            extra = dict(allowed_idx=np.arange(0, cat.n, 3))
        elif name == "spot":
            extra = dict(spot_idx=spot_idx, spot_availability=avail)
        specs.append(fleet_pkg.TenantSpec(
            name=name, trace=fleet_pkg.make_trace(kind, np.asarray(base),
                                                  ticks, seed=seed),
            delta_max=dm, **extra))
    return cat, specs


NEAR_TIE, TIE_TICK = 2, 2      # the second catalog's tenant, from tick 2
WITNESS_SCALE = 1.0 + 5e-7     # float32-level move of the reference's starts


def _reference(warm_start, scale=1.0):
    """The reference's replay, its cold starts scaled by ``scale``, and the
    starts its cold tick drew."""
    starts = []
    make_starts = jfleet.make_fleet_starts

    def capture(batch, n_starts, seed=0):
        out = make_starts(batch, n_starts, seed) * scale
        starts.append(np.array(out))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jreplay, "make_fleet_starts", capture)
        jcat, jspecs = _fleet(jcore, jcatalog, jfleet)
        out = jfleet.replay_fleet(jcat, jspecs, replay_mode="batched",
                                  hot_loop="ref", run_ca_baseline=False,
                                  warm_start=warm_start)
    return out, starts


def _port(warm_start, starts):
    """The port's replay, its cold tick fed ``starts`` (jax.random draws
    differ from torch.Generator's)."""
    fed = iter(starts)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(treplay, "make_fleet_starts",
                   lambda batch, n_starts, seed=0: torch.as_tensor(next(fed)))
        tcat, tspecs = _fleet(tcore, tcatalog, tfleet)
        out = tfleet.replay_fleet(tcat, tspecs, replay_mode="batched",
                                  run_ca_baseline=False,
                                  warm_start=warm_start, device="cpu")
    assert next(fed, None) is None
    return out, tspecs


@pytest.fixture(scope="module")
def replays():
    """Both packages' replays under both warm starts (each file runs in one
    worker, so the four replays run once for the two tests)."""
    out = {}
    for warm_start in ("counts", "relaxed"):
        ref, starts = _reference(warm_start)
        out[warm_start] = (ref, *_port(warm_start, starts))
    return out


def _other_counts(a, b):
    """(tenant, tick) pairs where replays ``a`` and ``b`` commit different
    counts."""
    return {(i, t) for i, (ta, tb) in enumerate(zip(a.tenants, b.tenants))
            for t, (sa, sb) in enumerate(zip(ta.steps, tb.steps))
            if not np.array_equal(sa.counts, sb.counts)}


def _check_overlays(port, specs):
    """Approved types only; interrupted spot pools empty; the second
    catalog's tenant solved at its own width."""
    approved, spot = port.tenants[3], port.tenants[4]
    banned = np.setdiff1d(np.arange(len(approved.steps[0].counts)),
                          specs[3].allowed_idx)
    assert all(np.all(s.counts[banned] == 0.0) for s in approved.steps)
    avail, spot_idx = specs[4].spot_availability, specs[4].spot_idx
    for t, step in enumerate(spot.steps):
        assert np.all(step.counts[spot_idx[avail[t] <= 0.0]] == 0.0)
    assert len(port.tenants[2].steps[0].counts) != len(spot.steps[0].counts)


def test_mixed_fleet_matches_reference_counts_warm_start(replays):
    ref, port, specs = replays["counts"]
    assert ([len(t.steps) for t in port.tenants]
            == [len(t.steps) for t in ref.tenants] == [4, 3, 4, 2, 4])
    assert _other_counts(port, ref) == set()
    for tr, tp in zip(ref.tenants, port.tenants):
        assert tp.metrics.cost_integral == tr.metrics.cost_integral
    _check_overlays(port, specs)


def test_mixed_fleet_matches_reference_relaxed_warm_start(replays):
    ref, port, specs = replays["relaxed"]
    assert ([len(t.steps) for t in port.tenants]
            == [len(t.steps) for t in ref.tenants] == [4, 3, 4, 2, 4])
    # the reference's counts everywhere but at the one near tie
    assert _other_counts(port, ref) <= {(NEAR_TIE, t) for t in
                                        range(TIE_TICK, 4)}
    for i, (tr, tp) in enumerate(zip(ref.tenants, port.tenants)):
        if i != NEAR_TIE:
            assert tp.metrics.cost_integral == tr.metrics.cost_integral
    # there the reference, its starts moved at float32's level, commits
    # the port's counts at every tick and its cost integral
    witness, _ = _reference("relaxed", scale=WITNESS_SCALE)
    assert not any(i == NEAR_TIE for i, _ in _other_counts(port, witness))
    assert (port.tenants[NEAR_TIE].metrics.cost_integral
            == witness.tenants[NEAR_TIE].metrics.cost_integral)
    # the relaxed start is carried: where the reference's relaxed replay
    # leaves its counts replay, the port's leaves its own
    ref_moves = _other_counts(ref, replays["counts"][0])
    assert ref_moves
    assert ref_moves <= _other_counts(port, replays["counts"][1])
    _check_overlays(port, specs)
