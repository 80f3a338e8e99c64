"""Anytime deadlines through the port's replay stack, as
``tests/fleet/test_anytime_replay.py`` holds the reference's myopic
engines: ``replay_fleet(..., anytime=...)`` truncates warm solves in the
sequential and the batched engine, ``deadline_ms=None`` replays bit for
bit, and under the same fake clock the port commits the reference's counts
and deadline flags."""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the operands are tiny, and the suite runs its files
# in parallel workers, where extra threads only take cores from the others
torch.set_num_threads(1)

import repro.core as jcore  # noqa: E402
import repro.core.multistart as jms  # noqa: E402
import repro.fleet as jfleet  # noqa: E402
import repro.fleet.replay as jreplay  # noqa: E402
from repro.core.pgd import AnytimeConfig as JAnytime  # noqa: E402

import repro_torch.core as tcore  # noqa: E402
import repro_torch.core.multistart as tms  # noqa: E402
import repro_torch.fleet as tfleet  # noqa: E402
import repro_torch.fleet.replay as treplay  # noqa: E402
from repro_torch.core.pgd import AnytimeConfig  # noqa: E402

BASE = np.array([8.0, 16.0, 4.0, 100.0])
MODES = ["sequential", "batched"]


@pytest.fixture(scope="module")
def catalogs():
    return (jcore.Catalog(jcore.make_cloud_catalog().instances[::40]),
            tcore.Catalog(tcore.make_cloud_catalog().instances[::40]))


def _fleet(TenantSpec, make_trace, T=3):
    return [TenantSpec(name="a", n_starts=2,
                       trace=make_trace("diurnal", BASE, T)),
            TenantSpec(name="b", n_starts=2,
                       trace=make_trace("ramp", BASE * 0.6, T))]


def _tight(Config):
    """A deterministic config that truncates every warm solve: the fake
    clock burns 5 ms a reading against a 12 ms budget, so at most a couple
    of 4-iteration chunks fit."""
    fake = SimpleNamespace(t=0.0)

    def clock():
        fake.t += 5e-3
        return fake.t

    return Config(deadline_ms=12.0, chunk_iters=4, clock=clock)


def _port(tcat, mode, **kw):
    return tfleet.replay_fleet(tcat, _fleet(tfleet.TenantSpec,
                                            tfleet.make_trace),
                               replay_mode=mode, run_ca_baseline=False,
                               device="cpu", **kw)


def _counts(res):
    return [[s.counts for s in t.steps] for t in res.tenants]


@pytest.mark.parametrize("mode", MODES)
def test_deadline_truncates_warm_solves(catalogs, mode):
    res = _port(catalogs[1], mode, anytime=_tight(AnytimeConfig))
    for tr in res.tenants:
        cold, warm = tr.steps[0], tr.steps[1:]
        assert not cold.deadline_hit
        assert warm
        for s in warm:
            assert s.deadline_hit and 0 < s.solver_iters <= 12, (mode, s)


@pytest.mark.parametrize("mode", MODES)
def test_disabled_and_generous_deadlines_replay_bit_identical(catalogs,
                                                              mode):
    off = _port(catalogs[1], mode)
    for cfg in (AnytimeConfig(deadline_ms=None),
                AnytimeConfig(deadline_ms=1e9)):
        on = _port(catalogs[1], mode, anytime=cfg)
        for c_off, c_on in zip(_counts(off), _counts(on)):
            for a, b in zip(c_off, c_on):
                np.testing.assert_array_equal(a, b)
        assert not any(s.deadline_hit for t in on.tenants for s in t.steps)
        assert ([s.solver_iters for t in on.tenants for s in t.steps]
                == [s.solver_iters for t in off.tenants for s in t.steps])


@pytest.mark.parametrize("mode", MODES)
def test_anytime_rejects_capture_solver_trace(catalogs, mode):
    with pytest.raises(ValueError, match="mutually exclusive"):
        _port(catalogs[1], mode, capture_solver_trace=True,
              anytime=AnytimeConfig(deadline_ms=5.0))


def _reference_starts(monkeypatch, mode):
    """Feed the port's cold start the reference's starts (jax.random and
    torch.Generator draw differently)."""
    starts = []
    if mode == "batched":
        make = jfleet.make_fleet_starts

        def capture(batch, n_starts, seed=0):
            out = make(batch, n_starts, seed)
            starts.append(np.array(out))
            return out

        monkeypatch.setattr(jreplay, "make_fleet_starts", capture)
        fed = iter(starts)
        monkeypatch.setattr(treplay, "make_fleet_starts",
                            lambda batch, n_starts, seed=0:
                            torch.as_tensor(next(fed)))
    else:
        make = jms.make_starts

        def capture(prob, n_starts, seed=0):
            out = make(prob, n_starts, seed)
            starts.append(np.array(out))
            return out

        monkeypatch.setattr(jms, "make_starts", capture)
        fed = iter(starts)
        monkeypatch.setattr(tms, "make_starts",
                            lambda prob, n_starts, seed=0:
                            torch.as_tensor(next(fed)))
    return fed


@pytest.mark.parametrize("mode", MODES)
def test_truncated_replay_matches_reference(catalogs, monkeypatch, mode):
    """Same fleet, same fake clock: the reference and the port truncate
    the same warm solves at the same iteration counts and commit the same
    counts at every tenant-tick."""
    jcat, tcat = catalogs
    fed = _reference_starts(monkeypatch, mode)
    ref = jfleet.replay_fleet(jcat, _fleet(jfleet.TenantSpec,
                                           jfleet.make_trace),
                              replay_mode=mode, run_ca_baseline=False,
                              anytime=_tight(JAnytime))
    port = _port(tcat, mode, anytime=_tight(AnytimeConfig))
    assert next(fed, None) is None
    for tr, tp in zip(ref.tenants, port.tenants):
        for sr, sp in zip(tr.steps, tp.steps):
            assert sp.deadline_hit == sr.deadline_hit
            assert sp.solver_iters == sr.solver_iters
            np.testing.assert_array_equal(sp.counts, sr.counts)


def test_vmap_lanes_trace_and_budget_like_the_sequential_engine(catalogs):
    """``hot_loop="vmap"`` solves each lane alone: its traces are the
    sequential engine's bit for bit, and a generous budget changes no
    count."""
    tcat = catalogs[1]
    seq = _port(tcat, "sequential", capture_solver_trace=True)
    lanes = _port(tcat, "batched", hot_loop="vmap",
                  capture_solver_trace=True)
    for ls, lv in zip(seq.solver_traces, lanes.solver_traces):
        assert len(ls) == len(lv) == 2
        for a, b in zip(ls, lv):
            for f in a._fields:
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    budget = _port(tcat, "batched", hot_loop="vmap",
                   anytime=AnytimeConfig(deadline_ms=1e9, chunk_iters=8))
    tight = _port(tcat, "batched", hot_loop="vmap",
                  anytime=_tight(AnytimeConfig))
    for a, b, c in zip(seq.tenants, budget.tenants, tight.tenants):
        for sa, sb, sc in zip(a.steps, b.steps, c.steps):
            np.testing.assert_array_equal(sa.counts, sb.counts)
            assert sa.solver_iters == sb.solver_iters
            assert sc.deadline_hit == (not sc.replanned)
