"""The port's observability tools on the card: ``python -m
repro_torch.tools.trace_demo`` exits 0 there, the solver-trace helpers take
records of CUDA tensors and return what they return for the same record on
the CPU, and the provenance block names the card. These tests import no
JAX; without a CUDA device they skip. On a machine with a card:

    python -m pytest -q --noconftest -m cuda tests/test_torch_obs_cuda.py
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.obs as tobs  # noqa: E402
from repro_torch.core.pgd import PGDTrace  # noqa: E402
from repro_torch.fleet import solve_fleet, solve_fleet_step, stack_problems  # noqa: E402
from repro_torch.horizon.admm import ADMMTrace  # noqa: E402
from repro_torch.testing import make_toy_problem  # noqa: E402

pytestmark = pytest.mark.cuda
ROOT = Path(__file__).resolve().parents[1]
B, L = 4, 12
ITERS = (L, 7, 3, 0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the tools run the card's kernels)")
    return torch.device("cuda")


def _records(seed=0):
    """A (B, L) PGD record and an ADMM record with the engines' sentinels
    past each lane's iterations, as CPU tensors."""
    rng = np.random.default_rng(seed)
    nan = lambda: np.full((B, L), np.nan, np.float32)
    merit, step, move, primal, dual = nan(), nan(), nan(), nan(), nan()
    accepted = np.zeros((B, L), bool)
    rung = np.full((B, L), -1, np.int32)
    inner = np.full((B, L), -1, np.int32)
    for b, k in enumerate(ITERS):
        merit[b, :k] = np.sort(rng.uniform(1.0, 5.0, k))[::-1]
        step[b, :k] = rng.uniform(0.01, 1.0, k)
        acc = rng.random(k) < 0.7
        accepted[b, :k] = acc
        rung[b, :k] = np.where(acc, rng.integers(0, 12, k), -1)
        move[b, :k] = np.where(acc, rng.uniform(0.0, 3.0, k), 0.0)
        primal[b, :k] = rng.uniform(0.01, 1.0, k)
        dual[b, :k] = rng.uniform(0.01, 1.0, k)
        inner[b, :k] = rng.integers(1, 40, k)
    t = torch.from_numpy
    return (PGDTrace(t(merit), t(step), t(accepted), t(rung), t(move)),
            ADMMTrace(t(primal), t(dual), t(inner)))


def _on(rec, dev):
    return type(rec)(*(f.to(dev) for f in rec))


def _same(got, want):
    if isinstance(want, tuple):           # a record of numpy rows
        assert type(got) is type(want)
        for g, w in zip(got, want):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    else:
        assert got == want


def test_trace_helpers_take_cuda_records(cuda):
    pgd, admm = _records()
    pgd_d, admm_d = _on(pgd, cuda), _on(admm, cuda)
    assert tobs.trace_length(pgd_d) == tobs.trace_length(pgd) == L
    for b in range(B):
        for cpu_rec, dev_rec in ((pgd, pgd_d), (admm, admm_d)):
            _same(tobs.lane_trace(dev_rec, b), tobs.lane_trace(cpu_rec, b))
        # single-lane records of CUDA tensors
        lane_d = type(pgd)(*(f[b] for f in pgd_d))
        lane = tobs.lane_trace(pgd, b)
        _same(tobs.trim_trace(lane_d), tobs.trim_trace(lane))
        _same(tobs.trace_summary(lane_d), tobs.trace_summary(lane))
        assert tobs.trace_summary(lane_d)["iters"] == ITERS[b]
        admm_lane_d = type(admm)(*(f[b] for f in admm_d))
        admm_lane = tobs.lane_trace(admm, b)
        _same(tobs.trim_admm_trace(admm_lane_d),
              tobs.trim_admm_trace(admm_lane))
        _same(tobs.admm_trace_summary(admm_lane_d),
              tobs.admm_trace_summary(admm_lane))
    with pytest.raises(ValueError, match="single-lane"):
        tobs.lane_trace(type(pgd)(*(f[0] for f in pgd_d)), 0)
    lanes_d = [type(pgd)(*(f[b] for f in pgd_d)) for b in range(B)]
    lanes = [tobs.lane_trace(pgd, b) for b in range(B)]
    assert tobs.traces_to_dict(lanes_d) == tobs.traces_to_dict(lanes)


def test_fleet_step_trace_on_the_card(cuda):
    """A traced warm fleet step through the kernel: each lane's summary
    counts the iterations the step reports for it."""
    probs = [make_toy_problem(seed=s, n=16 + 4 * (s % 2), m=3, device=cuda)
             for s in range(3)]
    batch = stack_problems(probs, device=cuda)
    cold = solve_fleet(batch, n_starts=2, device=cuda)
    res = solve_fleet_step(batch, cold.x_int, 8.0, capture_trace=True,
                           device=cuda)
    assert res.trace.merit.is_cuda
    iters = res.iters.cpu().numpy()
    for b in range(len(probs)):
        s = tobs.trace_summary(tobs.lane_trace(res.trace, b))
        assert s["iters"] == int(iters[b]) > 0
        assert np.isfinite(s["merit_final"])


def test_provenance_block_names_the_card(cuda):
    prov = tobs.provenance_block(argv=[], device=cuda)
    assert prov["backend"] == "cuda"
    assert prov["device"] == torch.cuda.get_device_name(0)
    assert prov["cuda"] == torch.version.cuda
    assert prov["power_limit"] is None or prov["power_limit"].endswith("W")
    assert tobs.provenance_block(device="cpu")["device"] is None


def test_trace_demo_exits_0_on_the_card(cuda, tmp_path):
    out = tmp_path / "trace.json"
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.tools.trace_demo", "--out",
         str(out)], capture_output=True, text=True, timeout=900, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert run.returncode == 0, run.stdout + run.stderr
    assert "on cuda" in run.stdout and "OK" in run.stdout
    assert tobs.validate_chrome_trace(out) == []
    assert tobs.validate_jsonl(out.with_suffix(".jsonl")) == []
