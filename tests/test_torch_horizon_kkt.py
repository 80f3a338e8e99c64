"""KKT optimality of the port's horizon solutions (committed tick), through
the port's ``core.kkt.kkt_report`` — the port of
tests/horizon/test_kkt.py with its bounds: H = 1 with a slack churn bound
carries a near-exact certificate, H = 4 one bounded by the lookahead
forces' scale, and with every lookahead force off H = 4 tightens back to
the H = 1 bound; the ADMM engine carries the same certificates and, with
the coupling off, lands on the per-tick optima."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro_torch.horizon as th  # noqa: E402
from repro_torch.core import kkt_report, objective_value  # noqa: E402
from repro_torch.core.incremental import solve_incremental_info  # noqa: E402
from repro_torch.testing import make_toy_problem  # noqa: E402

SLACK_DELTA = 1e3
CFG = th.HorizonSolverConfig(steps=1200, tol=1e-7)
ADMM_CFG = th.HorizonSolverConfig(solver="admm", admm_iters=60,
                                  inner_steps=20)


def _window(seed: int, H: int):
    return [make_toy_problem(seed=seed + 3 * h, demand_scale=1.0 + 0.05 * h,
                             device="cpu") for h in range(H)]


def _committed(seed: int, H: int, coupling_w: float, cfg):
    probs = _window(seed, H)
    hp = th.expand_problems(probs, coupling_w=coupling_w)
    x_cur = torch.full((probs[0].n,), 1.0)
    X = th.solve_horizon(hp, x_cur, SLACK_DELTA, cfg=cfg)
    scale = float(probs[0].c.abs().max()) + 1.0
    return kkt_report(probs[0], X[0]), scale


def _assert_feasible(rep):
    assert float(rep.primal_lo) <= 0.05
    assert float(rep.primal_hi) <= 0.05
    assert float(rep.primal_box) <= 1e-5
    assert float(rep.dual) <= 1e-6
    assert float(rep.comp_slack) <= 0.05


@pytest.mark.parametrize("H,bound", [(1, 0.25), (4, 0.6)])
def test_committed_tick_certificate(H, bound):
    for seed in (0, 1, 5):
        rep, scale = _committed(seed, H, 0.05, CFG)
        assert float(rep.stationarity) <= bound * scale, (seed, rep)
        _assert_feasible(rep)


def test_h4_zero_coupling_recovers_h1_certificate():
    cfg = CFG._replace(delta_penalty_w=0.0, penalty_w=0.0)
    for seed in (0, 5):
        rep, scale = _committed(seed, 4, 0.0, cfg)
        assert float(rep.stationarity) <= 0.3 * scale, (seed, rep)
        assert float(rep.primal_lo) <= 0.05
        assert float(rep.primal_hi) <= 0.05


def test_admm_h4_committed_tick_stationarity_bounded():
    for seed in (0, 1, 5):
        rep, scale = _committed(seed, 4, 0.05, ADMM_CFG)
        assert float(rep.stationarity) <= 0.6 * scale, (seed, rep)
        _assert_feasible(rep)


def test_admm_zero_coupling_converges_to_per_tick_optima():
    """g == 0: each outer iteration is a proximal-point step on its own
    tick, so ADMM lands on each tick's solo optimum (the reference's
    bounds: merit within 1e-3, allocation within 0.05)."""
    seeds = [1, 3, 18, 27]
    probs = [make_toy_problem(seed=s, device="cpu") for s in seeds]
    hp = th.expand_problems(probs, coupling_w=0.0)
    x_cur = torch.zeros(hp.n)
    cfg = ADMM_CFG._replace(rho=0.02, admm_iters=40, inner_steps=25,
                            penalty_w=0.0, delta_penalty_w=0.0, admm_tol=0.0)
    X = th.solve_horizon(hp, x_cur, SLACK_DELTA, cfg=cfg)
    for h, prob in enumerate(probs):
        x_ref, _ = solve_incremental_info(prob, x_cur, SLACK_DELTA)
        J_admm = float(objective_value(prob, X[h]))
        J_ref = float(objective_value(prob, x_ref))
        assert J_admm <= J_ref + 1e-3, (h, J_admm, J_ref)
        assert float((X[h] - x_ref).abs().max()) <= 0.05, h
