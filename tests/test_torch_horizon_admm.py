"""The port's consensus-ADMM horizon engine on the CPU, against the
reference's on the same windows and within the port.

The reference's own residual histories are the yardstick: on these
windows (tests/horizon/test_admm_parity.py's) the reference's primal
residual ends at 0.018-0.16 of its start, and at H = 16, seed 1 only at
0.29x, past its own test's 0.25x bound (that test fails in the reference).
So the port is held to the reference's histories, not to that bound: the
same outer-iteration count, the first rows equal to rtol 1e-3, and a
final residual no worse than the reference's worst final share on these
windows with room for rounding (0.35x primal, 0.25x dual).

Past row 6-10 float32 rounding parts the two, as it parts the reference
from itself: its one-ulp twins (d or c scaled by 1 +- 2^-23) part from it
at the same rows and by as much (up to 6x in a row). So the tail, rows
TAIL_FROM on, is held to those twins: the port's mean tail residual lies
within the span of the twins' mean tail residuals, widened by TAIL_SLACK
either way. Readings: the port sits inside the span in 11 of 12 (H, seed,
primal | dual) cases; H = 16, seed 1's primal is 5.6% above the twins'
largest (0.0668 against 0.0633)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import repro.horizon as jh  # noqa: E402
from repro.testing import make_toy_problem as jtoy  # noqa: E402

import repro_torch.horizon as th  # noqa: E402
from repro_torch.bridge import horizon_arrays, horizon_from_arrays  # noqa: E402
from repro_torch.horizon.solver import _horizon_merit_fns, _window  # noqa: E402

ADAPTIVE = dict(solver="adaptive", steps=600)
ADMM = dict(solver="admm", admm_iters=30, inner_steps=20)
DELTA = 8.0
HEAD_ROWS, HEAD_RTOL = 6, 1e-3
PRIMAL_SHARE, DUAL_SHARE = 0.35, 0.25
TAIL_FROM, TAIL_SLACK = 10, 1.1
ULP_UP, ULP_DOWN = np.float32(1 + 2.0 ** -23), np.float32(1 - 2.0 ** -23)
TWINS = (("d", ULP_UP), ("d", ULP_DOWN), ("c", ULP_UP), ("c", ULP_DOWN))


def _pair(seed: int, H: int):
    jhp = jh.expand_problems([jtoy(seed=seed + 3 * h,
                                   demand_scale=1.0 + 0.05 * h)
                              for h in range(H)])
    return jhp, horizon_from_arrays(horizon_arrays(jhp), "cpu")


@pytest.mark.parametrize("H", [4, 16])
def test_residual_histories_follow_the_reference(H):
    for seed in (0, 1, 2):
        jhp, thp = _pair(seed, H)
        xc = np.full(thp.n, 1.0, np.float32)
        rj = jh.solve_horizon_info(jhp, jnp.asarray(xc), DELTA,
                                   cfg=jh.HorizonSolverConfig(**ADMM),
                                   capture_trace=True)
        rt = th.solve_horizon_info(thp, torch.as_tensor(xc), DELTA,
                                   cfg=th.HorizonSolverConfig(**ADMM),
                                   capture_trace=True)
        assert isinstance(rt.trace, th.ADMMTrace)
        assert isinstance(rt.diag, th.ADMMDiag)
        pj, dj = jh.admm_residual_history(rj.trace)
        pt, dt = th.admm_residual_history(rt.trace)
        assert len(pt) == len(pj) == int(rt.diag.admm_iters)
        np.testing.assert_allclose(pt[:HEAD_ROWS], pj[:HEAD_ROWS],
                                   rtol=HEAD_RTOL)
        np.testing.assert_allclose(dt[:HEAD_ROWS], dj[:HEAD_ROWS],
                                   rtol=HEAD_RTOL)
        assert pt[-1] <= PRIMAL_SHARE * pt[0], (H, seed, pt, pj)
        assert dt[-1] <= DUAL_SHARE * dt[0], (H, seed, dt, dj)
        # the tail within the reference's own one-ulp spread
        tails = [(pj[TAIL_FROM:].mean(), dj[TAIL_FROM:].mean())]
        for leaf, f in TWINS:
            twin = jhp._replace(problem=jhp.problem._replace(
                **{leaf: getattr(jhp.problem, leaf) * f}))
            r = jh.solve_horizon_info(twin, jnp.asarray(xc), DELTA,
                                      cfg=jh.HorizonSolverConfig(**ADMM),
                                      capture_trace=True)
            tails.append([h[TAIL_FROM:].mean()
                          for h in map(np.asarray,
                                       jh.admm_residual_history(r.trace))])
        lo, hi = np.min(tails, 0) / TAIL_SLACK, np.max(tails, 0) * TAIL_SLACK
        got = (pt[TAIL_FROM:].mean(), dt[TAIL_FROM:].mean())
        assert np.all((lo <= got) & (got <= hi)), (H, seed, got, tails)
        # the trace's last row is the certificate the untraced path gauges
        assert np.isclose(pt[-1], float(rt.diag.primal_res), atol=1e-6)
        assert np.isclose(dt[-1], float(rt.diag.dual_res), atol=1e-6)
        inner = rt.trace.inner[:len(pt)]
        assert bool((inner > 0).all())
        assert bool((rt.trace.inner[len(pt):] == -1).all())


@pytest.mark.parametrize("H", [4, 8])
def test_admm_and_adaptive_agree_at_equal_budget(H):
    """The two engines minimize one program: at matched per-tick compute
    the window merits lie within the reference's 0.15 relative gap, and
    the committed ticks round within one unit of each other, as in the
    reference (tests/horizon/test_admm_parity.py)."""
    for seed in (0, 2):
        _, thp = _pair(seed, H)
        xc = torch.full((thp.n,), 1.0)
        ra = th.solve_horizon_info(thp, xc, DELTA,
                                   cfg=th.HorizonSolverConfig(**ADAPTIVE))
        rm = th.solve_horizon_info(thp, xc, DELTA,
                                   cfg=th.HorizonSolverConfig(**ADMM))
        W = _window(th.problem.map_problem(thp.problem, lambda a: a[None]),
                    thp.coupling_w, thp.coupling_eps, 1, H)
        cfg = th.HorizonSolverConfig()
        merit = _horizon_merit_fns(W, xc[None], torch.tensor([DELTA]),
                                   cfg.penalty_w, cfg.delta_penalty_w)[0]
        Ja, Jm = float(merit(ra.plan[None])), float(merit(rm.plan[None]))
        assert abs(Jm - Ja) / (1.0 + abs(Ja)) <= 0.15, (H, seed, Ja, Jm)
        p0 = th.tick_problem(thp, 0)
        ia = th.round_committed(p0, ra.plan[0], True)
        im = th.round_committed(p0, rm.plan[0], True)
        assert float((ia - im).abs().max()) <= 1.0
