"""Convergence traces from the shared PGD engine, and helpers to read them —
port of ``repro.obs.solver_trace``.

The capture itself lives in the engine (``repro_torch.core.pgd``): an
opt-in, fixed-size per-iteration log written on the device, one row set
per lane of a stacked solve. This module re-exports that record as
:data:`SolverTrace` and provides the host-side analysis helpers: trimming
the fixed-size arrays to the iterations actually taken, slicing one lane
out of a batched capture, and summarising a trajectory for reports.

Schema (one row per PGD iteration, ``L = PGDConfig.max_iters`` rows total;
rows at index >= iters hold sentinels — NaN / False / -1):

========  =======  ====================================================
field     dtype    meaning
========  =======  ====================================================
merit     float32  objective value after the iteration's accepted point
step      float32  Barzilai-Borwein base step proposed this iteration
accepted  bool     True if any Armijo ladder rung passed
rung      int32    index of the accepted backtracking rung (-1 = none)
move      float32  max|dx| of the accepted move (0 when rejected)
========  =======  ====================================================

The ADMM horizon engine (``repro_torch.horizon.admm``) records a second
schema, :data:`ADMMTrace` (one row per OUTER consensus iteration:
primal/dual residual pair + inner PGD iterations spent), re-exported here
with its own ``trim_admm_trace`` / ``admm_trace_summary`` helpers;
``lane_trace`` slices both schemas.

The helpers take a record of torch tensors (on the CPU or on the card) or
of numpy arrays. A tensor field crosses to the host once per helper call
(``.detach().cpu().numpy()``); what comes back is numpy and plain Python
values, exactly as the reference's helpers return them.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Dict, List, Optional

import numpy as np
import torch

from ..core.pgd import PGDTrace

if TYPE_CHECKING:  # pragma: no cover
    from ..horizon.admm import ADMMTrace

# The engine's trace record IS the public solver-trace schema.
SolverTrace = PGDTrace

__all__ = ["SolverTrace", "ADMMTrace", "trace_length", "lane_trace",
           "trim_trace", "trace_summary", "traces_to_dict",
           "trim_admm_trace", "admm_trace_summary"]


def __getattr__(name: str):
    # Lazy re-export: repro_torch.horizon.problem imports repro_torch.fleet,
    # whose replay imports this package, so an eager import of
    # horizon.admm here would close an import cycle. The record still lives
    # with its engine (like PGDTrace in core.pgd); only the lookup waits.
    if name == "ADMMTrace":
        from ..horizon.admm import ADMMTrace
        return ADMMTrace
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _host(a) -> np.ndarray:
    """One record field as host numpy (a tensor is copied off its device)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def trace_length(trace: PGDTrace) -> int:
    """Number of rows (the engine's ``max_iters`` budget, not iters taken)."""
    return int(trace.merit.shape[-1])


def lane_trace(trace, lane: int):
    """Slice one lane out of a batched ``(B, L)`` capture (from a stacked
    fleet solve) as a plain ``(L,)`` record of numpy rows. Works for both
    trace schemas (:data:`SolverTrace` and :data:`ADMMTrace`) — the record
    type is preserved."""
    if np.ndim(trace[0]) < 2:
        raise ValueError("lane_trace expects a batched (B, L) trace; "
                         "this capture is already single-lane")
    return type(trace)(*(_host(f[lane]) for f in trace))


def trim_trace(trace: PGDTrace, iters: Optional[int] = None) -> PGDTrace:
    """Drop the sentinel tail: return the first ``iters`` rows as numpy.

    When ``iters`` is None it is inferred as the number of non-NaN merit
    rows (the engine writes merit every executed iteration)."""
    merit = _host(trace.merit)
    if merit.ndim != 1:
        raise ValueError("trim_trace expects a single-lane (L,) trace; "
                         "use lane_trace first")
    if iters is None:
        iters = int(np.sum(~np.isnan(merit)))
    iters = int(iters)
    return PGDTrace(merit[:iters], *(_host(f)[:iters] for f in trace[1:]))


def trace_summary(trace: PGDTrace, iters: Optional[int] = None) -> Dict:
    """Summarise one lane's convergence trajectory as plain floats/ints.

    Keys: ``iters`` (rows executed), ``merit_first``/``merit_final``
    (objective at iteration 1 / at stop), ``merit_drop`` (first - final),
    ``accept_rate`` (share of iterations whose Armijo ladder accepted),
    ``mean_rung`` (mean accepted rung index — 0 means the BB step passes
    untouched; higher means heavy backtracking), ``max_move`` (largest
    accepted coordinate move)."""
    t = trim_trace(trace, iters)
    n = int(t.merit.shape[0])
    if n == 0:
        return {"iters": 0, "merit_first": None, "merit_final": None,
                "merit_drop": None, "accept_rate": None, "mean_rung": None,
                "max_move": None}
    acc = np.asarray(t.accepted, bool)
    rungs = np.asarray(t.rung)[acc]
    return {
        "iters": n,
        "merit_first": float(t.merit[0]),
        "merit_final": float(t.merit[-1]),
        "merit_drop": float(t.merit[0] - t.merit[-1]),
        "accept_rate": float(acc.mean()),
        "mean_rung": float(rungs.mean()) if rungs.size else None,
        "max_move": float(np.asarray(t.move).max()),
    }


def trim_admm_trace(trace: "ADMMTrace",
                    iters: Optional[int] = None) -> "ADMMTrace":
    """Drop the sentinel tail of a single-lane ADMM capture: return the
    first ``iters`` outer-iteration rows as numpy. When ``iters`` is None it
    is inferred as the number of non-NaN primal-residual rows (the loop
    writes the residual pair every executed outer iteration)."""
    primal = _host(trace.primal)
    if primal.ndim != 1:
        raise ValueError("trim_admm_trace expects a single-lane (L,) trace; "
                         "use lane_trace first")
    if iters is None:
        iters = int(np.sum(~np.isnan(primal)))
    iters = int(iters)
    return type(trace)(primal[:iters],
                       *(_host(f)[:iters] for f in trace[1:]))


def admm_trace_summary(trace: "ADMMTrace",
                       iters: Optional[int] = None) -> Dict:
    """Summarise one lane's ADMM residual trajectory as plain floats/ints.

    Keys: ``admm_iters`` (outer iterations executed), ``primal_first`` /
    ``primal_final`` and ``dual_first`` / ``dual_final`` (residuals after
    the first / last outer iteration), ``inner_total`` (inner PGD
    iterations summed over the run)."""
    t = trim_admm_trace(trace, iters)
    n = int(t.primal.shape[0])
    if n == 0:
        return {"admm_iters": 0, "primal_first": None, "primal_final": None,
                "dual_first": None, "dual_final": None, "inner_total": 0}
    return {
        "admm_iters": n,
        "primal_first": float(t.primal[0]),
        "primal_final": float(t.primal[-1]),
        "dual_first": float(t.dual[0]),
        "dual_final": float(t.dual[-1]),
        "inner_total": int(np.asarray(t.inner).sum()),
    }


def traces_to_dict(traces: List[PGDTrace]) -> List[Dict]:
    """JSON-ready dump of a list of single-lane traces (trimmed rows as
    lists) — the shape ``ReplayReport.to_dict`` and the bench JSONs embed."""
    out = []
    for tr in traces:
        t = trim_trace(tr)
        out.append({
            "iters": int(t.merit.shape[0]),
            "merit": [float(v) for v in t.merit],
            "step": [float(v) for v in t.step],
            "accepted": [bool(v) for v in t.accepted],
            "rung": [int(v) for v in t.rung],
            "move": [float(v) for v in t.move],
        })
    return out
