"""Stack heterogeneous AllocationProblems into one padded, masked batch —
port of ``repro.fleet.batching`` (``FleetBatch``, ``stack_problems``,
``embed_solutions``, ``tenant_problem``,
``bucket_dims``, ``ceil_pow2``). Bucketed stacking and its scatter and
padding statistics are not ported yet.

Padding is exact, as in the reference: padded variables get mask = 0,
lb = ub = 0, c = 0 and all-zero K/E columns; padded constraint rows get
d = 0, mu = g = 1 and an all-zero K row (band -1 <= 0 <= 1, strictly
interior); padded provider rows are all-zero in E, so 1 - exp(-b1 * 0) = 0.
Hence objective(padded, embed(x)) == objective(original, x), and a solve on
the stack is B independent solves.

Stacking gathers the per-tenant leaves on the host and moves each stacked
leaf to the device in one copy.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.problem import AllocationProblem, PenaltyParams
from ..core.terms import NOT_PORTED
from ..device import DeviceLike


class FleetBatch(NamedTuple):
    """A stacked fleet. ``problem`` leaves have a leading (B,) axis;
    ``active`` is the (B,) liveness mask of a ragged-horizon replay (None:
    every row is live)."""

    problem: AllocationProblem
    n_true: np.ndarray          # (B,) original variable counts
    m_true: np.ndarray          # (B,) original resource counts
    p_true: np.ndarray          # (B,) original provider counts
    active: Optional[np.ndarray] = None

    @property
    def B(self) -> int:
        return self.problem.c.shape[0]

    @property
    def n_max(self) -> int:
        return self.problem.c.shape[1]

    @property
    def active_mask(self) -> np.ndarray:
        """The (B,) liveness mask, materialized (all-true when unset)."""
        if self.active is None:
            return np.ones(self.B, bool)
        return np.asarray(self.active, bool)


def _host(a) -> np.ndarray:
    return (a.detach().cpu().numpy() if torch.is_tensor(a)
            else np.asarray(a)).astype(np.float32, copy=False)


def _pad2(a, rows: int, cols: int) -> np.ndarray:
    a = _host(a)
    out = np.zeros((rows, cols), np.float32)
    out[: a.shape[0], : a.shape[1]] = a
    return out


def _pad1(a, size: int, fill: float = 0.0) -> np.ndarray:
    a = _host(a)
    out = np.full((size,), fill, np.float32)
    out[: a.shape[0]] = a
    return out


def stack_problems(problems: Sequence[AllocationProblem],
                   n_max: Optional[int] = None,
                   m_max: Optional[int] = None,
                   p_max: Optional[int] = None,
                   active: Optional[np.ndarray] = None,
                   device: DeviceLike = None) -> FleetBatch:
    """Stack ragged problems into one padded batch problem on ``device``
    (default: the first problem's device)."""
    if len(problems) == 0:
        raise ValueError("empty fleet")
    if any(pb.terms for pb in problems):
        raise NotImplementedError(NOT_PORTED)
    if active is not None:
        active = np.asarray(active, bool)
        if active.shape != (len(problems),):
            raise ValueError(f"active mask shape {active.shape}, expected "
                             f"({len(problems)},)")
    dev = problems[0].device if device is None else torch.device(device)
    ns = [int(pb.n) for pb in problems]
    ms = [int(pb.m) for pb in problems]
    ps = [int(pb.p) for pb in problems]
    n_max = n_max or max(ns)
    m_max = m_max or max(ms)
    p_max = p_max or max(ps)
    if n_max < max(ns) or m_max < max(ms) or p_max < max(ps):
        raise ValueError("pad sizes below the fleet's largest problem")

    def put(rows: List[np.ndarray]) -> torch.Tensor:
        return torch.from_numpy(np.stack(rows)).to(dev)

    stacked = AllocationProblem(
        K=put([_pad2(pb.K, m_max, n_max) for pb in problems]),
        E=put([_pad2(pb.E, p_max, n_max) for pb in problems]),
        c=put([_pad1(pb.c, n_max) for pb in problems]),
        d=put([_pad1(pb.d, m_max) for pb in problems]),
        # padded rows: band [-1, 1] around Kx = 0 — strictly interior
        mu=put([_pad1(pb.mu, m_max, fill=1.0) for pb in problems]),
        g=put([_pad1(pb.g, m_max, fill=1.0) for pb in problems]),
        params=PenaltyParams(*(
            put([_host(getattr(pb.params, f)) for pb in problems])
            for f in PenaltyParams._fields)),
        lb=put([_pad1(pb.lb, n_max) for pb in problems]),
        ub=put([_pad1(pb.ub, n_max) for pb in problems]),
        mask=put([_pad1(pb.mask, n_max) for pb in problems]))
    return FleetBatch(problem=stacked, n_true=np.asarray(ns, np.int64),
                      m_true=np.asarray(ms, np.int64),
                      p_true=np.asarray(ps, np.int64), active=active)


def embed_solutions(batch: FleetBatch, xs: Sequence[np.ndarray]) -> np.ndarray:
    """Per-tenant vectors -> one zero-padded (B, n_max) array."""
    out = np.zeros((batch.B, batch.n_max), np.float32)
    for b, x in enumerate(xs):
        out[b, : len(x)] = x
    return out


def tenant_problem(batch: FleetBatch, b: int) -> AllocationProblem:
    """Tenant ``b``'s ORIGINAL (unpadded) problem, sliced from the batch
    (contiguous copies, so it can go straight to the kernel)."""
    n, m, p = int(batch.n_true[b]), int(batch.m_true[b]), int(batch.p_true[b])
    pb = batch.problem
    cut = lambda a: a.contiguous()
    return AllocationProblem(
        K=cut(pb.K[b, :m, :n]), E=cut(pb.E[b, :p, :n]), c=cut(pb.c[b, :n]),
        d=cut(pb.d[b, :m]), mu=cut(pb.mu[b, :m]), g=cut(pb.g[b, :m]),
        params=PenaltyParams(*(a[b] for a in pb.params)),
        lb=cut(pb.lb[b, :n]), ub=cut(pb.ub[b, :n]), mask=cut(pb.mask[b, :n]))


def ceil_pow2(v: int, floor: int = 1) -> int:
    """Smallest power-of-two multiple of ``floor`` that is >= v."""
    r = max(int(floor), 1)
    while r < v:
        r *= 2
    return r


def bucket_dims(n: int, m: int, p: int, *, n_floor: int = 8,
                m_floor: int = 2, p_floor: int = 2) -> Tuple[int, int, int]:
    """The padded (n, m, p) power-of-two bucket of a (n, m, p) problem."""
    return (ceil_pow2(n, n_floor), ceil_pow2(m, m_floor), ceil_pow2(p, p_floor))
