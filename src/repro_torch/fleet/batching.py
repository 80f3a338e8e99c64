"""Stack heterogeneous AllocationProblems into one padded, masked batch —
port of ``repro.fleet.batching``: ``FleetBatch``, ``stack_problems``,
``unstack_solution``, ``embed_solutions``, ``tenant_problem``,
``union_term_kinds``, and the shape-bucketed layout (``bucket_dims``,
``ceil_pow2``, ``BucketedFleet``, ``bucket_problems``,
``scatter_from_buckets``, ``padding_stats``).

Padding is exact, as in the reference: padded variables get mask = 0,
lb = ub = 0, c = 0 and all-zero K/E columns; padded constraint rows get
d = 0, mu = g = 1 and an all-zero K row (band -1 <= 0 <= 1, strictly
interior); padded provider rows are all-zero in E, so 1 - exp(-b1 * 0) = 0.
Attached scenario terms stack on the UNION of the batch's kinds: params
pad with zeros along their declared axis, and a tenant without a kind gets
all-zero params — every term is linear in its params and hinges at zero on
padded rows, so it adds exactly 0.0 and a zero gradient. Hence
objective(padded, embed(x)) == objective(original, x), and a solve on the
stack is B independent solves.

A single global pad is wasteful on a skewed fleet: one tenant with
n = 1880 pads every small tenant to 1880. ``bucket_problems`` groups
tenants into power-of-two shape buckets and stacks one FleetBatch per
bucket, remembering each tenant's place so per-bucket results scatter
back exactly; ``padding_stats`` counts the K cells either layout pads.

Stacking gathers the per-tenant leaves on the host and moves each stacked
leaf to the device in one copy.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.problem import AllocationProblem, PenaltyParams
from ..core.terms import TERM_DEFS, PricedTerm
from ..device import DeviceLike
from ..obs.telemetry import current_recorder


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


def union_term_kinds(problems: Sequence[AllocationProblem]
                     ) -> Tuple[str, ...]:
    """The union of attached term kinds across ``problems``, in first-
    appearance order: the batch's term signature."""
    kinds: List[str] = []
    for pb in problems:
        for t in pb.terms:
            if t.kind not in kinds:
                kinds.append(t.kind)
    return tuple(kinds)


def _stack_terms(problems: Sequence[AllocationProblem],
                 kinds: Tuple[str, ...], n_max: int, m_max: int, put
                 ) -> Tuple[PricedTerm, ...]:
    """Each union kind's params stacked on a leading (B,) axis: padded
    along their declared axis, all zeros for a tenant without the kind."""
    size = {"": None, "n": n_max, "m": m_max}
    out = []
    for kind in kinds:
        axes = TERM_DEFS[kind].param_axes
        rows: Dict[str, List[np.ndarray]] = {k: [] for k in axes}
        for pb in problems:
            present = {t.kind: t for t in pb.terms}
            for k, ax in axes.items():
                if kind in present:
                    a = _host(present[kind].params[k])
                    rows[k].append(a if ax == "" else _pad1(a, size[ax]))
                else:
                    rows[k].append(np.zeros(() if ax == "" else (size[ax],),
                                            np.float32))
        out.append(PricedTerm(kind, {k: put(v) for k, v in rows.items()}))
    return tuple(out)


def stack_problems(problems: Sequence[AllocationProblem],
                   n_max: Optional[int] = None,
                   m_max: Optional[int] = None,
                   p_max: Optional[int] = None,
                   active: Optional[np.ndarray] = None,
                   term_kinds: Optional[Tuple[str, ...]] = None,
                   device: DeviceLike = None) -> FleetBatch:
    """Stack ragged problems into one padded batch problem on ``device``
    (default: the first problem's device).

    ``term_kinds`` forces the stacked term signature (default: the union
    of the problems' kinds); a tenant without a kind gets zero params, an
    exact no-op. With a telemetry recorder installed
    (``repro_torch.obs.telemetry``) each stacking samples the gauge
    ``stack/padding_waste``: the share of the batch's K cells that is
    padding. The stack is the same with telemetry on or off."""
    if len(problems) == 0:
        raise ValueError("empty fleet")
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

    kinds = (union_term_kinds(problems) if term_kinds is None
             else tuple(term_kinds))
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
        mask=put([_pad1(pb.mask, n_max) for pb in problems]),
        terms=_stack_terms(problems, kinds, n_max, m_max, put))
    rec = current_recorder()
    if rec is not None:
        true_cells = sum(n * m for n, m in zip(ns, ms))
        rec.gauge("stack/padding_waste",
                  1.0 - true_cells / (len(problems) * n_max * m_max))
    return FleetBatch(problem=stacked, n_true=np.asarray(ns, np.int64),
                      m_true=np.asarray(ms, np.int64),
                      p_true=np.asarray(ps, np.int64), active=active)


def unstack_solution(batch: FleetBatch, X) -> List[np.ndarray]:
    """Slice a padded (B, n_max) solution back into per-tenant vectors."""
    X = X.detach().cpu().numpy() if torch.is_tensor(X) else np.asarray(X)
    return [X[b, : batch.n_true[b]].copy() for b in range(batch.B)]


def embed_solutions(batch: FleetBatch, xs: Sequence[np.ndarray]) -> np.ndarray:
    """Per-tenant vectors -> one zero-padded (B, n_max) array."""
    out = np.zeros((batch.B, batch.n_max), np.float32)
    for b, x in enumerate(xs):
        out[b, : len(x)] = x
    return out


def tenant_problem(batch: FleetBatch, b: int) -> AllocationProblem:
    """Tenant ``b``'s ORIGINAL (unpadded) problem, sliced from the batch
    (contiguous copies, so it can go straight to the kernel). Its terms
    carry the batch's union signature: a kind the tenant lacked comes back
    at zero params, an exact no-op. Leaves with more leading axes than the
    tenant's, such as a fleet of horizon windows (B, H, ...), keep them:
    tenant b's window comes back (H, ...)."""
    n, m, p = int(batch.n_true[b]), int(batch.m_true[b]), int(batch.p_true[b])
    pb = batch.problem
    cut = lambda a: a.contiguous()
    extent = {"": None, "n": n, "m": m}

    def param(a, axis):
        return cut(a[b]) if axis == "" else cut(a[b, ..., :extent[axis]])

    terms = tuple(
        PricedTerm(t.kind, {k: param(t.params[k], ax)
                            for k, ax in TERM_DEFS[t.kind].param_axes.items()})
        for t in pb.terms)
    return AllocationProblem(
        K=cut(pb.K[b, ..., :m, :n]), E=cut(pb.E[b, ..., :p, :n]),
        c=cut(pb.c[b, ..., :n]), d=cut(pb.d[b, ..., :m]),
        mu=cut(pb.mu[b, ..., :m]), g=cut(pb.g[b, ..., :m]),
        params=PenaltyParams(*(cut(a[b]) for a in pb.params)),
        lb=cut(pb.lb[b, ..., :n]), ub=cut(pb.ub[b, ..., :n]),
        mask=cut(pb.mask[b, ..., :n]), terms=terms)


# ---------------------------------------------------------------------------
# shape-bucketed stacking
# ---------------------------------------------------------------------------


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


class BucketedFleet(NamedTuple):
    """A fleet split into shape buckets: ``batches[i]`` is bucket i's
    FleetBatch (padded to its power-of-two dims), ``tenant_idx[i]`` the
    ORIGINAL fleet indices of its tenants in their original order; the
    concatenated ``tenant_idx`` is a permutation of ``range(B)``."""

    batches: List[FleetBatch]
    tenant_idx: List[np.ndarray]

    @property
    def B(self) -> int:
        return sum(len(idx) for idx in self.tenant_idx)

    @property
    def n_buckets(self) -> int:
        return len(self.batches)


def bucket_problems(problems: Sequence[AllocationProblem], *,
                    n_floor: int = 8, m_floor: int = 2, p_floor: int = 2,
                    device: DeviceLike = None) -> BucketedFleet:
    """Group ragged problems into power-of-two shape buckets, in ascending
    shape order, and stack each on ``device`` (default: the first
    problem's); :func:`scatter_from_buckets` restores the fleet order."""
    if len(problems) == 0:
        raise ValueError("empty fleet")
    groups: Dict[Tuple[int, int, int], List[int]] = {}
    for b, pb in enumerate(problems):
        key = bucket_dims(int(pb.n), int(pb.m), int(pb.p), n_floor=n_floor,
                          m_floor=m_floor, p_floor=p_floor)
        groups.setdefault(key, []).append(b)
    batches, idxs = [], []
    for key in sorted(groups):
        members = groups[key]
        n_pad, m_pad, p_pad = key
        batches.append(stack_problems([problems[b] for b in members],
                                      n_max=n_pad, m_max=m_pad, p_max=p_pad,
                                      device=device))
        idxs.append(np.asarray(members, np.int64))
    return BucketedFleet(batches=batches, tenant_idx=idxs)


def scatter_from_buckets(bucketed: BucketedFleet,
                         rows_per_bucket: Sequence[Sequence]) -> List:
    """Per-bucket, per-tenant rows back in the original fleet order; exact
    for any payload type."""
    out: List = [None] * bucketed.B
    for idx, rows in zip(bucketed.tenant_idx, rows_per_bucket):
        if len(rows) != len(idx):
            raise ValueError(f"{len(rows)} rows for a bucket of {len(idx)}")
        for i, b in enumerate(idx):
            out[int(b)] = rows[i]
    return out


def padding_stats(problems: Sequence[AllocationProblem],
                  bucketed: Optional[BucketedFleet] = None
                  ) -> Dict[str, float]:
    """K-matrix cells (m n per tenant) that carry data (``true_cells``)
    and that the layout allocates (``padded_cells``), and the padding's
    share ``waste_frac``: the global pad of :func:`stack_problems` when
    ``bucketed`` is None, else the bucketed layout."""
    true = float(sum(int(pb.m) * int(pb.n) for pb in problems))
    if bucketed is None:
        n_max = max(int(pb.n) for pb in problems)
        m_max = max(int(pb.m) for pb in problems)
        padded = float(len(problems) * m_max * n_max)
    else:
        padded = float(sum(
            len(idx) * batch.problem.K.shape[1] * batch.problem.K.shape[2]
            for idx, batch in zip(bucketed.tenant_idx, bucketed.batches)))
    return dict(true_cells=true, padded_cells=padded,
                waste_frac=1.0 - true / padded)
