"""Problem construction from a raw demand vector — ``problem_from_demand``
of ``repro.core.api``. The one-shot ``optimize`` pipeline (multistart and
branch-and-bound) is not ported yet.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .catalog import Catalog
from .problem import AllocationProblem, PenaltyParams
from .terms import NOT_PORTED


def problem_from_demand(catalog: Catalog, demand: np.ndarray,
                        params: Optional[PenaltyParams] = None,
                        allowed_idx: Optional[np.ndarray] = None,
                        existing: Optional[np.ndarray] = None,
                        normalize: bool = True,
                        terms=(),
                        unavailable_idx: Optional[np.ndarray] = None,
                        device: DeviceLike = None) -> AllocationProblem:
    """Build the problem for a raw demand vector, as the reference does:
    with ``normalize`` each resource row of K is divided by d_r (so d == 1
    in solver units); ``allowed_idx`` restricts the usable types (existing
    nodes stay allowed); ``existing`` lower-bounds the allocation;
    ``unavailable_idx`` zeroes mask, ub and lb of the listed types for this
    tick (the spot-interruption overlay). Scenario ``terms`` are not ported
    yet and raise."""
    if terms:
        raise NotImplementedError(NOT_PORTED)
    dev = resolve_device(device)
    K, E, c = catalog.matrices()
    d = np.asarray(demand, np.float32)
    if normalize:
        scale = 1.0 / np.maximum(d, 1e-9)
        K = K * scale[:, None]
        d = np.ones_like(d)
    prob = AllocationProblem.create(K, E, c, d, params=params, device=dev)
    if allowed_idx is not None:
        allowed = np.asarray(allowed_idx)
        if existing is not None:
            existing_idx = np.nonzero(existing > 0)[0]
            allowed = np.unique(np.concatenate([allowed, existing_idx]))
        prob = prob.restrict(allowed)
    if existing is not None and np.asarray(existing).any():
        prob = prob.with_existing(np.asarray(existing, np.float32))
    if unavailable_idx is not None and len(np.asarray(unavailable_idx)):
        keep = np.ones(prob.n, np.float32)
        keep[np.asarray(unavailable_idx, np.int64)] = 0.0
        keep_t = torch.as_tensor(keep, device=dev)
        # lb too: an interrupted spot node is gone even if it was deployed
        prob = prob._replace(mask=prob.mask * keep_t, ub=prob.ub * keep_t,
                             lb=prob.lb * keep_t)
    return prob
