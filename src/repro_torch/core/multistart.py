"""Multi-start points (paper §III.C) — port of ``repro.core.multistart``'s
``make_starts``; ``multistart_solve`` is not ported yet.

Start families: zeros, single-type covers of the most cost-efficient
types, and random scaled uniforms around a least-squares coverage level.
The random family is drawn with a ``torch.Generator`` seeded from ``seed``
(on the CPU, so every device sees the same starts); it differs from the
reference's ``jax.random`` draws, so parity tests feed both packages the
same starts.
"""
from __future__ import annotations

from typing import Optional

import torch

from .problem import AllocationProblem


def make_starts(prob: AllocationProblem, n_starts: int, seed: int = 0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(S, n) start matrix for a single problem, on the problem's device."""
    n = prob.n
    dev = prob.device
    K = prob.K
    # single-type covers: cover_i = max_r d_r / K_ri; efficiency = its cost
    safe_K = torch.where(K > 0, K, torch.full_like(K, 1e-9))
    per_type_cover = (prob.d[:, None] / safe_K).amax(0)                # (n,)
    covered = ((K > 0) | (prob.d[:, None] == 0)).all(0)                # (n,)
    cover_cost = torch.where(covered & (prob.mask > 0),
                             per_type_cover * prob.c,
                             torch.full_like(per_type_cover, float("inf")))
    n_single = min(n_starts // 2, 16)
    order = torch.argsort(cover_cost, stable=True)[:n_single]
    singles = torch.zeros((n_single, n), dtype=torch.float32, device=dev)
    singles[torch.arange(n_single, device=dev), order] = torch.clamp(
        per_type_cover[order], 0.0, 1e4)

    # random scaled starts: E[Kx] ~ d on average
    n_rand = n_starts - n_single - 1
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    u = torch.rand((max(n_rand, 1), n), generator=generator).to(dev)
    col_mean = torch.clamp(K.mean(1), min=1e-9)                        # (m,)
    scale = (prob.d / (col_mean * n)).amax()
    rand = 2.0 * scale * u * prob.mask

    zeros = torch.zeros((1, n), dtype=torch.float32, device=dev)
    return torch.cat([zeros, singles, rand[:n_rand]], 0)[:n_starts]
