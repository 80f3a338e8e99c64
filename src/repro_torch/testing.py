"""Test helpers — port of ``repro.testing.make_toy_problem``: the small
random-but-sane allocation problem of the unit tests, drawn with the same
``np.random.default_rng(seed)`` calls as the reference, so both packages
build the same problem from a seed (``tests/test_torch_controller.py``
pins it)."""
from __future__ import annotations

import numpy as np

from .core.problem import AllocationProblem, PenaltyParams
from .device import DeviceLike, resolve_device


def make_toy_problem(seed=0, m=3, n=12, p=2, alpha=0.02, beta3=10.0,
                     demand_scale=1.0, gamma=0.005,
                     device: DeviceLike = None) -> AllocationProblem:
    """Small random-but-sane allocation problem on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    K = rng.uniform(0.2, 2.0, size=(m, n)).astype(np.float32)
    c = (K.sum(axis=0) * rng.uniform(0.05, 0.2, size=n)).astype(np.float32)
    E = np.zeros((p, n), np.float32)
    E[rng.integers(0, p, size=n), np.arange(n)] = 1.0
    d = (rng.uniform(1.0, 4.0, size=m) * demand_scale).astype(np.float32)
    params = PenaltyParams.create(alpha=alpha, beta1=1.0, beta2=0.1,
                                  beta3=beta3, gamma=gamma, device=dev)
    return AllocationProblem.create(K, E, c, d, params=params,
                                    ub_default=100.0, device=dev)
