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


def spawn_world(fn, world_size: int, workdir, *args) -> None:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned CPU
    processes joined in one gloo process group, which meets over a
    ``file://`` store in ``workdir`` (no port, so runs in parallel do not
    collide). ``fn`` must be importable by name (a module-level function);
    it hands its results back through files in ``workdir``. Raises if a
    rank fails."""
    import os

    import torch.multiprocessing as mp
    store = os.path.join(str(workdir), f"store_{os.getpid()}_{id(fn)}")
    if os.path.exists(store):
        os.remove(store)
    mp.spawn(_spawned, args=(fn, world_size, store, args),
             nprocs=world_size, join=True)


def _spawned(rank, fn, world_size, store, args):
    import torch
    import torch.distributed as dist

    from .launch.mesh import init_distributed
    torch.set_num_threads(1)
    init_distributed("cpu", init_method=f"file://{store}", rank=rank,
                     world_size=world_size)
    try:
        fn(rank, world_size, *args)
    finally:
        dist.destroy_process_group()
