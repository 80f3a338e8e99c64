"""Device meshes — port of ``repro.launch.mesh``, on
``torch.distributed.device_mesh``. Functions, not module-level constants:
importing this module starts nothing.

``init_distributed`` starts the default process group: NCCL for a CUDA
device, gloo for the CPU, and nothing else (no fallback from one to the
other). Under ``torchrun`` it reads the rendezvous from the environment;
outside it a world of one meets over an in-memory store (no socket); the
multi-rank CPU tests pass a ``file://`` ``init_method``.
"""
from __future__ import annotations

import math
import os
from contextlib import contextmanager
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device
from ..distributed import sharding as shd

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _backend(dev: torch.device) -> str:
    if dev.type not in BACKENDS:
        raise ValueError(f"no process-group backend for {dev.type} devices")
    return BACKENDS[dev.type]


def init_distributed(device: DeviceLike = None, *,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> torch.device:
    """Start the default process group for ``device``'s type (default
    "cuda": NCCL; "cpu": gloo) unless one is running, and return this
    rank's device (cuda:LOCAL_RANK under torchrun, made current).
    ``init_method`` with ``rank`` and ``world_size`` meet at that address;
    else under torchrun (RANK and WORLD_SIZE set) the environment's;
    else a world of one over an in-memory store. A running group of
    another backend raises."""
    dev = resolve_device(device)
    backend = _backend(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        running = dist.get_backend()
        if running != backend:
            raise RuntimeError(f"a {running} process group is running; "
                               f"{dev.type} tensors need {backend}")
        return dev
    if init_method is not None:
        dist.init_process_group(backend, init_method=init_method,
                                rank=rank, world_size=world_size)
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return dev


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device: DeviceLike = None):
    """A DeviceMesh of ``shape`` with ``mesh_dim_names=axes`` over every
    rank of the default process group (started by ``init_distributed`` if
    it is not running). Raises unless the mesh's size is the world's."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    dev = init_distributed(device)
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs "
                         f"{math.prod(shape)} ranks; the world has {world}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None):
    """16x16 = 256 ranks per pod; 2 pods = 512 ranks multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


@contextmanager
def mesh_context(mesh):
    """Enter ``mesh`` for the sharding rules: ``sharding.batch_mean`` and
    ``batch_shards`` reduce over its batch dimensions inside."""
    with shd.use_mesh(mesh):
        yield mesh
