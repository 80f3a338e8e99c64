"""Pipeline parallelism (GPipe-style microbatching over a 'pipe' mesh axis)
— port of ``repro.distributed.pipeline_parallel``, with point-to-point
sends in place of ``lax.ppermute``.

Layers are split into n_stages contiguous chunks; rank s of the mesh's
'pipe' dimension applies stage s's chunk; the classic GPipe loop runs
n_micro + n_stages - 1 ticks, shifting activations stage-to-stage around a
ring (``dist.batch_isend_irecv`` on the 'pipe' group). Steady-state bubble
fraction = (n_stages-1)/(n_micro+n_stages-1).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from ..optim.adamw import tree_map


def _ring_shift(y: torch.Tensor, group, stage: int, n_stages: int
                ) -> torch.Tensor:
    """y sent to the next stage; what the previous stage sent, returned."""
    if n_stages == 1:
        return y
    nxt = dist.get_global_rank(group, (stage + 1) % n_stages)
    prv = dist.get_global_rank(group, (stage - 1) % n_stages)
    out = torch.empty_like(y)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, y.contiguous(), nxt, group),
        dist.P2POp(dist.irecv, out, prv, group)])
    for r in reqs:
        r.wait()
    return out


def pipeline_apply(fn_stage: Callable, params_stacked, x_micro, *,
                   mesh, n_stages: int, axis: str = "pipe"):
    """Run x through n_stages of fn_stage with GPipe microbatching.

    fn_stage: (stage_params, x) -> x          (one stage's computation)
    params_stacked: tree (nested dicts and lists) of tensors with leading
        dim n_stages (stage-major); each rank applies its own stage's slice
    x_micro: (n_micro, micro_batch, ...) microbatched input, on every rank
    mesh: a DeviceMesh with an ``axis`` dimension of size n_stages
    Returns (n_micro, micro_batch, ...) output of the LAST stage, on every
    rank (broadcast over the 'pipe' group).
    """
    n_micro = x_micro.shape[0]
    if mesh.size(mesh.mesh_dim_names.index(axis)) != n_stages:
        raise ValueError(f"the mesh's {axis!r} dimension is not "
                         f"{n_stages} stages")
    group = mesh.get_group(axis)
    stage = mesh.get_local_rank(axis)
    stage_params = tree_map(lambda a: a[stage], params_stacked)
    n_ticks = n_micro + n_stages - 1
    buf = torch.zeros_like(x_micro)              # output slots
    carry = torch.zeros_like(x_micro[0])         # activation in flight
    for t in range(n_ticks):
        # stage 0 ingests microbatch t (if any); others use carry
        x_in = x_micro[min(t, n_micro - 1)] if stage == 0 else carry
        y = fn_stage(stage_params, x_in)
        # stage s processes microbatch t - s at tick t
        my_mb = t - stage
        valid = 0 <= my_mb < n_micro
        if not valid:
            y = torch.zeros_like(y)
        elif stage == n_stages - 1:
            buf[my_mb] = y
        carry = _ring_shift(y, group, stage, n_stages)
    # the last stage's outputs, to every rank of the pipe
    dist.broadcast(buf, dist.get_global_rank(group, n_stages - 1),
                   group=group)
    return buf


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)
