"""Gradient compression for the data-parallel all-reduce — port of
``repro.optim.grad_compress``: int8 block-quantised gradients with error
feedback (the residual of quantisation is carried to the next step,
keeping the method unbiased in the long run).

quantise -> all-reduce(int32) -> dequantise: at 4x compression the
gradient all-reduce's bytes drop 4x. A torch process group takes the place
of the reference's ``axis_name`` (None: the default group). Plain PyTorch:
the reference has no Pallas kernel here.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from .adamw import tree_leaves, tree_map

BLOCK = 256


class CompressState(NamedTuple):
    error: Any   # tree like grads — error-feedback residual, float32


def init_state(grads_like) -> CompressState:
    return CompressState(error=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads_like))


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block symmetric int8. x flat (n,) float32 -> (q (n_blocks,
    BLOCK) int8, scale (n_blocks, 1))."""
    pad = (-x.shape[0]) % BLOCK
    xp = torch.nn.functional.pad(x, (0, pad)).reshape(-1, BLOCK)
    scale = xp.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(xp / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor, n: int) -> torch.Tensor:
    return (q.to(torch.float32) * scale).reshape(-1)[:n]


def compress_decompress(g: torch.Tensor, err: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Local quantise+dequantise with error feedback — models the lossy
    channel. Returns (dequantised g in g's type, the new float32 error)."""
    flat = (g.to(torch.float32) + err).reshape(-1)
    q, scale = _quantize(flat)
    deq = _dequantize(q, scale, flat.shape[0]).reshape(g.shape)
    new_err = flat.reshape(g.shape) - deq
    return deq.to(g.dtype), new_err


def compressed_psum(g: torch.Tensor, err: torch.Tensor,
                    group: Optional[dist.ProcessGroup] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sum of ``g`` over ``group``'s ranks through the int8 channel:
    quantise (with error feedback), take the MAX of each block's scale
    over the ranks so the int8 grid is shared, requantise on it, all-reduce
    the int8 payload as int32 partial sums, dequantise. Returns (the sum in
    g's type, this rank's new error: what its lossy contribution missed)."""
    flat = (g.to(torch.float32) + err).reshape(-1)
    n = flat.shape[0]
    q, scale = _quantize(flat)
    scale_max = scale.clone()
    dist.all_reduce(scale_max, op=dist.ReduceOp.MAX, group=group)
    requant = torch.clamp(torch.round((q.to(torch.float32) * scale)
                                      / scale_max), -127, 127)
    summed = requant.to(torch.int32)
    dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
    deq = (summed.to(torch.float32) * scale_max).reshape(-1)[:n]
    local = (requant * scale_max).reshape(-1)[:n]
    new_err = flat.reshape(g.shape) - local.reshape(g.shape)
    return deq.reshape(g.shape).to(g.dtype), new_err


def tree_compressed_psum(grads, state: CompressState,
                         group: Optional[dist.ProcessGroup] = None):
    """``compressed_psum`` leaf by leaf over a tree (nested dicts and
    lists). Returns (summed grads, new CompressState)."""
    errs = iter(tree_leaves(state.error))
    out = tree_map(lambda g: compressed_psum(g, next(errs), group), grads)
    return (_pick(out, 0), CompressState(error=_pick(out, 1)))


def _pick(tree, i: int):
    """The tree of (sum, error) pairs with each pair replaced by its i-th
    element."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]
