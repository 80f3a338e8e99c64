"""Rematerialisation: the port's counterpart of ``jax.checkpoint`` and its
``dots_with_no_batch_dims_saveable`` policy, on ``torch.utils.checkpoint``.

A function run under ``checkpoint`` keeps only its inputs for the backward
and runs again there to get what its backward needs; none of it changes a
value. Where autograd records nothing (``torch.no_grad``,
``torch.inference_mode``) or no input requires grad, the function just
runs: there is nothing to keep.
"""
from __future__ import annotations

from functools import partial

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

# the products without batch dimensions (x @ W folds to mm / addmm); a
# batched einsum lowers to bmm and is recomputed, as under the reference's
# dots_with_no_batch_dims_saveable
_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _records(args) -> bool:
    return torch.is_grad_enabled() and any(
        torch.is_tensor(a) and a.requires_grad for a in args)


def maybe_checkpoint(fn, *args, unroll: bool = False):
    """fn(*args) under ``torch.utils.checkpoint`` unless ``unroll`` (the
    reference's ``unroll_inner``, which skips its ``jax.checkpoint`` too) or
    autograd records nothing. Tensors that ``fn`` reads from its closure
    (parameters) get their gradients as its arguments do."""
    if unroll or not _records(args):
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False)


def remat(fn, policy: str, *args):
    """fn(*args) under the model's remat policy (``cfg.remat``): "none"
    keeps every intermediate; "full" keeps only the inputs and recomputes
    the rest in the backward; "dots" also keeps the outputs of the products
    without batch dimensions (the weight matmuls)."""
    if policy not in ("none", "full", "dots"):
        raise ValueError(f"remat policy {policy!r} not in none, full, dots")
    if policy == "none" or not _records(args):
        return fn(*args)
    if policy == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=partial(create_selective_checkpoint_contexts,
                                         _dots_policy))
