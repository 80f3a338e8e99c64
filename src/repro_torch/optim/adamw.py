"""AdamW with a warmup/cosine schedule and global-norm clipping — port of
``repro.optim.adamw``, on trees of torch tensors (nested dicts and lists,
as ``repro_torch.models.init_model`` builds them).

The reference's ``update`` returns new parameters and moments. Here
``update`` works leaf by leaf, in place under ``torch.no_grad()``, and sets
each gradient leaf to None once its parameter is updated: at qwen1.5-4b's
size (3.95 B parameters in float32) a second copy of the parameters would
not fit one card beside the gradients and the moments. The arithmetic is
the reference's, in its order: the clip scale, m and v, the bias
corrections, the decoupled decay term, lr times the step.

``state_axes`` gives the moments the parameters' logical axes (the
launcher's mesh shards them as it shards the parameters). ``global_norm``
reads DTensor gradients shard by shard; ``update`` then takes that norm
from outside, given the local shards. ``abstract_state`` is the state on
the meta device, for the dry run (``launch.dryrun``).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Iterator, NamedTuple, Optional, Tuple

import torch


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor    # () int32, on the parameters' device
    m: Any                # float32 tree shaped as the parameters
    v: Any


def tree_leaves(tree) -> list:
    """The leaves of a tree of nested dicts (in key order) and lists."""
    return [leaf for _, _, leaf in _slots(tree)]


def tree_map(fn: Callable, tree, *rest):
    """The tree with every leaf replaced by fn(leaf, *the same leaf of each
    tree in ``rest``), which share ``tree``'s structure down to its
    leaves."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def _slots(tree) -> Iterator[Tuple[Any, Any, Any]]:
    """(container, key, leaf) for every leaf, in tree_leaves' order."""
    items = (tree.items() if isinstance(tree, dict) else enumerate(tree))
    for k, v in items:
        if isinstance(v, (dict, list)):
            yield from _slots(v)
        else:
            yield tree, k, v


def _zip_slots(grads, params, m, v) -> Iterator[tuple]:
    """(grads' container, key, gradient, parameter, m, v) for every leaf,
    matched by key and position along ``params``' structure (so trees
    built in another key order pair up right)."""
    keys = params.keys() if isinstance(params, dict) else range(len(params))
    for k in keys:
        if isinstance(params[k], (dict, list)):
            yield from _zip_slots(grads[k], params[k], m[k], v[k])
        else:
            yield grads, k, grads[k], params[k], m[k], v[k]


def init(params) -> AdamWState:
    """step 0 and zeroed float32 moments on the parameters' device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    dev = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def abstract_state(params) -> AdamWState:
    """The state of ``init(params)`` on the meta device, without memory:
    float32 moments shaped as the parameters and an int32 scalar step."""
    meta = lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta")
    return AdamWState(step=torch.empty((), dtype=torch.int32, device="meta"),
                      m=tree_map(meta, params), v=tree_map(meta, params))


def state_axes(param_axes) -> AdamWState:
    """Logical axes for the optimizer state (mirror of the params)."""
    return AdamWState(step=None, m=param_axes, v=param_axes)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup over cfg.warmup_steps, then a cosine from cfg.lr down
    to cfg.min_lr_frac of it at cfg.total_steps; float32."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of their float32 sums of squares, the
    leaves added in order. A DTensor leaf counts each of its elements once:
    this rank adds its shard's sum divided by the number of ranks that hold
    the same shard (the mesh dimensions it is replicated over), and the
    ranks' totals are summed over every dimension of the mesh."""
    from torch.distributed.tensor import DTensor
    total, mesh = 0, None
    for x in tree_leaves(tree):
        if isinstance(x, DTensor):
            mesh = x.device_mesh
            copies = math.prod(mesh.size(i) for i, p in
                               enumerate(x.placements) if p.is_replicate())
            total = total + x.to_local().float().square().sum() / copies
        else:
            total = total + x.float().square().sum()
    if mesh is not None:
        for i in range(mesh.ndim):
            if mesh.size(i) > 1:
                torch.distributed.all_reduce(total, group=mesh.get_group(i))
    return torch.sqrt(total)


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state: AdamWState, params,
           grad_norm: Optional[torch.Tensor] = None
           ) -> Tuple[Any, AdamWState, dict]:
    """One AdamW step. Updates ``params`` and the moments of ``state`` in
    place, leaf by leaf, and sets each leaf of ``grads`` to None once its
    parameter is updated (the grads tree is consumed). ``grad_norm`` is the
    whole gradient's global norm where the trees hold this rank's shards
    (default: ``global_norm(grads)``). Returns (params, new_state,
    {"grad_norm", "lr"}): the same parameter tree and moments, a new step
    counter."""
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    step32 = step.to(torch.float32)
    beta = lambda b: torch.full((), b, dtype=torch.float32,
                                device=step.device)
    bc1 = 1 - torch.pow(beta(b1), step32)
    bc2 = 1 - torch.pow(beta(b2), step32)

    for gbox, gk, g, p, m, v in _zip_slots(grads, params, state.m,
                                           state.v):
        gbox[gk] = None                  # the tree lets the gradient go
        g32 = g.float() * scale
        del g
        # m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g g
        m.mul_(b1).add_(g32 * (1 - b1))
        t = g32 * (1 - b2)
        t.mul_(g32)
        v.mul_(b2).add_(t)
        del g32
        # delta = (m / bc1) / (sqrt(v / bc2) + eps) + wd p; p -= lr delta
        p32 = p.float()
        torch.div(v, bc2, out=t)
        t.sqrt_().add_(cfg.eps)
        delta = torch.div(m, bc1)
        delta.div_(t)
        torch.mul(p32, cfg.weight_decay, out=t)
        delta.add_(t)
        del t
        delta.mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(delta)
        else:
            p.copy_(p32 - delta)
        del delta, p32
    return params, AdamWState(step, state.m, state.v), {"grad_norm": gnorm,
                                                        "lr": lr}
