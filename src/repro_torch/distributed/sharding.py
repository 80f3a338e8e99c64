"""Logical-axis sharding rules (MaxText-style) and their DTensor placements
— port of ``repro.distributed.sharding``.

Weights and activations are annotated with LOGICAL axis names; a rule set
maps them to mesh axes. Changing the parallelism layout means changing
rules, not model code.

Default layout on mesh ("pod", "data", "model") / ("data", "model"):

  weights:  embed (d_model dim)  -> data      (FSDP / ZeRO-3)
            mlp / heads / vocab  -> model     (TP)
            expert               -> model     (EP)
  acts:     batch                -> pod+data  (DP)
            kv_seq (decode)      -> model     (decode attention splits KV)
            kv_seq (long ctx)    -> data+model (context/sequence parallel)

A spec here is a tuple with one entry per dimension: None, a mesh-axis
name, or a tuple of names — the content of the reference's
``PartitionSpec``, so the two compare directly (``tuple(P(...))``). The
rules and specs read a mesh's axis names and sizes only: a
``torch.distributed.device_mesh.DeviceMesh`` (``mesh_dim_names``,
``shape``) or any object with ``axis_names`` and ``axis_sizes`` (such as
``AxesMesh``), so production meshes can be checked without ranks.
``make_shardings`` turns specs into DTensor placements (``Shard(d)`` /
``Replicate()``, one per mesh dimension).

``gather``, ``batch_mean`` and ``batch_shards`` are the port's own. The
launcher's step holds the parameters as DTensors, and the model gathers
each leaf whole where it reads it (``gather``, the identity on plain
tensors). Under
``launch.mesh.mesh_context`` and ``use_rules``, the launcher's step runs
the model on this rank's slice of the batch, and the few quantities that
mix rows of the batch (the loss's mean, the MoE aux loss's expert shares,
the MoE dropless test) read the whole batch through them. Outside a mesh
they are the identity and 1.

The reference's ``shard_map_compat`` and ``_get_abstract_mesh`` are shims
over jax versions and have no counterpart here.
"""
from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

Rules = Dict[str, Optional[Tuple[str, ...]]]
Spec = Tuple


class AxesMesh(NamedTuple):
    """A mesh's shape without ranks: axis names and sizes."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]


def _mesh_axes(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def _mesh_sizes(mesh) -> Tuple[int, ...]:
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return tuple(mesh.shape)
    return tuple(mesh.axis_sizes)


def base_rules(mesh, cfg=None) -> Rules:
    """Training/prefill layout. The activation residual stream is sharded
    over 'model' between blocks: attention archs shard the SEQUENCE dim
    ("seq" -> model); ssm/hybrid archs (their scans iterate the sequence)
    shard d_model ("act_embed" -> model)."""
    has_pod = "pod" in _mesh_axes(mesh)
    batch = ("pod", "data") if has_pod else ("data",)
    seq_shardable = cfg is None or all(
        b == "attn" for b in getattr(cfg, "block_pattern", ("attn",)))
    return {
        # weights
        "embed": ("data",),          # FSDP shard dim
        "mlp": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "vocab": ("model",),
        "expert": ("model",),
        "rwkv_heads": ("model",),
        "mamba_inner": ("model",),
        "layers": None,              # the reference's stacked dim
        # activations
        "batch": batch,
        "seq": ("model",) if seq_shardable else None,
        "act_embed": None if seq_shardable else ("model",),
        "act_heads": ("model",),
        "kv_seq": None,
        "frontend": None,
        None: None,
    }


def decode_rules(mesh, cfg=None) -> Rules:
    """Decode: the KV cache sharded along its sequence (flash-decode
    style), because kv_heads may be fewer than the model axis."""
    r = base_rules(mesh, cfg)
    r["seq"] = None                  # decode S == 1
    r["act_embed"] = None
    r["kv_seq"] = ("model",)
    r["kv_heads"] = None
    r["act_heads"] = None
    return r


def long_context_rules(mesh, cfg=None) -> Rules:
    """Batch 1: both axes go to the sequence (context parallelism)."""
    r = decode_rules(mesh, cfg)
    has_pod = "pod" in _mesh_axes(mesh)
    r["batch"] = None
    r["kv_seq"] = ("pod", "data", "model") if has_pod else ("data", "model")
    return r


RULESETS = {
    "train": base_rules,
    "prefill": base_rules,
    "decode": decode_rules,
    "long": long_context_rules,
}

_state = threading.local()


@contextmanager
def use_rules(rules: Rules):
    prev = getattr(_state, "rules", None)
    _state.rules = rules
    try:
        yield
    finally:
        _state.rules = prev


def current_rules() -> Optional[Rules]:
    return getattr(_state, "rules", None)


@contextmanager
def use_mesh(mesh):
    """The mesh ``batch_mean`` reduces over (``launch.mesh.mesh_context``
    enters it)."""
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def current_mesh():
    return getattr(_state, "mesh", None)


def _axis_size(mesh, name) -> int:
    sizes = dict(zip(_mesh_axes(mesh), _mesh_sizes(mesh)))
    try:
        return math.prod(sizes[n] for n in
                         ((name,) if isinstance(name, str) else name))
    except KeyError:
        return 1


def spec_for(axes: Sequence[Optional[str]], rules: Optional[Rules] = None,
             mesh=None, shape=None) -> Spec:
    """Map logical axes to a spec under the active rules. When ``shape``
    is known, an assignment that does not divide evenly is SKIPPED rather
    than consumed — so e.g. an 8-expert dim on a 16-way model axis leaves
    the axis free for the mlp dim behind it."""
    rules = rules or current_rules()
    if rules is None or axes is None:
        return ()
    out, used = [], set()
    for i, ax in enumerate(axes):
        mesh_ax = rules.get(ax) if ax is not None else None
        if mesh_ax is None:
            out.append(None)
            continue
        mesh_ax = tuple(a for a in mesh_ax if a not in used)
        if not mesh_ax:
            out.append(None)
            continue
        if shape is not None and mesh is not None:
            size = _axis_size(mesh, mesh_ax)
            if size <= 0 or shape[i] % max(size, 1) != 0:
                out.append(None)      # leave the mesh axis available
                continue
        used.update(mesh_ax)
        out.append(mesh_ax if len(mesh_ax) > 1 else mesh_ax[0])
    return tuple(out)


def _drop_indivisible(spec: Spec, shape, mesh) -> Spec:
    if mesh is None:
        return spec
    out = []
    for dim, assignment in zip(shape, tuple(spec)
                               + (None,) * (len(shape) - len(spec))):
        if assignment is None:
            out.append(None)
            continue
        size = _axis_size(mesh, assignment)
        out.append(assignment if size > 0 and dim % size == 0 else None)
    return tuple(out)


def is_axes_leaf(x) -> bool:
    """A logical-axes leaf is None or a PLAIN tuple of str/None.
    NamedTuples (``AdamWState`` etc.) fail the exact-type check and recurse
    as tree nodes."""
    return x is None or (type(x) is tuple and all(
        isinstance(e, (str, type(None))) for e in x))


def _is_spec_leaf(x) -> bool:
    """A spec: a PLAIN tuple of None, names and tuples of names."""
    return type(x) is tuple and all(
        e is None or isinstance(e, str)
        or (type(e) is tuple and all(isinstance(n, str) for n in e))
        for e in x)


def _map_axes(fn, axes_tree, shapes_tree=None, is_leaf=is_axes_leaf):
    """fn(axes, shaped) over an axes tree (nested dicts, lists and
    NamedTuples with ``is_leaf`` leaves) and, if given, a tree of tensors
    of its structure (shaped is None without one)."""
    if is_leaf(axes_tree):
        return fn(axes_tree, shapes_tree)
    if isinstance(axes_tree, dict):
        return {k: _map_axes(fn, v, None if shapes_tree is None
                             else shapes_tree[k], is_leaf)
                for k, v in axes_tree.items()}
    parts = [_map_axes(fn, v, None if shapes_tree is None else shapes_tree[i],
                       is_leaf)
             for i, v in enumerate(axes_tree)]
    if hasattr(axes_tree, "_fields"):
        return type(axes_tree)(*parts)
    return type(axes_tree)(parts)


def make_specs(axes_tree, mesh, rules: Optional[Rules] = None,
               shapes_tree=None):
    """Spec tree; with ``shapes_tree`` (tensors, or anything with
    ``.shape``, of the axes tree's structure) indivisible dims are dropped
    to replication per leaf."""
    rules = rules or base_rules(mesh)
    if shapes_tree is None:
        return _map_axes(lambda axes, _: spec_for(axes, rules, mesh),
                         axes_tree)

    def one(axes, shaped):
        if axes is None:
            return ()
        spec = spec_for(axes, rules, mesh, shape=tuple(shaped.shape))
        return _drop_indivisible(spec, tuple(shaped.shape), mesh)

    return _map_axes(one, axes_tree, shapes_tree)


def placements_for(spec: Spec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: per mesh dimension,
    ``Shard(d)`` if tensor dim d is assigned to it, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    where = {}
    for d, assignment in enumerate(spec):
        if assignment is None:
            continue
        for name in ((assignment,) if isinstance(assignment, str)
                     else assignment):
            where[name] = d
    return tuple(Shard(where[name]) if name in where else Replicate()
                 for name in _mesh_axes(mesh))


def make_shardings(axes_tree, mesh, rules: Optional[Rules] = None,
                   shapes_tree=None):
    """Per leaf, the DTensor placements (one per mesh dimension) of its
    spec: the reference's ``NamedSharding`` tree. With ``shapes_tree``,
    indivisible dims fall back to replication."""
    specs = make_specs(axes_tree, mesh, rules, shapes_tree)
    return _map_axes(lambda spec, _: placements_for(spec, mesh), specs,
                     is_leaf=_is_spec_leaf)


def constrain(x, *axes):
    """A DTensor redistributed to the placements its logical axes give
    under the active rules (the reference's ``with_sharding_constraint``);
    the identity outside a rule set and on a plain tensor.
    Divisibility-aware, as ``spec_for`` with a shape."""
    rules = current_rules()
    if rules is None or not _is_dtensor(x):
        return x
    mesh = x.device_mesh
    spec = spec_for(axes, rules, mesh, shape=tuple(x.shape))
    return x.redistribute(mesh, placements_for(spec, mesh))


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def batch_group():
    """(process group, size) of the current mesh's dimensions that the
    active rules give the "batch" axis; (None, 1) outside a mesh and rule
    set or where those dimensions hold one rank."""
    mesh, rules = current_mesh(), current_rules()
    if mesh is None or rules is None or not rules.get("batch"):
        return None, 1
    names = tuple(a for a in rules["batch"] if a in _mesh_axes(mesh))
    size = _axis_size(mesh, names) if names else 1
    if size == 1:
        return None, 1
    sub = mesh[names]
    if len(names) > 1:
        sub = sub._flatten()
    return sub.get_group(), size


def shard_full(t: torch.Tensor, mesh, placements):
    """The DTensor on ``mesh`` with ``placements`` whose local shard this
    rank cuts from ``t``, the full tensor, which every rank holds alike (no
    communication)."""
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False).redistribute(mesh, placements)


def gather(tree):
    """``tree`` (nested dicts and lists) with every DTensor leaf gathered
    whole for use, FSDP-style; plain tensors pass unchanged. Called where
    the model reads a layer's leaves, so inside the layer's remat a leaf
    is gathered again in the backward rather than kept. The gradient of a
    gathered leaf goes back onto the leaf's own placements: summed over
    the mesh dimensions that the active rules give the "batch" axis (their
    ranks hold other rows: a reduce-scatter onto a Shard, an all-reduce
    onto a Replicate), and cut to this rank's shard over the others, whose
    ranks computed alike. On a mesh of one rank the gathered tensor is the
    leaf's own storage."""
    if isinstance(tree, dict):
        return {k: gather(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [gather(v) for v in tree]
    if not _is_dtensor(tree):
        return tree
    from torch.distributed.tensor import Partial, Replicate
    rules = current_rules() or {}
    batch = rules.get("batch") or ()
    mesh = tree.device_mesh
    return tree.full_tensor(grad_placements=[
        Partial() if name in batch and size > 1 else Replicate()
        for name, size in zip(mesh.mesh_dim_names, mesh.shape)])


def batch_shards() -> int:
    """How many slices the batch is split into across ranks (1 outside a
    mesh)."""
    return batch_group()[1]


class _BatchMean(torch.autograd.Function):
    """Forward: the mean over the batch's ranks (an all-reduce). Backward:
    this rank's share, 1/n of the incoming gradient; the step sums the
    ranks' gradients, so the whole derivative is counted once."""

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.n = n
        y = x.detach().clone()
        torch.distributed.all_reduce(y, group=group)
        return y / n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the ranks that hold slices of the batch,
    with x a mean over this rank's slice (slices of one size); ``x`` itself
    outside a mesh."""
    group, n = batch_group()
    if group is None:
        return x
    return _BatchMean.apply(x, group, n)
