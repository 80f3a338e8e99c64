"""Step functions — port of ``repro.launch.steps``: ``make_train_step``,
``make_prefill_step`` and ``make_decode_step``.

The train step takes the value and gradient of ``loss_fn`` by autograd and
then one in-place ``optim.adamw.update``. It runs the plain route by
default (``use_kernel=False``), as the reference's ``use_pallas=False``:
the kernels have no backward, and a kernel asked to launch under autograd
raises.

Where the reference jits each step with explicit shardings, these run
eagerly. With ``mesh=`` (a ("data", "model") or ("pod", "data", "model")
DeviceMesh) each step runs on a mesh, the parameters held as DTensors
(see ``make_train_step``'s docstring and the paragraph below); the
serving steps under ``torch.inference_mode()`` (no autograd records; the caches
are inference tensors). They serve every registered config: the dense
and MoE attention models (qwen1.5-4b, nemotron-4-15b, command-r-plus-104b,
granite-34b, musicgen-medium, mixtral-8x22b, llama4-maverick-400b-a17b),
the attention/Mamba hybrid (jamba-1.5-large-398b), RWKV6 (rwkv6-7b) and
the vision model (internvl2-26b, whose prefill batch carries
``frontend_embeds`` beside ``tokens``; the batch is passed on unchanged).
KV caches are written in place; RWKV and Mamba state caches are replaced
in the list the step returns.

The serving steps on a mesh: the parameters are DTensors placed by
``sharding.make_shardings(param_axes(cfg), mesh, rules, ...)``, and a step
runs on this rank's rows of the batch: the ranks of the mesh dimensions
that ``rules`` give the "batch" axis hold its slices (a rule set that maps
"batch" to nothing, as ``long_context_rules`` does, leaves every rank the
whole batch). ``rules`` default to the reference's rule set for the step
(``sharding.RULESETS``: ``base_rules`` for prefill, ``decode_rules`` for
decode). As in the train step, the model gathers each layer's leaves
whole where it reads them (``sharding.gather``) and runs FSDP-style: the
caches hold this rank's rows, whole along the sequence, and the ranks of
the other dimensions compute alike. The function is the one-device
step's on those rows; the MoE FFN's dropless test reads the whole batch
(``sharding.batch_shards``). The reference's decode rules split the KV
sequence over "model"; that is sharded compute (tensor and sequence
parallelism) and is not done here.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from ..configs.base import ModelConfig
from ..distributed import sharding as shd
from ..models import decode_step as model_decode_step
from ..models import loss_fn
from ..models import prefill as model_prefill
from ..optim import adamw


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    use_kernel: Optional[bool] = False, mesh=None):
    """train_step(params, opt_state, batch) -> (params, opt_state, metrics):
    the loss and its gradient with respect to every parameter leaf, then
    AdamW, which updates ``params`` and the moments in place and lets each
    gradient go once its leaf is updated. metrics: loss, xent, aux,
    grad_norm, lr (0-dim float32 tensors on the parameters' device).

    With ``mesh`` (a ("data", "model") DeviceMesh) the parameters and
    moments are DTensors placed by ``sharding.make_shardings`` under
    ``base_rules(mesh, cfg)``, and ``batch`` is this rank's slice of the
    global batch (its rows split over the "data" dimension). The function
    is the reference's: the loss and gradients of the global batch, then
    AdamW. FSDP-style, the model gathers each layer's leaves whole where it
    reads them (``sharding.gather``; under remat "full" again in the
    backward) and runs on this rank's rows under
    ``launch.mesh.mesh_context``, where the loss's mean and the MoE aux
    loss read the whole batch (``sharding.batch_mean``). Each leaf's
    gradient comes back reduce-scattered over "data" onto its shards; the
    clip norm is ``adamw.global_norm`` of the shards, and AdamW updates
    each rank's shards of the parameters and moments in place. A rank
    holds only its shards between steps. The ranks of the "model"
    dimension compute the same thing on the gathered leaves: sharded
    compute over "model" (tensor parallelism) is not done here."""
    scope = _mesh_scope(mesh, shd.base_rules, cfg, None)

    def train_step(params, opt_state, batch):
        leaves = adamw.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        with scope():
            loss, metrics = loss_fn(cfg, params, batch, use_kernel=use_kernel)
            grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        del leaves
        gnorm = adamw.global_norm(grads)
        slot = iter(grads)
        del grads
        with torch.no_grad():
            grad_tree = adamw.tree_map(lambda _: _local(next(slot)), params)
            del slot
            local = lambda tree: adamw.tree_map(_local, tree)
            _, state, om = adamw.update(
                opt_cfg, grad_tree,
                adamw.AdamWState(opt_state.step, local(opt_state.m),
                                 local(opt_state.v)),
                local(params), grad_norm=gnorm)
        return params, adamw.AdamWState(state.step, opt_state.m,
                                        opt_state.v), {
            "loss": loss.detach(),
            **{k: v.detach() for k, v in metrics.items()}, **om}

    return train_step


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's shard on this rank; a plain tensor itself."""
    return t.to_local() if hasattr(t, "to_local") else t


def _mesh_scope(mesh, default_rules, cfg: ModelConfig, rules):
    """A context factory: nothing without ``mesh``; else
    ``launch.mesh.mesh_context(mesh)`` under ``rules`` (default
    ``default_rules(mesh, cfg)``)."""
    if mesh is None:
        return contextlib.nullcontext
    from .mesh import mesh_context
    rules = rules if rules is not None else default_rules(mesh, cfg)

    @contextlib.contextmanager
    def scope():
        with mesh_context(mesh), shd.use_rules(rules):
            yield

    return scope


def make_prefill_step(cfg: ModelConfig, s_max: int,
                      use_kernel: Optional[bool] = None, mesh=None,
                      rules=None):
    """prefill_step(params, batch) -> (last logits (B, V), caches):
    ``models.prefill`` with a KV capacity of ``s_max``; on ``mesh`` under
    ``rules`` (default ``base_rules``) as the module docstring says."""
    scope = _mesh_scope(mesh, shd.base_rules, cfg, rules)

    def prefill_step(params, batch):
        with torch.inference_mode(), scope():
            return model_prefill(cfg, params, batch, s_max=s_max,
                                 use_kernel=use_kernel)

    return prefill_step


def make_decode_step(cfg: ModelConfig, use_kernel: Optional[bool] = None,
                     mesh=None, rules=None):
    """serve_step(params, caches, tokens, pos) -> (logits (B, V), caches):
    one ``models.decode_step`` at position ``pos`` (a Python int); on
    ``mesh`` under ``rules`` (default ``decode_rules``) as the module
    docstring says."""
    scope = _mesh_scope(mesh, shd.decode_rules, cfg, rules)

    def serve_step(params, caches, tokens, pos):
        with torch.inference_mode(), scope():
            return model_decode_step(cfg, params, caches, tokens, pos,
                                     use_kernel=use_kernel)

    return serve_step
