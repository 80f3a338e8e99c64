"""Rank functions of the port's multi-rank CPU tests, run by
``repro_torch.testing.spawn_world`` (each rank in its own process in one
gloo group). A module of its own, importing torch and ``repro_torch``
only, so the spawned processes need not import JAX; each function hands
its results back as ``torch.save`` files in ``out``."""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.distributed import sharding as shd
from repro_torch.launch import train as launch
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import init_model
from repro_torch.optim import adamw

# the launcher runs of tests/test_torch_train_mesh.py: reduced qwen1.5-4b,
# 3 steps of 4 x 32; the 2x2 run checkpoints after steps 1 and 2, and a
# 1x1 run resumes from step RESUME's
ARCH, STEPS, BATCH, SEQ, RESUME = "qwen1.5-4b", 3, 4, 32, 1
# one step of every reduced config: 4 x 32, frontend embeddings from this
# seed
ONE_STEP_BATCH, FRONTEND_SEED = 4, 5


def launcher_run(mesh, out: str, tag: str, ckpt_dir=None, remat=None,
                 params=None):
    """launch.train on ``mesh`` (the config's remat policy replaced by
    ``remat`` if given; from ``params`` if given, else the launcher's own
    init); rank 0 saves the history and the gathered state under
    ``out/{tag}.pt``. Returns the state."""
    cfg = launch.train_config(ARCH, True, SEQ)
    if remat is not None:
        cfg = cfg.scaled(remat=remat)
    params, state, hist = launch.train(
        cfg, steps=STEPS, batch=BATCH, seq=SEQ, device="cpu", mesh=mesh,
        params=params,
        ckpt_every=1 if ckpt_dir else STEPS + 1,
        ckpt_dir=ckpt_dir or os.path.join(out, f"ck_{tag}"),
        log=lambda *_: None)
    full_p, full_o = launch.gather_state(params, state)
    if dist.get_rank() == 0:
        torch.save({"params": full_p, "state": full_o, "history": hist},
                   os.path.join(out, f"{tag}.pt"))
    return params, state


def one_step_batch(cfg):
    """The global batch of the one-step runs: step 0 of SyntheticLM, and
    frontend embeddings where the config has a frontend."""
    b = SyntheticLM(DataConfig(cfg.vocab_size, SEQ, ONE_STEP_BATCH,
                               seed=0)).global_batch(0)
    b = {k: torch.as_tensor(v) for k, v in b.items()}
    if cfg.frontend != "none":
        rng = np.random.default_rng(FRONTEND_SEED)
        b["frontend_embeds"] = torch.as_tensor(rng.normal(
            0, 1, (ONE_STEP_BATCH, cfg.n_frontend_tokens, cfg.d_frontend)
        ).astype(np.float32))
    return b


def one_step_config(arch: str):
    return get_config(arch).reduced().scaled(loss_chunk=min(64, SEQ))


def one_step(arch: str, mesh):
    """One make_train_step of reduced ``arch`` on ``mesh`` from
    init_model seed 0; returns (metrics as floats, gathered params)."""
    cfg = one_step_config(arch)
    params = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    params, state = launch.place_state(cfg, params, adamw.init(params),
                                       mesh)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=3)
    step = make_train_step(cfg, opt_cfg, mesh=mesh)
    d = mesh.get_local_rank("data")
    per = ONE_STEP_BATCH // mesh.size(0)
    batch = {k: v[d * per:(d + 1) * per]
             for k, v in one_step_batch(cfg).items()}
    params, state, metrics = step(params, state, batch)
    full_p, _ = launch.gather_state(params, state)
    return {k: float(v) for k, v in metrics.items()}, full_p


def local_bytes(params, state) -> dict:
    """This rank's bytes of the parameters and moments, and each leaf's
    (local shape, global shape, placements)."""
    leaves = adamw.tree_leaves(params) + adamw.tree_leaves(state.m) \
        + adamw.tree_leaves(state.v)
    return {"bytes": sum(t.to_local().numel() * t.element_size()
                         for t in leaves),
            "leaves": [(tuple(t.to_local().shape), tuple(t.shape),
                        tuple(str(p) for p in t.placements))
                       for t in leaves]}


def world_two(rank, world, out):
    """2x1 and 1x2 launcher runs, and a 2x1 run under remat "full" (each
    layer's leaves gathered again in the backward)."""
    for shape in ((2, 1), (1, 2)):
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        launcher_run(mesh, out, "x".join(map(str, shape)))
    launcher_run(make_mesh((2, 1), ("data", "model"), "cpu"), out,
                 "2x1-remat-full", remat="full")


def world_four_from(rank, world, out, params):
    """The 2x2 launcher run from the given full ``params``. The spawned
    ranks receive them in shared memory, and the update writes a
    replicated leaf in place, so each rank trains its own copy."""
    launcher_run(make_mesh((2, 2), ("data", "model"), "cpu"), out,
                 "2x2-from", params=adamw.tree_map(torch.clone, params))


def world_four(rank, world, out, archs):
    """The 2x2 launcher run (with checkpoints), each rank's local bytes,
    and one step of every config in ``archs``."""
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    params, state = launcher_run(mesh, out, "2x2",
                                 ckpt_dir=os.path.join(out, "ck_2x2"))
    torch.save(local_bytes(params, state),
               os.path.join(out, f"bytes_{rank}.pt"))
    res = {arch: one_step(arch, mesh) for arch in archs}
    if rank == 0:
        torch.save(res, os.path.join(out, "one_step_2x2.pt"))


def world_one(rank, world, out):
    """Restore the 2x2 run's checkpoint of step RESUME into a 1x1 run for
    the steps after it; then a 2x1 mesh in this world of one must
    raise."""
    from repro_torch.checkpoint import checkpoint as ckpt
    cfg = launch.train_config(ARCH, True, SEQ)
    like_p = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    like = {"p": like_p, "o": adamw.init(like_p)}
    step, tree, _ = ckpt.load(os.path.join(out, "ck_2x2",
                                           f"step_{RESUME:08d}"), like)
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    params, state, hist = launch.train(
        cfg, steps=STEPS - 1 - step, batch=BATCH, seq=SEQ, device="cpu",
        mesh=mesh, params=tree["p"], opt_state=tree["o"],
        first_step=step + 1, total_steps=STEPS, ckpt_every=STEPS + 1,
        ckpt_dir=os.path.join(out, "ck_1x1"), log=lambda *_: None)
    full_p, _ = launch.gather_state(params, state)
    try:
        make_mesh((2, 1), ("data", "model"), "cpu")
        raised = None
    except ValueError as e:
        raised = str(e)
    torch.save({"step": step, "restored": tree, "params": full_p,
                "history": hist, "mismatch": raised},
               os.path.join(out, "restored_1x1.pt"))


def psum_ranks(rank, world, out, g, tree):
    """compressed_psum of row ``rank`` of ``g`` from a zero error, and
    tree_compressed_psum of this rank's slice of every leaf of ``tree``."""
    from repro_torch.optim import grad_compress as gc
    out_g, err = gc.compressed_psum(g[rank], torch.zeros_like(
        g[rank], dtype=torch.float32))
    mine = adamw.tree_map(lambda t: t[rank], tree)
    sums, state = gc.tree_compressed_psum(mine, gc.init_state(mine))
    torch.save({"out": out_g, "err": err, "tree": sums,
                "tree_err": state.error},
               os.path.join(out, f"psum_{rank}.pt"))


def pipeline_ranks(rank, world, out, cases):
    """pipeline_apply on each case: (mesh shape, mesh axes, Ws, x)."""
    from repro_torch.distributed.pipeline_parallel import pipeline_apply
    res = []
    for shape, axes, Ws, x in cases:
        mesh = make_mesh(shape, axes, "cpu")
        res.append(pipeline_apply(lambda W, x: torch.tanh(x @ W), Ws, x,
                                  mesh=mesh, n_stages=Ws.shape[0]))
    torch.save(res, os.path.join(out, f"pipe_{rank}.pt"))


def reshard_ranks(rank, world, out, arch):
    """Reduced ``arch``'s parameters placed on a 2x2 mesh, then
    ``reshard_params`` onto 4x1; and ``constrain`` on a DTensor."""
    from repro_torch.distributed.elastic import reshard_params
    from repro_torch.models import param_axes
    cfg = get_config(arch).reduced()
    full = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    axes = param_axes(cfg)
    old = make_mesh((2, 2), ("data", "model"), "cpu")
    new = make_mesh((4, 1), ("data", "model"), "cpu")
    old_rules, new_rules = shd.base_rules(old, cfg), shd.base_rules(new, cfg)
    placed = adamw.tree_map(lambda t, pl: shd.shard_full(t, old, pl), full,
                            shd.make_shardings(axes, old, old_rules, full))
    moved = reshard_params(placed, old, new, axes, new_rules)
    want = shd.make_specs(axes, new, new_rules, full)
    leaves = list(zip(adamw.tree_leaves(moved), adamw.tree_leaves(want)))
    t = shd.shard_full(full["embed"]["table"], old,
                       shd.placements_for((None, None), old))
    with shd.use_rules(old_rules):
        constrained = shd.constrain(t, "vocab", "embed")
    torch.save({
        "full": adamw.tree_map(lambda t: t.full_tensor(), moved),
        "local": [(tuple(t.to_local().shape), tuple(t.shape), spec,
                   t.device_mesh is new) for t, spec in leaves],
        "constrained": (tuple(str(p) for p in constrained.placements),
                        tuple(constrained.to_local().shape))},
        os.path.join(out, f"reshard_{rank}.pt"))
