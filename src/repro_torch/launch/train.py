"""Training launcher — port of ``repro.launch.train``.

    python -m repro_torch.launch.train --arch qwen1.5-4b --steps 100 \
        [--reduced | --full] [--batch 8] [--seq 128] [--lr 1e-3] \
        [--ckpt-dir DIR] [--ckpt-every 50] [--device cuda|cpu] \
        [--mesh DATAxMODEL]
    torchrun --nproc-per-node N -m repro_torch.launch.train --mesh DxM ...

The reference's defaults (the reduced config with ``loss_chunk`` cut to
``min(64, seq)``, AdamW with 20 warmup steps over ``--steps``, the
synthetic Zipf stream of ``data.pipeline`` from seed 0, an async
checkpoint every ``--ckpt-every`` steps, two kept). It runs on the card by
default and raises without one unless given ``--device cpu``. The
checkpoints go under ``build/repro_torch_train/`` at the repository root
unless ``--ckpt-dir`` says otherwise.

``--mesh DxM`` trains on a ("data", "model") mesh of D·M ranks (under
``torchrun --nproc-per-node D·M``; ``--mesh 1x1`` without torchrun starts a
world of one itself), NCCL on the card and gloo with ``--device cpu``. The
parameters and both AdamW moments are DTensors placed by
``sharding.make_shardings(param_axes(cfg), mesh, base_rules(mesh, cfg),
...)`` and ``adamw.state_axes`` (the reference's ``param_sh`` /
``opt_sh``); data rank r takes ``SyntheticLM.shard_batch(step, r, D)``;
the step is ``steps.make_train_step(..., mesh=)``, which gathers each
layer's parameters at use and reduce-scatters their gradients.
Checkpoints hold full tensors, written by rank 0 alone, so a run on one
mesh resumes on another. Without ``--mesh`` the loop runs on one device
with plain tensors (the reference's default is ``--mesh 1x1``, which
computes the same). The reference's docstring names ``--policy`` and
``--compress-grads``; its parser has neither, and neither has this one.

``train()`` is the loop, for callers that time it (``chip_smoke.py``).
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..checkpoint import checkpoint as ckpt
from ..configs import get_config, list_archs
from ..configs.base import ModelConfig
from ..data.pipeline import DataConfig, SyntheticLM
from ..device import DeviceLike, resolve_device
from ..distributed import sharding as shd
from ..models import init_model, param_axes
from ..optim import adamw
from .steps import make_train_step

DEFAULT_CKPT_DIR = (Path(__file__).resolve().parents[3] / "build"
                    / "repro_torch_train")


def train_config(arch: str, reduced: bool, seq: int) -> ModelConfig:
    """The config the launcher trains: the reduced one has its loss chunk
    cut to min(64, seq), as in the reference."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced().scaled(loss_chunk=min(64, seq))
    return cfg


@torch.no_grad()
def place_state(cfg: ModelConfig, params, opt_state, mesh):
    """The parameters and AdamW moments as DTensors on ``mesh``, placed by
    ``make_shardings`` of ``param_axes(cfg)`` and ``adamw.state_axes``
    under ``base_rules(mesh, cfg)``; full tensors (alike on every rank) are
    cut to this rank's shards, and DTensors are kept. The step counter
    stays a plain tensor."""
    from torch.distributed.tensor import DTensor
    axes = param_axes(cfg)
    state_sh = shd.make_shardings(adamw.state_axes(axes), mesh,
                                  shd.base_rules(mesh, cfg), opt_state)

    def place(t, placements):
        return t if isinstance(t, DTensor) else shd.shard_full(
            t, mesh, placements)

    zipped = lambda tree, sh: adamw.tree_map(place, tree, sh)
    return (zipped(params, state_sh.m),
            adamw.AdamWState(opt_state.step, zipped(opt_state.m, state_sh.m),
                             zipped(opt_state.v, state_sh.v)))


@torch.no_grad()
def gather_state(params, opt_state):
    """Full tensors of a placed state (a collective: every rank calls it)."""
    full = lambda tree: adamw.tree_map(lambda t: t.full_tensor(), tree)
    return full(params), adamw.AdamWState(opt_state.step, full(opt_state.m),
                                          full(opt_state.v))


def train(cfg: ModelConfig, *, steps: int, batch: int, seq: int,
          lr: float = 1e-3, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 50, device: DeviceLike = None, seed: int = 0,
          params=None, opt_state=None, first_step: int = 0,
          total_steps: Optional[int] = None, log: Callable = print,
          on_step: Optional[Callable] = None, mesh=None):
    """Train ``cfg`` for ``steps`` steps from ``first_step`` on
    ``SyntheticLM`` batches (B = ``batch``, S = ``seq``, seed ``seed``).
    ``params`` and ``opt_state`` default to ``init_model`` from
    ``torch.Generator(device).manual_seed(seed)`` and ``adamw.init``; the
    schedule spans ``total_steps`` (default ``steps``). A checkpoint of
    {"p": params, "o": opt_state} is written asynchronously after every
    step s > 0 with s % ckpt_every == 0 (``ckpt_dir``, default
    ``DEFAULT_CKPT_DIR``); an exception out of the loop (a failure, or
    one that ``on_step`` raises) first lets the checkpoint in flight
    commit. ``on_step(step, metrics, seconds)`` is called
    after each step, seconds being its wall time with the device drained.
    Returns (params, opt_state, history): history holds one dict a step
    (step, loss, xent, aux, grad_norm, lr, seconds, peak_gib on a CUDA
    device).

    With ``mesh`` (a DeviceMesh with a "data" dimension, on ``device``'s
    type) the state is placed by ``place_state``, each step runs
    ``make_train_step(..., mesh=mesh)`` on this data rank's
    ``shard_batch``, checkpoints hold the gathered full
    tensors and only global rank 0 writes them (and logs), and the
    returned parameters and moments are DTensors. ``params`` and
    ``opt_state`` may then be full tensors (as a checkpoint restores them)
    or DTensors on ``mesh``."""
    dev = resolve_device(device)
    if params is None:
        params = init_model(cfg, torch.Generator(device=dev).manual_seed(seed),
                            dev)
    if opt_state is None:
        opt_state = adamw.init(params)
    opt_cfg = adamw.AdamWConfig(lr=lr, warmup_steps=20,
                                total_steps=total_steps or steps)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch, seed=seed))
    step_fn = make_train_step(cfg, opt_cfg, mesh=mesh)
    get_batch, writer = data.global_batch, True
    if mesh is not None:
        params, opt_state = place_state(cfg, params, opt_state, mesh)
        d_rank = mesh.get_local_rank("data")
        d_size = mesh.size(mesh.mesh_dim_names.index("data"))
        get_batch = lambda s: data.shard_batch(s, d_rank, d_size)
        writer = dist.get_rank() == 0
        if not writer:
            log = lambda *_: None
    saver = (ckpt.AsyncCheckpointer(str(ckpt_dir or DEFAULT_CKPT_DIR),
                                    keep=2) if writer else None)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    history = []
    t0 = time.perf_counter()
    try:
        for step in range(first_step, first_step + steps):
            b = get_batch(step)
            batch_t = {k: torch.as_tensor(v, device=dev)
                       for k, v in b.items()}
            sync()
            s0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch_t)
            sync()
            seconds = time.perf_counter() - s0
            rec = {"step": step,
                   **{k: float(v) for k, v in metrics.items()},
                   "seconds": seconds}
            if dev.type == "cuda":
                rec["peak_gib"] = (torch.cuda.max_memory_allocated(dev)
                                   / 2**30)
            history.append(rec)
            if on_step is not None:
                on_step(step, metrics, seconds)
            last = first_step + steps - 1
            if step % 20 == 0 or step == last:
                rate = (step - first_step + 1) / (time.perf_counter() - t0)
                log(f"step {step:4d} loss={rec['loss']:7.4f} "
                    f"lr={rec['lr']:.2e} {rate:5.2f} it/s"
                    + (f" peak={rec['peak_gib']:.2f}GiB"
                       if "peak_gib" in rec else ""))
            if step > 0 and step % ckpt_every == 0:
                tree = ({"p": params, "o": opt_state} if mesh is None
                        else dict(zip("po", gather_state(params,
                                                         opt_state))))
                if writer:
                    saver.save(step, tree, extra={"loss": rec["loss"]})
                del tree
    finally:
        # a failure in the loop still commits the checkpoint in flight
        if writer:
            saver.wait()
    if mesh is not None:
        dist.barrier()
    return params, opt_state, history


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen1.5-4b", choices=list_archs())
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT_DIR))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--mesh", default=None,
                    help="DATAxMODEL, e.g. 2x2 (D·M ranks, under torchrun "
                         "past 1x1); default: one device, no mesh")
    args = ap.parse_args(argv)

    cfg = train_config(args.arch, args.reduced, args.seq)
    dev = resolve_device(args.device)
    if args.mesh is None:
        print(f"[launch] arch={cfg.name} device={dev}")
        train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
              lr=args.lr, ckpt_dir=args.ckpt_dir,
              ckpt_every=args.ckpt_every, device=dev)
        print("[launch] done")
        return
    from .mesh import init_distributed, make_mesh
    shape = tuple(int(v) for v in args.mesh.split("x"))
    dev = init_distributed(dev)
    try:
        mesh = make_mesh(shape, ("data", "model"), dev)
        rank0 = dist.get_rank() == 0
        if rank0:
            print(f"[launch] arch={cfg.name} device={dev} mesh="
                  f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}")
        train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
              lr=args.lr, ckpt_dir=args.ckpt_dir,
              ckpt_every=args.ckpt_every, device=dev, mesh=mesh)
        if rank0:
            print("[launch] done")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
