"""Training launcher — port of ``repro.launch.train`` for one device.

    python -m repro_torch.launch.train --arch qwen1.5-4b --steps 100 \
        [--reduced | --full] [--batch 8] [--seq 128] [--lr 1e-3] \
        [--ckpt-dir DIR] [--ckpt-every 50] [--device cuda|cpu]

The reference's defaults (the reduced config with ``loss_chunk`` cut to
``min(64, seq)``, AdamW with 20 warmup steps over ``--steps``, the
synthetic Zipf stream of ``data.pipeline`` from seed 0, an async
checkpoint every ``--ckpt-every`` steps, two kept). It runs on the card by
default and raises without one unless given ``--device cpu``. There is no
``--mesh``: sharding waits for ``distributed/``. The checkpoints go under
``build/repro_torch_train/`` at the repository root unless ``--ckpt-dir``
says otherwise.

``train()`` is the loop, for callers that time it (``chip_smoke.py``).
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Callable, Optional

import torch

from ..checkpoint import checkpoint as ckpt
from ..configs import get_config, list_archs
from ..configs.base import ModelConfig
from ..data.pipeline import DataConfig, SyntheticLM
from ..device import DeviceLike, resolve_device
from ..models import init_model
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


def train(cfg: ModelConfig, *, steps: int, batch: int, seq: int,
          lr: float = 1e-3, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 50, device: DeviceLike = None, seed: int = 0,
          params=None, opt_state=None, first_step: int = 0,
          total_steps: Optional[int] = None, log: Callable = print,
          on_step: Optional[Callable] = None):
    """Train ``cfg`` for ``steps`` steps from ``first_step`` on
    ``SyntheticLM`` batches (B = ``batch``, S = ``seq``, seed ``seed``).
    ``params`` and ``opt_state`` default to ``init_model`` from
    ``torch.Generator(device).manual_seed(seed)`` and ``adamw.init``; the
    schedule spans ``total_steps`` (default ``steps``). A checkpoint of
    {"p": params, "o": opt_state} is written asynchronously after every
    step s > 0 with s % ckpt_every == 0 (``ckpt_dir``, default
    ``DEFAULT_CKPT_DIR``). ``on_step(step, metrics, seconds)`` is called
    after each step, seconds being its wall time with the device drained.
    Returns (params, opt_state, history): history holds one dict a step
    (step, loss, xent, aux, grad_norm, lr, seconds, peak_gib on a CUDA
    device)."""
    dev = resolve_device(device)
    if params is None:
        params = init_model(cfg, torch.Generator(device=dev).manual_seed(seed),
                            dev)
    if opt_state is None:
        opt_state = adamw.init(params)
    opt_cfg = adamw.AdamWConfig(lr=lr, warmup_steps=20,
                                total_steps=total_steps or steps)
    step_fn = make_train_step(cfg, opt_cfg)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch, seed=seed))
    saver = ckpt.AsyncCheckpointer(str(ckpt_dir or DEFAULT_CKPT_DIR), keep=2)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    history = []
    t0 = time.perf_counter()
    for step in range(first_step, first_step + steps):
        b = data.global_batch(step)
        batch_t = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
        sync()
        s0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch_t)
        sync()
        seconds = time.perf_counter() - s0
        rec = {"step": step, **{k: float(v) for k, v in metrics.items()},
               "seconds": seconds}
        if dev.type == "cuda":
            rec["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        history.append(rec)
        if on_step is not None:
            on_step(step, metrics, seconds)
        last = first_step + steps - 1
        if step % 20 == 0 or step == last:
            log(f"step {step:4d} loss={rec['loss']:7.4f} "
                f"lr={rec['lr']:.2e} "
                f"{(step - first_step + 1) / (time.perf_counter() - t0):5.2f}"
                f" it/s")
        if step > 0 and step % ckpt_every == 0:
            saver.save(step, {"p": params, "o": opt_state},
                       extra={"loss": rec["loss"]})
    saver.wait()
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
    args = ap.parse_args(argv)

    cfg = train_config(args.arch, args.reduced, args.seq)
    dev = resolve_device(args.device)
    print(f"[launch] arch={cfg.name} device={dev}")
    train(cfg, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
          ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, device=dev)
    print("[launch] done")


if __name__ == "__main__":
    main()
