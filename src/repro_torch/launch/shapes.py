"""Assigned input shapes and abstract inputs for every (arch x shape)
dry-run cell — port of ``repro.launch.shapes``. The inputs are meta
tensors (shapes and dtypes, no memory) where the reference has
``ShapeDtypeStruct``s; a decode cell's caches are ``init_caches`` on the
meta device, one cache per layer (the port's layout)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from ..configs.base import ModelConfig
from ..models import cache_axes, init_caches


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    batch: int
    long: bool = False


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1, long=True),
}


def cell_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Optional[str]:
    """None if the cell runs; otherwise the documented skip reason."""
    if shape.long and not cfg.sub_quadratic:
        return ("long_500k requires sub-quadratic attention; "
                f"{cfg.name} is pure full-attention (skip per assignment)")
    return None


def ruleset_name(shape: ShapeSpec) -> str:
    if shape.kind == "train":
        return "train"
    if shape.kind == "prefill":
        return "prefill"
    return "long" if shape.long else "decode"


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec):
    """Abstract batch for the step function of this cell, as meta tensors.
    For decode this includes the KV/state caches (``init_caches`` on the
    meta device: no memory)."""
    B, S = shape.batch, shape.seq
    tok = lambda s: _meta(s, torch.int32)
    if shape.kind in ("train", "prefill"):
        batch = {"tokens": tok((B, S))}
        if shape.kind == "train":
            batch["labels"] = tok((B, S))
        if cfg.frontend == "vision":
            batch["frontend_embeds"] = _meta(
                (B, cfg.n_frontend_tokens, cfg.d_frontend), torch.bfloat16)
        return {"batch": batch}
    # decode: one new token against a seq-long cache
    return {"caches": init_caches(cfg, B, S, torch.bfloat16, device="meta"),
            "tokens": tok((B, 1)),
            "pos": _meta((), torch.int32)}


def batch_axes(cfg: ModelConfig, shape: ShapeSpec):
    """Logical axes for the abstract inputs above."""
    if shape.kind in ("train", "prefill"):
        axes = {"tokens": ("batch", "seq")}
        if shape.kind == "train":
            axes["labels"] = ("batch", "seq")
        if cfg.frontend == "vision":
            axes["frontend_embeds"] = ("batch", None, "frontend")
        return {"batch": axes}
    return {"caches": cache_axes(cfg),
            "tokens": ("batch", None),
            "pos": None}
