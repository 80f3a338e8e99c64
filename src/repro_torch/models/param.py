"""Parameter initialisers — port of the init helpers of
``repro.models.param``.

Parameters are plain tensors in nested dictionaries with the reference's
names and shapes. Where the reference's ``Boxed`` / ``split`` /
``prefix_axes`` carry logical sharding axes on every leaf, each model
module here keeps a table of its init function's axes beside it
(``layers.NORM_AXES``, ``attention.ATTENTION_AXES``, ...), and
``transformer.param_axes(cfg)`` pairs the tables with the tree that
``init_model`` builds on the meta device, raising if a leaf has no axes or
axes of another rank: the init is the one source of the tree.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

_SQRT2 = math.sqrt(2.0)


def _norm_cdf(x: float) -> float:
    return 0.5 * (1.0 + math.erf(x / _SQRT2))


def dense_init(gen: torch.Generator, shape: Sequence[int], dtype: torch.dtype,
               device: torch.device, scale: Optional[float] = None
               ) -> torch.Tensor:
    """Truncated normal on [-2, 2] times ``scale`` (default 1/sqrt(fan_in),
    fan_in = shape[0]), drawn in float32 from ``gen`` by the inverse CDF
    and cast to ``dtype``. The same law as the reference's
    ``jax.random.truncated_normal``; not the same numbers."""
    if scale is None:
        scale = 1.0 / math.sqrt(shape[0])
    lo, hi = 2.0 * _norm_cdf(-2.0) - 1.0, 2.0 * _norm_cdf(2.0) - 1.0
    v = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    v.uniform_(lo, hi, generator=gen).erfinv_().mul_(_SQRT2).clamp_(-2.0, 2.0)
    return v.mul_(scale).to(dtype)


def zeros_init(shape: Sequence[int], dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def ones_init(shape: Sequence[int], dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=dtype, device=device)


def const_init(fill: float, shape: Sequence[int], device: torch.device,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A constant parameter (the reference's ``const_init`` of a filled
    array): float32 unless asked, whatever the model's ``param_dtype``."""
    return torch.full(tuple(shape), fill, dtype=dtype, device=device)
