"""Optimizers — port of ``repro.optim``: AdamW (``optim.adamw``) and the
int8 gradient compression of the data-parallel all-reduce
(``optim.grad_compress``)."""
from . import adamw, grad_compress
from .adamw import AdamWConfig, AdamWState

__all__ = ["AdamWConfig", "AdamWState", "adamw", "grad_compress"]
