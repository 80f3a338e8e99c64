"""Optimizers — port of ``repro.optim``: AdamW (``optim.adamw``). The
reference's ``grad_compress`` serves the data-parallel all-reduce and waits
for ``distributed/``."""
from . import adamw
from .adamw import AdamWConfig, AdamWState

__all__ = ["AdamWConfig", "AdamWState", "adamw"]
