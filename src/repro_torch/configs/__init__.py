"""Assigned-architecture registry: ``get_config(arch_id)`` / ``list_archs()``.

The port's own copy of ``repro.configs`` (pure Python, no JAX): the same
ten configurations field for field, pinned to the reference by
``tests/test_torch_configs.py``.

One module per architecture; exact dims from the assignment table (sources
cited per file). Every config is selectable via ``--arch <id>`` in the
launchers.
"""
from __future__ import annotations

from typing import Dict, List

from .base import ModelConfig

_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> List[str]:
    return sorted(_REGISTRY)


# import order registers everything
from . import nemotron_4_15b        # noqa: E402,F401
from . import qwen1_5_4b            # noqa: E402,F401
from . import command_r_plus_104b   # noqa: E402,F401
from . import granite_34b           # noqa: E402,F401
from . import jamba_1_5_large_398b  # noqa: E402,F401
from . import llama4_maverick_400b  # noqa: E402,F401
from . import mixtral_8x22b         # noqa: E402,F401
from . import musicgen_medium       # noqa: E402,F401
from . import internvl2_26b         # noqa: E402,F401
from . import rwkv6_7b              # noqa: E402,F401
