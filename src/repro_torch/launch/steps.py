"""Serving step functions — port of ``make_prefill_step`` and
``make_decode_step`` of ``repro.launch.steps``.

Where the reference jits each step with explicit shardings, these run
eagerly under ``torch.inference_mode()`` (no autograd records; the caches
are inference tensors). They serve every registered config: the dense
and MoE attention models (qwen1.5-4b, nemotron-4-15b, command-r-plus-104b,
granite-34b, musicgen-medium, mixtral-8x22b, llama4-maverick-400b-a17b),
the attention/Mamba hybrid (jamba-1.5-large-398b), RWKV6 (rwkv6-7b) and
the vision model (internvl2-26b, whose prefill batch carries
``frontend_embeds`` beside ``tokens``; the batch is passed on unchanged).
KV caches are written in place; RWKV and Mamba state caches are replaced
in the list the step returns. ``make_train_step`` waits for the training
slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ModelConfig
from ..models import decode_step as model_decode_step
from ..models import prefill as model_prefill


def make_prefill_step(cfg: ModelConfig, s_max: int,
                      use_kernel: Optional[bool] = None):
    def prefill_step(params, batch):
        with torch.inference_mode():
            return model_prefill(cfg, params, batch, s_max=s_max,
                                 use_kernel=use_kernel)

    return prefill_step


def make_decode_step(cfg: ModelConfig, use_kernel: Optional[bool] = None):
    def serve_step(params, caches, tokens, pos):
        with torch.inference_mode():
            return model_decode_step(cfg, params, caches, tokens, pos,
                                     use_kernel=use_kernel)

    return serve_step
