"""Mixtral 8x22B [arXiv:2401.04088]: 56L, d_model 6144, 48 heads (GQA kv=8),
expert d_ff 16384, vocab 32768 — 8 experts top-2 every layer, sliding-window
attention (4096). Sub-quadratic via SWA ring-buffer KV (runs long_500k)."""
from . import register
from .base import ModelConfig

CONFIG = register(ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=16384,
    vocab_size=32768,
    activation="swiglu",
    window=4096,
    ffn_pattern=("moe",),
    n_experts=8,
    top_k=2,
    sub_quadratic=True,
))
