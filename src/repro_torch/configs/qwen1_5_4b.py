"""Qwen1.5-4B [hf:Qwen/Qwen1.5-*]: 40L, d_model 2560, 20 heads (kv=20 => MHA),
d_ff 6912, vocab 151936 — SwiGLU, QKV bias (the Qwen signature)."""
from . import register
from .base import ModelConfig

CONFIG = register(ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_head=128,
    d_ff=6912,
    vocab_size=151936,
    activation="swiglu",
    qkv_bias=True,
))
