"""Nemotron-4 15B [arXiv:2402.16819]: 32L, d_model 6144, 48 heads (GQA kv=8),
d_ff 24576, vocab 256000 — squared-ReLU MLP (no gating), RoPE, no bias."""
from . import register
from .base import ModelConfig

CONFIG = register(ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=24576,
    vocab_size=256000,
    activation="sqrelu",
))
