"""Granite 34B code [arXiv:2405.04324]: 88L, d_model 6144, 48 heads
(MQA kv=1), d_ff 24576, vocab 49152 — GPT-BigCode lineage: MQA + GELU."""
from . import register
from .base import ModelConfig

CONFIG = register(ModelConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_head=128,
    d_ff=24576,
    vocab_size=49152,
    activation="gelu",
))
