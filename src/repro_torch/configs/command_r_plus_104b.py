"""Command R+ 104B [hf:CohereForAI/c4ai-command-r-plus]: 64L, d_model 12288,
96 heads (GQA kv=8), d_ff 33792, vocab 256000 — SwiGLU, no bias."""
from . import register
from .base import ModelConfig

CONFIG = register(ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_head=128,
    d_ff=33792,
    vocab_size=256000,
    activation="swiglu",
))
