"""InternVL2-26B [arXiv:2404.16821]: InternLM2 backbone — 48L, d_model 6144,
48 heads (GQA kv=8), d_ff 16384, vocab 92553. The InternViT-6B frontend is a
STUB: input_specs provides precomputed patch embeddings (n=256, d=3200)
projected into the LM embedding space (the paper's MLP projector)."""
from . import register
from .base import ModelConfig

CONFIG = register(ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=16384,
    vocab_size=92553,
    activation="swiglu",
    frontend="vision",
    n_frontend_tokens=256,
    d_frontend=3200,
))
