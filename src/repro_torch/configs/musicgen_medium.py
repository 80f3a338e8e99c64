"""MusicGen-medium [arXiv:2306.05284]: 48L, d_model 1536, 24 heads (MHA),
d_ff 6144, vocab 2048 — decoder-only over EnCodec tokens. The EnCodec
frontend is a STUB: input_specs provides the token streams directly
(delay-pattern flattened); the backbone is a plain causal LM over the
2048-entry codebook."""
from . import register
from .base import ModelConfig

CONFIG = register(ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_head=64,
    d_ff=6144,
    vocab_size=2048,
    activation="gelu",
    frontend="audio",
))
