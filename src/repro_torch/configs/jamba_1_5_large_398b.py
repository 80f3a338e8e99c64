"""Jamba-1.5-Large 398B [arXiv:2403.19887]: 72L, d_model 8192, 64 heads
(GQA kv=8), d_ff 24576, vocab 65536. Hybrid: attention:mamba 1:7 interleave
(1 attention layer per 8), MoE 16e top-2 on every other layer.
Sub-quadratic (runs long_500k): mamba states + 9 attention layers with
sequence-sharded KV."""
from . import register
from .base import ModelConfig

CONFIG = register(ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=24576,
    vocab_size=65536,
    activation="swiglu",
    # period-8 repeat unit: attn at index 4 (1:7), MoE every other layer
    block_pattern=("mamba", "mamba", "mamba", "mamba",
                   "attn", "mamba", "mamba", "mamba"),
    ffn_pattern=("dense", "moe"),
    n_experts=16,
    top_k=2,
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    sub_quadratic=True,
))
