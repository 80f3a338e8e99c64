"""Llama-4 Maverick 400B-A17B [hf:meta-llama/Llama-4-*]: 48L, d_model 5120,
40 heads (GQA kv=8), expert d_ff 8192, vocab 202048. MoE 128e top-1
interleaved with dense layers + a shared expert (early-fusion backbone; the
multimodal frontend is out of scope for the LM shapes)."""
from . import register
from .base import ModelConfig

CONFIG = register(ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    d_ff=16384,            # dense-layer FFN width
    moe_d_ff=8192,         # per-expert width (table value)
    vocab_size=202048,
    activation="swiglu",
    block_pattern=("attn",),
    ffn_pattern=("dense", "moe"),   # interleaved MoE every other layer
    n_experts=128,
    top_k=1,
    n_shared_experts=1,
))
