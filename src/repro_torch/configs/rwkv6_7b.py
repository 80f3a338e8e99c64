"""RWKV-6 "Finch" 7B [arXiv:2404.05892]: 32L, d_model 4096 (attention-free),
d_ff 14336, vocab 65536 — data-dependent decay WKV (head size 64), token
shift, squared-ReLU channel mix. O(1)-state decode (runs long_500k)."""
from . import register
from .base import ModelConfig

CONFIG = register(ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_head=0,
    d_ff=14336,
    vocab_size=65536,
    activation="sqrelu",
    block_pattern=("rwkv",),
    ffn_pattern=("rwkv_cm",),
    rwkv_head_size=64,
    rwkv_lora_rank=64,
    sub_quadratic=True,
))
