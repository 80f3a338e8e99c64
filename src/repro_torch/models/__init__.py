"""Model substrate — port of ``repro.models`` for decoder-only serving:
layers, grouped-query attention (sliding window, KV cache), the RWKV6 time
and channel mix (recurrent state cache) and the transformer assembly.
Attention and the WKV scan run in the hand-written CUDA kernels of
``repro_torch.kernels`` on CUDA tensors (``use_kernel``)."""
from .attention import KVCache
from .rwkv import RWKVCache
from .transformer import decode_step, forward, init_caches, init_model, prefill

__all__ = ["KVCache", "RWKVCache", "decode_step", "forward", "init_caches",
           "init_model", "prefill"]
