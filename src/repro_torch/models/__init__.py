"""Model substrate — port of ``repro.models`` for decoder-only serving:
layers, grouped-query attention (sliding window, KV cache) and the
transformer assembly. Attention runs in the hand-written CUDA kernels of
``repro_torch.kernels`` on CUDA tensors (``use_kernel``)."""
from .attention import KVCache
from .transformer import decode_step, forward, init_caches, init_model, prefill

__all__ = ["KVCache", "decode_step", "forward", "init_caches", "init_model",
           "prefill"]
