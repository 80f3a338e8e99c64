"""Model substrate — port of ``repro.models`` for decoder-only serving and
training:
layers, grouped-query attention (sliding window, KV cache), the RWKV6 time
and channel mix (recurrent state cache), the Mamba block (conv and SSM
state cache), the mixture-of-experts FFN and the transformer assembly,
with the vision frontend's projection. Attention and the WKV scan run in
the hand-written CUDA kernels of ``repro_torch.kernels`` on CUDA tensors
(``use_kernel``); the MoE FFN and the Mamba scan are plain PyTorch, as the
reference's are jnp outside any Pallas kernel. ``loss_fn`` is the
training loss, differentiable by autograd on the plain route (the kernels
have no backward)."""
from .attention import KVCache
from .mamba import MambaCache
from .rwkv import RWKVCache
from .transformer import (abstract_params, cache_axes, decode_step, forward,
                          init_caches, init_model, loss_fn, param_axes,
                          prefill)

__all__ = ["KVCache", "MambaCache", "RWKVCache", "abstract_params",
           "cache_axes", "decode_step", "forward", "init_caches",
           "init_model", "loss_fn", "param_axes", "prefill"]
