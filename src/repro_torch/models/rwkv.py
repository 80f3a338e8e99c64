"""RWKV6 "Finch": attention-free time mix with data-dependent decay, and the
squared-ReLU channel mix — port of ``repro.models.rwkv``.

Per head h (size hs): state S in R^{hs x hs}, per-token decay w_t in (0,1)^hs:

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)

The WKV scan (the reference's ``_wkv_chunked``) is the chunked closed form
of ``repro_torch.kernels.rwkv6_scan``, whose switch ``use_kernel`` the
functions here pass on:

- ``None`` (the default): a CUDA tensor goes to the hand-written kernel, a
  CPU tensor to its plain PyTorch version ``ref.rwkv6_scan_chunked``;
- ``True``: the kernel, and a CPU tensor raises;
- ``False``: the plain version on any device.

Decode is the same scan at S = 1 (chunk 1). The cache is threaded as in the
reference: the time mix writes ``shift_tm`` and ``wkv``, the channel mix
``shift_cm``; each returns a new ``RWKVCache`` (the reference's are
immutable too). The reference's ``distributed.sharding.constrain`` calls place its
activations on the mesh; the port's model code runs on plain tensors (the
model gathers each layer's parameters whole where it reads them), where
``repro_torch.distributed.sharding.constrain`` is the identity, so they
are dropped.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..kernels.rwkv6_scan.ops import rwkv6_scan
from .param import const_init, dense_init, ones_init

# logical sharding axes of the time and channel mixes' leaves
TIME_MIX_AXES = {"mix": (None, "act_embed"), "w_base": ("act_embed",),
                 "w_lora_a": ("embed", None), "w_lora_b": (None, "embed"),
                 "wr": ("embed", "mlp"), "wk": ("embed", "mlp"),
                 "wv": ("embed", "mlp"), "wg": ("embed", "mlp"),
                 "u": ("rwkv_heads", None), "wo": ("mlp", "embed"),
                 "ln_x": ("act_embed",)}
CHANNEL_MIX_AXES = {"mix": (None, "act_embed"), "wk": ("embed", "mlp"),
                    "wv": ("mlp", "embed"), "wr": ("embed", "act_embed")}


class RWKVCache(NamedTuple):
    shift_tm: torch.Tensor   # (B, D)  last token for the time-mix shift
    shift_cm: torch.Tensor   # (B, D)  last token for the channel-mix shift
    wkv: torch.Tensor        # (B, H, hs, hs) state, float32

    @classmethod
    def zeros(cls, batch, cfg, dtype, device):
        H, hs = cfg.n_rwkv_heads, cfg.rwkv_head_size
        return cls(torch.zeros((batch, cfg.d_model), dtype=dtype,
                               device=device),
                   torch.zeros((batch, cfg.d_model), dtype=dtype,
                               device=device),
                   torch.zeros((batch, H, hs, hs), dtype=torch.float32,
                               device=device))


def init_rwkv_time_mix(gen, cfg, dtype, device):
    """The reference's tree and draw order (w_lora_a, w_lora_b, wr, wk, wv,
    wg, wo); the mixes, w_base, u and ln_x are float32 constants."""
    D, H, hs, r = (cfg.d_model, cfg.n_rwkv_heads, cfg.rwkv_head_size,
                   cfg.rwkv_lora_rank)
    p = {"mix": const_init(0.5, (5, D), device),
         "w_base": const_init(-6.0, (D,), device),
         "w_lora_a": dense_init(gen, (D, r), dtype, device, scale=0.01),
         "w_lora_b": dense_init(gen, (r, D), dtype, device, scale=0.01)}
    for name in ("wr", "wk", "wv", "wg"):
        p[name] = dense_init(gen, (D, D), dtype, device)
    p["u"] = const_init(0.0, (H, hs), device)
    p["wo"] = dense_init(gen, (D, D), dtype, device)
    p["ln_x"] = ones_init((D,), torch.float32, device)
    return p


def init_rwkv_channel_mix(gen, cfg, dtype, device):
    D, F_ = cfg.d_model, cfg.d_ff
    return {"mix": const_init(0.5, (2, D), device),
            "wk": dense_init(gen, (D, F_), dtype, device),
            "wv": dense_init(gen, (F_, D), dtype, device),
            "wr": dense_init(gen, (D, D), dtype, device)}


def _token_shift(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """shifted[t] = x[t-1]; shifted[0] = last (carried state). x (B,S,D)."""
    return torch.cat([last[:, None, :], x[:, :-1, :]], dim=1)


def _last(x: torch.Tensor) -> torch.Tensor:
    """x[:, -1] as a tensor of its own: a cache must not hold the whole
    (B, S, D) activation alive through a view."""
    return x[:, -1].clone()


def rwkv_time_mix(p, cfg, x, cache: Optional[RWKVCache],
                  use_kernel: Optional[bool] = None):
    """x (B, S, D) -> (y, new_cache). cache.shift_tm / wkv used and
    replaced; with no cache (teacher forcing) the state starts at zeros."""
    B, S, D = x.shape
    H, hs = cfg.n_rwkv_heads, cfg.rwkv_head_size
    last = (cache.shift_tm if cache is not None
            else torch.zeros((B, D), dtype=x.dtype, device=x.device))
    xx = _token_shift(x, last) - x
    # the five lerps, each cast to x's type (mixed[:, :, i] in the reference)
    xw, xk, xv, xr, xg = ((x + xx * m).to(x.dtype) for m in p["mix"])

    r = (xr @ p["wr"]).view(B, S, H, hs)
    k = (xk @ p["wk"]).view(B, S, H, hs)
    v = (xv @ p["wv"]).view(B, S, H, hs)
    g = F.silu(xg @ p["wg"])

    # data-dependent decay (the "Finch" contribution): base + low-rank path
    dw = torch.tanh(xw) @ p["w_lora_a"] @ p["w_lora_b"]
    w = torch.exp(-torch.exp((p["w_base"] + dw).float())).view(B, S, H, hs)

    state = (cache.wkv if cache is not None
             else torch.zeros((B, H, hs, hs), dtype=torch.float32,
                              device=x.device))
    chunk = cfg.scan_chunk or min(64, S)
    # the reference's _wkv_chunked
    y, new_state = rwkv6_scan(r.float(), k.float(), v.float(), w, p["u"],
                              state, chunk=chunk, use_kernel=use_kernel)
    # group norm over each head (ln_x), then the gate and the output
    y = y.to(x.dtype)
    mean = y.mean(dim=-1, keepdim=True)
    var = y.var(dim=-1, keepdim=True, correction=0)   # jnp.var: population
    y = ((y - mean) * torch.rsqrt(var + 1e-5)).reshape(B, S, D)
    y = y * p["ln_x"]
    y = (y * g).to(x.dtype)
    out = y @ p["wo"]
    new_cache = RWKVCache(
        shift_tm=_last(x),
        shift_cm=(cache.shift_cm if cache is not None
                  else torch.zeros((B, D), dtype=x.dtype, device=x.device)),
        wkv=new_state)
    return out, new_cache


def rwkv_channel_mix(p, cfg, x, cache: Optional[RWKVCache]):
    """x (B, S, D) -> (y, new_cache): squared-ReLU key, sigmoid receptance.
    cache.shift_cm used and replaced; None stays None."""
    B, S, D = x.shape
    last = (cache.shift_cm if cache is not None
            else torch.zeros((B, D), dtype=x.dtype, device=x.device))
    xx = _token_shift(x, last) - x
    xk = (x + xx * p["mix"][0]).to(x.dtype)
    xr = (x + xx * p["mix"][1]).to(x.dtype)
    k = torch.relu(xk @ p["wk"]).square()
    kv = k @ p["wv"]
    out = (torch.sigmoid(xr @ p["wr"]) * kv).to(x.dtype)
    new_cache = (cache._replace(shift_cm=_last(x)) if cache is not None
                 else None)
    return out, new_cache
