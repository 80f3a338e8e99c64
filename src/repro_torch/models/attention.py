"""Grouped-query attention with RoPE, optional QKV bias, sliding window,
and a decode path over a preallocated KV cache — port of
``repro.models.attention``.

The kernel switch ``use_kernel`` takes the place of the reference's
``use_pallas``:

- ``None`` (the default): a CUDA tensor goes to the hand-written kernels
  (``repro_torch.kernels.flash_attention`` in prefill and teacher forcing,
  ``repro_torch.kernels.decode_attention`` in each decode step); a CPU tensor
  goes to their plain PyTorch versions;
- ``True``: the kernels, and a CPU tensor raises;
- ``False``: the reference's plain path, ``_sdpa`` over an additive mask, on
  any device.

Differences from the reference: the KV cache is written in place (the
functions return the cache they were given); ``_chunked_flash``, the
reference's memory-saving jnp path for S > 1024 built on
``jax.checkpoint``, waits for the training slice, so the plain path is
``_sdpa`` at every S (the same function); ``distributed.sharding.constrain``
is the identity on one device and is dropped.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..kernels.decode_attention.ops import decode_attention
from ..kernels.flash_attention.ops import flash_attention
from .layers import apply_rope, rope_tables
from .param import dense_init, zeros_init

NEG_INF = -1e30


def init_attention(gen, cfg, dtype, device):
    D, H, G, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    p = {"wq": dense_init(gen, (D, H, dh), dtype, device),
         "wk": dense_init(gen, (D, G, dh), dtype, device),
         "wv": dense_init(gen, (D, G, dh), dtype, device),
         "wo": dense_init(gen, (H, dh, D), dtype, device)}
    if cfg.qkv_bias:
        p["bq"] = zeros_init((H, dh), dtype, device)
        p["bk"] = zeros_init((G, dh), dtype, device)
        p["bv"] = zeros_init((G, dh), dtype, device)
    return p


class KVCache(NamedTuple):
    k: torch.Tensor        # (B, G, S_max, dh), written in place
    v: torch.Tensor        # (B, G, S_max, dh), written in place

    @classmethod
    def zeros(cls, batch, n_kv, s_max, d_head, dtype, device):
        shape = (batch, n_kv, s_max, d_head)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def _rope(cfg, positions, rope):
    """(cos, sin) of ``positions``: ``rope`` where the caller has them (the
    layer loop computes them once for all its layers)."""
    if rope is not None:
        return rope
    return rope_tables(positions, cfg.d_head, cfg.rope_theta)


def _qkv(p, cfg, x, rope):
    """q (B,S,H,dh), k and v (B,S,G,dh), each contiguous, RoPE on q and k;
    rope = (cos, sin) of the positions, from rope_tables."""
    B, S, D = x.shape
    H, G, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = (x @ p["wq"].reshape(D, H * dh)).view(B, S, H, dh)
    k = (x @ p["wk"].reshape(D, G * dh)).view(B, S, G, dh)
    v = (x @ p["wv"].reshape(D, G * dh)).view(B, S, G, dh)
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    cos, sin = rope
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _sdpa(q, k, v, mask):
    """q (B,S,H,dh), k/v (B,T,G,dh), mask (B|1,1,S,T) additive."""
    B, S, H, dh = q.shape
    G = k.shape[2]
    q = q.reshape(B, S, G, H // G, dh)
    scores = torch.einsum("bsgrd,btgd->bgrst", q, k).float()
    scores = scores / math.sqrt(dh)
    scores = scores + (mask[:, None] if mask.ndim == 4 else mask)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrst,btgd->bsgrd", probs.to(v.dtype), v)
    return out.reshape(B, S, H, dh)


def causal_mask(S: int, T: int, offset: int, window: int,
                device=None) -> torch.Tensor:
    """(1, 1, S, T) additive mask. offset = index of query 0 within keys."""
    qpos = torch.arange(S, device=device)[:, None] + offset
    kpos = torch.arange(T, device=device)[None, :]
    ok = kpos <= qpos
    if window > 0:
        ok = ok & (kpos > qpos - window)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(ok, zero, NEG_INF)[None, None]


def _attend_full(q, k, v, cfg, use_kernel: Optional[bool]):
    if use_kernel is False:
        S = q.shape[1]
        return _sdpa(q, k, v, causal_mask(S, S, 0, cfg.window, q.device))
    return flash_attention(q, k, v, window=cfg.window, use_kernel=use_kernel)


def _project_out(p, out):
    B, S, H, dh = out.shape
    return out.reshape(B, S, H * dh) @ p["wo"].reshape(H * dh, -1)


def attention(p, cfg, x, positions, *, use_kernel: Optional[bool] = None,
              rope=None):
    """Full-sequence (teacher forcing) path. x (B, S, D); rope, if given,
    is rope_tables(positions, ...)."""
    q, k, v = _qkv(p, cfg, x, _rope(cfg, positions, rope))
    return _project_out(p, _attend_full(q, k, v, cfg, use_kernel))


def prefill_attention(p, cfg, x, positions, cache: KVCache,
                      *, use_kernel: Optional[bool] = None, rope=None):
    """Prefill: full attention, and k/v written into the cache (which may be
    longer than S; a ring buffer when cfg.window > 0 and the cache is
    shorter than S). rope, if given, is rope_tables(positions, ...).
    Returns (y, cache)."""
    S = x.shape[1]
    q, k, v = _qkv(p, cfg, x, _rope(cfg, positions, rope))
    out = _attend_full(q, k, v, cfg, use_kernel)
    s_max = cache.k.shape[2]
    kc = k.transpose(1, 2)     # (B, G, S, dh)
    vc = v.transpose(1, 2)
    if s_max < S:              # sliding-window ring buffer
        if not (cfg.window > 0 and s_max >= cfg.window):
            raise ValueError(f"a cache of {s_max} positions cannot hold a "
                             f"prompt of {S} (window {cfg.window})")
        slots = positions[-s_max:] % s_max          # ring layout
        cache.k[:, :, slots] = kc[:, :, -s_max:]
        cache.v[:, :, slots] = vc[:, :, -s_max:]
    else:
        cache.k[:, :, :S] = kc
        cache.v[:, :, :S] = vc
    return _project_out(p, out), cache


def decode_valid(cfg, pos: int, s_max: int, device) -> torch.Tensor:
    """(S_max,) bool: the cache positions the query at ``pos`` sees. A ring
    buffer (window > 0 and S_max <= window) is all valid once full."""
    kpos = torch.arange(s_max, device=device)
    if cfg.window > 0 and s_max <= cfg.window:
        if pos >= s_max - 1:
            return torch.ones(s_max, dtype=torch.bool, device=device)
        return kpos <= pos % s_max
    valid = kpos <= pos
    if cfg.window > 0:
        valid &= kpos > pos - cfg.window
    return valid


def decode_attention_step(p, cfg, x, pos: int, cache: KVCache,
                          *, use_kernel: Optional[bool] = None, rope=None,
                          valid=None):
    """Single-token decode. x (B, 1, D); pos the current position (a Python
    int, the same for the batch). Cache (B, G, S_max, dh), ring-buffered iff
    cfg.window > 0 and S_max <= window. rope and valid, if given, are
    rope_tables of [pos] and decode_valid(cfg, pos, S_max, ...) (bool or
    int32), which the layer loop computes once for all its layers. Returns
    (y, cache)."""
    B, S, D = x.shape
    if S != 1:
        raise ValueError(f"decode takes one token per sequence, got {S}")
    pos = int(pos)
    if rope is None:
        rope = rope_tables(torch.arange(pos, pos + 1, device=x.device),
                           cfg.d_head, cfg.rope_theta)
    q, k, v = _qkv(p, cfg, x, rope)
    s_max = cache.k.shape[2]
    ring = cfg.window > 0 and s_max <= cfg.window
    slot = pos % s_max if ring else pos
    cache.k[:, :, slot] = k[:, 0]
    cache.v[:, :, slot] = v[:, 0]
    if valid is None:
        valid = decode_valid(cfg, pos, s_max, x.device)
    if use_kernel is False:
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        mask = torch.where(valid.bool(), zero, NEG_INF)[None, None, None, :]
        out = _sdpa(q, cache.k.transpose(1, 2), cache.v.transpose(1, 2), mask)
    else:
        out = decode_attention(q, cache.k, cache.v, valid,
                               use_kernel=use_kernel)
    return _project_out(p, out), cache
