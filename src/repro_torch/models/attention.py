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

The plain path is the reference's: ``_sdpa`` for S <= 1024 and
``_chunked_flash`` above, an online softmax over KV chunks whose Q- and
KV-chunk bodies run under ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint``), so that the backward recomputes the score blocks
instead of keeping them. The kernels have no backward: a wrapper asked to
launch its kernel while autograd records raises (training passes
``use_kernel=False``, as the reference's train step passes
``use_pallas=False``).

Differences from the reference: the KV cache is written in place (the
functions return the cache they were given); ``_chunked_flash`` skips the
KV chunks that lie wholly after a Q chunk (the reference scans them under
a mask that makes each an exact no-op: p = 0, corr = 1);
the reference's ``distributed.sharding.constrain`` calls place its
activations on the mesh; the port's model code runs on plain tensors (the
model gathers each layer's parameters whole where it reads them), where
``repro_torch.distributed.sharding.constrain`` is the identity, so they
are dropped.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..kernels.decode_attention.ops import decode_attention
from ..kernels.flash_attention.ops import flash_attention
from ..remat import maybe_checkpoint
from .layers import apply_rope, rope_tables
from .param import dense_init, zeros_init

NEG_INF = -1e30
# logical sharding axes of init_attention's leaves
ATTENTION_AXES = {"wq": ("embed", "heads", None),
                  "wk": ("embed", "kv_heads", None),
                  "wv": ("embed", "kv_heads", None),
                  "wo": ("heads", None, "embed"),
                  "bq": ("heads", None), "bk": ("kv_heads", None),
                  "bv": ("kv_heads", None)}


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


Q_CHUNK, KV_CHUNK = 512, 1024


def _chunked_flash(q, k, v, window: int, q_chunk=None, kv_chunk=None,
                   unroll: bool = False, probs_bf16: bool = False):
    """Flash attention in plain PyTorch (online softmax over KV chunks, a
    loop over Q chunks): memory O(B q_chunk H kv_chunk) instead of
    O(B H S^2), since both chunk bodies run under checkpoint (unless
    ``unroll``) and the backward recomputes their score blocks. Causal, with
    an optional sliding window, applied by masking. q (B,S,H,dh), k/v
    (B,T,G,dh) -> (B,S,H,dh)."""
    B, S, H, dh = q.shape
    T, G = k.shape[1], k.shape[2]
    qc = min(q_chunk or Q_CHUNK, S)
    kc = min(kv_chunk or KV_CHUNK, T)
    if S % qc or T % kc:
        raise ValueError(f"_chunked_flash: S={S} and T={T} must be multiples "
                         f"of the chunks {qc} and {kc}")
    R = H // G
    # 1 / sqrt(dh) rounded as the reference rounds it, in float32
    scale = 1.0 / torch.sqrt(torch.tensor(float(dh), dtype=torch.float32))
    qs = q.reshape(B, S // qc, qc, G, R, dh)
    ks = k.reshape(B, T // kc, kc, G, dh)
    vs = v.reshape(B, T // kc, kc, G, dh)
    dev = q.device

    def kv_step(m, l, acc, qblk, kblk, vblk, q0: int, k0: int):
        s = torch.einsum("bqgrd,bkgd->bgrqk", qblk, kblk).float() * scale
        qpos = q0 + torch.arange(qc, device=dev)[:, None]
        kpos = k0 + torch.arange(kc, device=dev)[None, :]
        ok = kpos <= qpos
        if window > 0:
            ok = ok & (kpos > qpos - window)
        s = torch.where(ok, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(dim=-1)
        if probs_bf16:
            # the reference's lever: post-max weights lie in [0, 1]
            p = p.to(torch.bfloat16)
        pv = torch.einsum("bgrqk,bkgd->bgrqd", p.to(vblk.dtype), vblk)
        return m_new, l_new, acc * corr[..., None].to(acc.dtype) + pv

    def q_step(qblk, q0: int):
        m = torch.full((B, G, R, qc), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, G, R, qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, G, R, qc, dh), dtype=v.dtype, device=dev)
        # KV chunks wholly after the Q chunk's last row: exact no-ops
        for j in range(min(T // kc, (q0 + qc - 1) // kc + 1)):
            m, l, acc = maybe_checkpoint(kv_step, m, l, acc, qblk, ks[:, j],
                                         vs[:, j], q0, j * kc, unroll=unroll)
        return acc / l.clamp_min(1e-30)[..., None].to(acc.dtype)

    outs = [maybe_checkpoint(q_step, qs[:, i], i * qc, unroll=unroll)
            for i in range(S // qc)]
    out = torch.stack(outs, dim=1)                # (B, S//qc, G, R, qc, dh)
    return out.permute(0, 1, 4, 2, 3, 5).reshape(B, S, H, dh)


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
        if S > 1024:
            return _chunked_flash(q, k, v, cfg.window,
                                  q_chunk=cfg.attn_q_chunk or None,
                                  kv_chunk=cfg.attn_kv_chunk or None,
                                  unroll=cfg.unroll_inner,
                                  probs_bf16=cfg.attn_probs_bf16)
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
