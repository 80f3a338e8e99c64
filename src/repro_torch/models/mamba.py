"""Mamba (S6) block for the Jamba hybrid — port of ``repro.models.mamba``:
a selective state-space model with a chunked scan (the (B, chunk, d_inner,
d_state) intermediate bounds memory in place of the full (B, S, d_inner,
d_state) tensor).

Decode carries ``MambaCache(conv (B, d_conv-1, d_inner), ssm (B, d_inner,
N))``; each call returns a new cache (the reference's are immutable too).
The reference computes the scan with ``jax.lax.associative_scan`` in jnp,
not in a Pallas kernel, so this is plain PyTorch on every device.
The reference's ``distributed.sharding.constrain`` calls place its
activations on the mesh; the port's model code runs on plain tensors (the
model gathers each layer's parameters whole where it reads them), where
``repro_torch.distributed.sharding.constrain`` is the identity, so they
are dropped. Under autograd the chunk body runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``: the scan's
per-level values are recomputed in the backward instead of kept), and the
chunk scan steps out of place, since the backward needs the values an
in-place step would overwrite.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..remat import maybe_checkpoint
from .param import dense_init, ones_init, zeros_init

# logical sharding axes of init_mamba's leaves
MAMBA_AXES = {"in_proj": ("embed", "mamba_inner"),
              "conv_w": (None, "mamba_inner"), "conv_b": ("mamba_inner",),
              "x_proj": ("mamba_inner", None),
              "dt_proj": (None, "mamba_inner"), "dt_bias": ("mamba_inner",),
              "A_log": ("mamba_inner", None), "D": ("mamba_inner",),
              "out_proj": ("mamba_inner", "embed")}


class MambaCache(NamedTuple):
    conv: torch.Tensor   # (B, d_conv-1, d_inner), the activation type
    ssm: torch.Tensor    # (B, d_inner, N), float32

    @classmethod
    def zeros(cls, batch, cfg, dtype, device):
        di, N, dc = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
        return cls(torch.zeros((batch, dc - 1, di), dtype=dtype,
                               device=device),
                   torch.zeros((batch, di, N), dtype=torch.float32,
                               device=device))


def init_mamba(gen, cfg, dtype, device):
    """The reference's tree and draw order; A_log, D and dt_bias are float32
    whatever ``dtype`` is. dt_bias is softplus^-1 of dt drawn log-uniform in
    [1e-3, 1e-1]; A_log = log(1..N) on every channel."""
    D, di, N, dc = (cfg.d_model, cfg.mamba_d_inner, cfg.mamba_d_state,
                    cfg.mamba_d_conv)
    dt_rank = max(1, D // 16)
    p = {"in_proj": dense_init(gen, (D, 2 * di), dtype, device),
         "conv_w": dense_init(gen, (dc, di), dtype, device, scale=0.5),
         "conv_b": zeros_init((di,), dtype, device),
         "x_proj": dense_init(gen, (di, dt_rank + 2 * N), dtype, device),
         "dt_proj": dense_init(gen, (dt_rank, di), dtype, device)}
    u = torch.empty((di,), dtype=torch.float32, device=device)
    u.uniform_(math.log(1e-3), math.log(1e-1), generator=gen)
    p["dt_bias"] = torch.log(torch.expm1(u.exp().clamp_min(1e-4)))
    p["A_log"] = torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                                        device=device)).expand(di, N).clone()
    p["D"] = ones_init((di,), torch.float32, device)
    p["out_proj"] = dense_init(gen, (di, D), dtype, device)
    return p


def _scan_chunk(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t over axis 1 from h = 0, with
    the running product of a beside it: returns (A_t, B_t) such that
    h_t = A_t h_0 + B_t. Hillis-Steele, log2 of the chunk's length in
    steps: step k composes each t >= 2^k with t - 2^k by the reference's
    pairwise ``compose``: ((al, bl), (ar, br)) -> (al ar, ar bl + br),
    whose factors stay <= 1. Log depth rather than a loop over the chunk's
    tokens: a few large elementwise launches per step instead of a few
    small ones per token (the reference's ``associative_scan`` is log depth
    too, in another pattern); the extra work, chunk log chunk, is
    elementwise. Where autograd records nothing the steps overwrite ``a``
    and ``b``; under autograd each step makes new tensors from the same
    products, so the values are the same either way."""
    c, k = a.shape[1], 1
    in_place = not (torch.is_grad_enabled()
                    and (a.requires_grad or b.requires_grad))
    while k < c:
        if in_place:
            # the right-hand sides are formed before the writes
            b[:, k:] = a[:, k:] * b[:, :-k] + b[:, k:]
            a[:, k:] = a[:, k:] * a[:, :-k]
        else:
            b = torch.cat([b[:, :k], a[:, k:] * b[:, :-k] + b[:, k:]], dim=1)
            a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
        k *= 2
    return a, b


def _ssm_chunked_scan(u, dt, B_, C_, A, D, chunk: int,
                      init_state: Optional[torch.Tensor] = None,
                      scan_bf16: bool = False, unroll: bool = False):
    """u/dt (B, S, di); B_/C_ (B, S, N); A (di, N); D (di,), all float32.
    Returns (y (B, S, di), final_state (B, di, N) float32). Each chunk's
    body runs under checkpoint where autograd records, unless ``unroll``."""
    Bb, S, di = u.shape
    N = B_.shape[-1]
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        # identity padding: dt = 0 -> dA = 1 (no decay), dBu = 0
        u, dt, B_, C_ = (F.pad(t, (0, 0, 0, pad)) for t in (u, dt, B_, C_))
    nc = (S + pad) // chunk
    state = (torch.zeros((Bb, di, N), dtype=torch.float32, device=u.device)
             if init_state is None else init_state.float())

    def chunk_step(state, uc, dtc, Bc, Cc):
        dA = torch.exp(dtc[..., None] * (-A))                 # (B, c, di, N)
        dBu = (dtc * uc)[..., None] * Bc[:, :, None, :]       # (B, c, di, N)
        if scan_bf16:
            # the reference's lever: dA in [0, 1] and dBu scanned in
            # bfloat16; the carried state stays float32
            dA, dBu = dA.to(torch.bfloat16), dBu.to(torch.bfloat16)
        At, Bt = _scan_chunk(dA, dBu)
        h = At.float() * state[:, None] + Bt.float()          # (B, c, di, N)
        # the last state as a tensor of its own lets the chunk's h go
        return torch.einsum("bcdn,bcn->bcd", h, Cc), h[:, -1].clone()

    ys = []
    for i in range(nc):
        sl = slice(i * chunk, (i + 1) * chunk)
        y_c, state = maybe_checkpoint(chunk_step, state, u[:, sl], dt[:, sl],
                                      B_[:, sl], C_[:, sl], unroll=unroll)
        ys.append(y_c)
    y = torch.cat(ys, dim=1)[:, :S]
    return y + u[:, :S] * D, state


def _causal_conv(x, w, b, init_state: Optional[torch.Tensor] = None):
    """x (B, S, di); w (dc, di) depthwise causal. Returns (y, new_state):
    the new state is the last d_conv - 1 inputs (the carried state first)."""
    Bb, S, di = x.shape
    dc = w.shape[0]
    pad = (torch.zeros((Bb, dc - 1, di), dtype=x.dtype, device=x.device)
           if init_state is None else init_state.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)                           # (B, S+dc-1, di)
    y = 0
    for i in range(dc):
        y = y + xp[:, i:i + S] * w[i]
    y = y + b
    return y, xp[:, S:].clone()


def mamba_block(p, cfg, x, cache: Optional[MambaCache] = None):
    """x (B, S, D) -> (y (B, S, D), new MambaCache). With no cache (teacher
    forcing) the conv and SSM states start at zeros."""
    N = cfg.mamba_d_state
    dt_rank = p["dt_proj"].shape[0]
    xs, z = (x @ p["in_proj"]).chunk(2, dim=-1)
    xs, new_conv = _causal_conv(xs, p["conv_w"], p["conv_b"],
                                cache.conv if cache is not None else None)
    xs = F.silu(xs)
    dt_lo, B_, C_ = (xs @ p["x_proj"]).split([dt_rank, N, N], dim=-1)
    dt = F.softplus(dt_lo @ p["dt_proj"] + p["dt_bias"]).float()
    A = torch.exp(p["A_log"])                                 # (di, N) > 0
    chunk = cfg.scan_chunk or min(256, x.shape[1])
    y, state = _ssm_chunked_scan(
        xs.float(), dt, B_.float(), C_.float(), A, p["D"], chunk,
        cache.ssm if cache is not None else None,
        scan_bf16=cfg.ssm_scan_bf16, unroll=cfg.unroll_inner)
    y = y.to(x.dtype) * F.silu(z)
    return y @ p["out_proj"], MambaCache(conv=new_conv, ssm=state)


def mamba_decode_step(p, cfg, x, cache: MambaCache):
    """One token (x (B, 1, D)): the block at S = 1, chunk 1."""
    return mamba_block(p, cfg, x, cache)
