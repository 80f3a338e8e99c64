"""Plain PyTorch versions of the RWKV6 WKV scan.

r, k, v, w (B, S, H, hs); u (H, hs); s0 (B, H, hs, hs) ->
  (y (B, S, H, hs), s_final (B, H, hs, hs)), where per head

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)

``rwkv6_scan_chunked`` is the chunked closed form exactly as the reference
model computes it (``repro.models.rwkv._wkv_chunked``): the kernel's plain
version, the model's CPU path and the card's comparison for the kernel.
``rwkv6_scan_ref`` is a copy of the sequential recurrence of
``repro.kernels.rwkv6_scan.ref``, which only the tests run. The two agree
except where the chunked form's clamp of ``k / W_i`` at e^60 bites (a
chunk whose decays multiply below e^-60); there the port follows the
chunked form, since that is what the reference model computes.
"""
from __future__ import annotations

import torch

from ...remat import maybe_checkpoint

CLAMP = 60.0   # the chunked form's clamp of -log W_i (rwkv.py:111)


def rwkv6_scan_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
                       chunk: int = 64,
                       compute_dtype: torch.dtype = torch.float32):
    """The chunked closed form, computed in ``compute_dtype`` (float32, as
    the kernel; float64 gives a yardstick for both); y in r's type, the
    final state in ``compute_dtype``. Within a chunk, with W_t the product
    of w up to and including t:

      y_t = (r_t W_{t-1}) S_0 + sum_{i<t} ((r_t W_{t-1}) . (k_i / W_i)) v_i
            + (r_t . u . k_t) v_t
      S'  = diag(W_c) S_0 + sum_i (k_i W_c / W_i) v_i^T

    A ragged last chunk is padded with identity positions (r = k = v = 0,
    w = 1), whose outputs are dropped. It is differentiable: where autograd
    records, each chunk's body runs under checkpoint, as the reference's
    ``jax.checkpoint`` of it, so the (B, H, c, c) intra-chunk matrix is
    recomputed in the backward instead of kept."""
    B, S, H, hs = r.shape
    out_dtype = r.dtype
    r, k, v, w, u = (a.to(compute_dtype) for a in (r, k, v, w, u))
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        z = lambda a, fill=0.0: torch.cat(
            [a, a.new_full((B, pad, H, hs), fill)], dim=1)
        r, k, v, w = z(r), z(k), z(v), z(w, 1.0)
    nc = (S + pad) // chunk
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), diagonal=-1)

    def step(state, rr, kk, vv, ww):                         # (B, c, H, hs)
        logw = torch.log(ww)
        cum = torch.cumsum(logw, dim=1)          # log W_t
        r_dec = rr * torch.exp(cum - logw)       # r_t W_{t-1}
        k_dec = kk * torch.exp(-torch.clamp(cum, -CLAMP, 0.0))
        att = torch.einsum("bthc,bihc->bhti", r_dec, k_dec)
        att = torch.where(tri, att, 0.0)
        bonus = torch.einsum("bthc,bthc->bth", rr * u, kk)
        y = torch.einsum("bhti,bihc->bthc", att, vv)
        y = y + bonus[..., None] * vv
        y = y + torch.einsum("bthc,bhcd->bthd", r_dec, state)
        end = cum[:, -1]                         # (B, H, hs)
        k_tail = kk * torch.exp(end[:, None] - cum)
        return y, (torch.exp(end)[..., None] * state
                   + torch.einsum("bihc,bihd->bhcd", k_tail, vv))

    state = s0.to(compute_dtype)
    ys = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        y, state = maybe_checkpoint(step, state, r[:, sl], k[:, sl],
                                    v[:, sl], w[:, sl])
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :S]
    return y.to(out_dtype), state


def rwkv6_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor):
    """The naive sequential recurrence, one step per position."""
    state = s0.float()
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]   # (B, H, hs)
        bonus = torch.einsum("bhc,bhc->bh", rt * u[None], kt)
        ys.append(torch.einsum("bhc,bhcd->bhd", rt, state)
                  + bonus[..., None] * vt)
        state = wt[..., None] * state + torch.einsum("bhc,bhd->bhcd", kt, vt)
    return torch.stack(ys, dim=1), state
