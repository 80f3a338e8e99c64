"""Plain PyTorch version of the flash-attention kernel — port of
``repro.kernels.flash_attention.ref``: full-score causal (+ sliding window)
GQA attention. q (B,S,H,dh), k/v (B,S,G,dh) -> (B,S,H,dh).

The CPU path of ``ops.flash_attention`` and the card's comparison for the
kernel; nothing else runs it when a card is present.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        window: int = 0) -> torch.Tensor:
    B, S, H, dh = q.shape
    G = k.shape[2]
    R = H // G
    qr = q.reshape(B, S, G, R, dh)
    # float32 scores (float64 for float64 inputs: the float64 witness)
    scores = torch.einsum("bsgrd,btgd->bgrst", qr, k).to(
        torch.promote_types(q.dtype, torch.float32))
    scores = scores / math.sqrt(dh)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    ok = kpos <= qpos
    if window > 0:
        ok = ok & (kpos > qpos - window)
    scores = torch.where(ok, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrst,btgd->bsgrd", p.to(v.dtype), v)
    return out.reshape(B, S, H, dh)
