"""Plain PyTorch version of the decode-attention kernel — port of
``repro.kernels.decode_attention.ref``: one query token per sequence against
a (possibly part-filled or ring-buffered) KV cache.

q (B, 1, H, dh); k/v caches (B, G, S, dh); valid (S,) bool or integer ->
(B, 1, H, dh). The CPU path of ``ops.decode_attention`` and the card's
comparison for the kernel; nothing else runs it when a card is present.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, valid: torch.Tensor
                         ) -> torch.Tensor:
    B, _, H, dh = q.shape
    G = k_cache.shape[1]
    R = H // G
    qr = q.reshape(B, G, R, dh)
    # float32 scores (float64 for float64 inputs: the float64 witness)
    s = torch.einsum("bgrd,bgsd->bgrs", qr, k_cache).to(
        torch.promote_types(q.dtype, torch.float32))
    s = s / math.sqrt(dh)
    s = torch.where(valid.bool()[None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrs,bgsd->bgrd", p.to(v_cache.dtype), v_cache)
    return out.reshape(B, 1, H, dh)
