"""Wrapper of the decode-attention CUDA kernel — port of
``repro.kernels.decode_attention.ops``.

On a CUDA tensor ``decode_attention`` launches the kernel
(``csrc/decode_attention.cu``, built at first use) or raises; on a CPU
tensor it runs the plain PyTorch version in ``ref``. Any cache length S: the
kernel needs no block size that divides it.

``LAUNCHES["decode_attention"]`` counts the kernel's launches: raised by one
where the kernel is launched and nowhere else.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from ..build import load_library
from ..operands import DTYPE_CODES, check_heads, check_operand, wants_kernel
from . import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"
LAUNCHES = {"decode_attention": 0}


def reset_launches() -> None:
    LAUNCHES["decode_attention"] = 0


def _lib() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    fn = lib.decode_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, valid: torch.Tensor,
                     use_kernel: Optional[bool] = None) -> torch.Tensor:
    """One-token decode attention. q (B,1,H,dh); caches (B,G,S,dh); valid
    (S,) bool or integer, shared by the batch -> (B,1,H,dh) in q's type."""
    if not wants_kernel("decode_attention", q, use_kernel, k_cache,
                        v_cache):
        return ref.decode_attention_ref(q, k_cache, v_cache, valid)
    B, _, H, dh = q.shape
    G, S = k_cache.shape[1], k_cache.shape[2]
    check_heads("decode_attention", H, G, dh, q.dtype)
    for name, t, shape in (("q", q, (B, 1, H, dh)),
                           ("k_cache", k_cache, (B, G, S, dh)),
                           ("v_cache", v_cache, (B, G, S, dh))):
        check_operand("decode_attention", name, t, shape, q.dtype, q.device)
    valid_i = valid.to(torch.int32).contiguous()
    check_operand("decode_attention", "valid", valid_i, (S,), torch.int32,
                  q.device)
    out = torch.empty_like(q)
    if B * S == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            valid_i.data_ptr(), out.data_ptr(), B, S, H, G, dh,
            DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"decode_attention: launch failed with CUDA error "
                           f"{err}")
    LAUNCHES["decode_attention"] += 1
    return out
