"""Wrapper of the flash-attention CUDA kernel — port of
``repro.kernels.flash_attention.ops``.

On a CUDA tensor ``flash_attention`` launches the kernel
(``csrc/flash_attention.cu``, built at first use) or raises; on a CPU tensor
it runs the plain PyTorch version in ``ref``. Unlike the Pallas wrapper it
takes any S: the kernel masks the ragged last tile itself, so there are no
block sizes to choose.

``LAUNCHES["flash_attention"]`` counts the kernel's launches: raised by one
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

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
LAUNCHES = {"flash_attention": 0}


def reset_launches() -> None:
    LAUNCHES["flash_attention"] = 0


def _lib() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: int = 0, use_kernel: Optional[bool] = None
                    ) -> torch.Tensor:
    """Causal GQA attention. q (B,S,H,dh); k/v (B,S,G,dh) -> (B,S,H,dh) in
    q's type (float32 or bfloat16; float32 accumulation)."""
    if not wants_kernel("flash_attention", q, use_kernel, k, v):
        return ref.flash_attention_ref(q, k, v, window)
    B, S, H, dh = q.shape
    G = k.shape[2]
    check_heads("flash_attention", H, G, dh, q.dtype)
    for name, t, shape in (("q", q, (B, S, H, dh)), ("k", k, (B, S, G, dh)),
                           ("v", v, (B, S, G, dh))):
        check_operand("flash_attention", name, t, shape, q.dtype, q.device)
    out = torch.empty_like(q)
    if B * S == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, H, G, dh, int(window), DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: launch failed with CUDA error "
                           f"{err}")
    LAUNCHES["flash_attention"] += 1
    return out
