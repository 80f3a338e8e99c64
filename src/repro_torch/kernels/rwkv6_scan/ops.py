"""Wrapper of the RWKV6 WKV scan CUDA kernel — port of
``repro.kernels.rwkv6_scan.ops``.

On a CUDA tensor ``rwkv6_scan`` launches the kernel
(``csrc/rwkv6_scan.cu``, built at first use) or raises; on a CPU tensor it
runs the plain PyTorch version ``ref.rwkv6_scan_chunked``. Unlike the
Pallas kernel (which asserts ``S % chunk == 0``) it takes any S: a ragged
chunk is padded with identity positions inside the kernel, as the
reference model pads it.

The kernel has two forms behind one C entry:

- prefill (S > 1): one team of warps per (batch row, head) walks the
  chunks in order with the state in registers; the chunk's four products
  (r_dec k_dec^T over the lower half only, att v, r_dec S_0, k_tail^T v)
  run on the tensor cores as 3xTF32, and the next chunk's tiles are
  staged by cp.async while this one computes;
- decode (S == 1, chunk cut to 1): the closed form at chunk 1, y =
  r S_0 + (r.u.k) v and S' = exp(log w) S_0 + k v^T, with the state
  streamed from device memory through registers and no products.

``LAUNCHES["rwkv6_scan"]`` counts the kernel's launches: raised by one
where the kernel is launched and nowhere else.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from ..build import load_library
from ..operands import DTYPE_CODES, check_operand, wants_kernel
from . import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "rwkv6_scan.cu"
LAUNCHES = {"rwkv6_scan": 0}
HEAD_SIZES = (8, 16, 32, 64)   # instantiated hs
MAX_CHUNK = 64


def reset_launches() -> None:
    LAUNCHES["rwkv6_scan"] = 0


def _lib() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    fn = lib.rwkv6_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
               chunk: int = 64, use_kernel: Optional[bool] = None):
    """RWKV6 WKV: r, k, v, w (B, S, H, hs) of one type (float32 or
    bfloat16; computed in float32); u (H, hs); s0 (B, H, hs, hs). Returns
    (y (B, S, H, hs) in r's type, s_final (B, H, hs, hs) float32). ``chunk``
    is cut to S, as in the reference; the kernel takes 1 <= chunk <= 64
    and hs in {8, 16, 32, 64}."""
    if not wants_kernel("rwkv6_scan", r, use_kernel, k, v, w, u, s0):
        return ref.rwkv6_scan_chunked(r, k, v, w, u, s0, chunk)
    B, S, H, hs = r.shape
    chunk = min(int(chunk), S)
    if r.dtype not in DTYPE_CODES:
        raise TypeError(f"rwkv6_scan: takes float32 or bfloat16, got "
                        f"{r.dtype}")
    if hs not in HEAD_SIZES:
        raise ValueError(f"rwkv6_scan: head size {hs} not in {HEAD_SIZES}")
    if S and not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"rwkv6_scan: chunk {chunk} not in "
                         f"[1, {MAX_CHUNK}]")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        check_operand("rwkv6_scan", name, t, (B, S, H, hs), r.dtype,
                      r.device)
    # u and s0 are read as float32 (the reference casts them); a no-op for
    # the model's float32 parameters and state
    u = u.to(torch.float32).contiguous()
    s0 = s0.to(torch.float32).contiguous()
    check_operand("rwkv6_scan", "u", u, (H, hs), torch.float32, r.device)
    check_operand("rwkv6_scan", "s0", s0, (B, H, hs, hs), torch.float32,
                  r.device)
    y = torch.empty_like(r)
    if B * S == 0:
        return y, s0.clone()
    sf = torch.empty_like(s0)
    lib = _lib()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.rwkv6_scan_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), s0.data_ptr(), y.data_ptr(), sf.data_ptr(),
            B, S, H, hs, chunk, DTYPE_CODES[r.dtype], stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_scan: launch failed with CUDA error {err}")
    LAUNCHES["rwkv6_scan"] += 1
    return y, sf
