"""TF32 rounding and the 3xTF32 product in plain PyTorch: what the float32
routes of the flash_attention and rwkv6_scan kernels do on the tensor
cores, emulated on any device so that tests can hold it to float64.

Those kernels split each float32 operand x into big = cvt.rna.tf32.f32(x)
and small = cvt.rna.tf32.f32(x - big) and form each product as small.big +
big.small + big.big in float32 (three mma.sync TF32 products, the small
terms first). ``tf32_rna`` does that rounding (10 mantissa bits, to nearest,
ties away from zero); the products of TF32 values are exact in float32 and
are summed here by torch's float32 matmul. ``flush=True`` emulates a
product that flushes subnormal operands to zero.
"""
from __future__ import annotations

import torch

F32_TINY = 2.0 ** -126   # the smallest normal float32


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 of float32 ``x``: its 13 low mantissa bits rounded
    away, to nearest, ties away from zero (adding half a TF32 ulp to the
    magnitude's bits and truncating)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _flushed(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x.abs() < F32_TINY, torch.zeros_like(x), x)


def split(x: torch.Tensor, flush: bool = False):
    """(big, small): x = big + small to about 2^-22 of x, each TF32."""
    big = tf32_rna(x)
    small = tf32_rna(x - big)
    if flush:
        return _flushed(big), _flushed(small)
    return big, small


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor,
              flush: bool = False) -> torch.Tensor:
    """a @ b with every product small.big + big.small + big.big, in that
    order, summed in float32."""
    a_big, a_small = split(a, flush)
    b_big, b_small = split(b, flush)
    acc = a_small @ b_big
    acc = acc + a_big @ b_small
    return acc + a_big @ b_big


def mm_1xtf32(a: torch.Tensor, b: torch.Tensor,
              flush: bool = False) -> torch.Tensor:
    """a @ b with each operand rounded to TF32 once: plain TF32."""
    a_big, b_big = tf32_rna(a), tf32_rna(b)
    if flush:
        a_big, b_big = _flushed(a_big), _flushed(b_big)
    return a_big @ b_big
