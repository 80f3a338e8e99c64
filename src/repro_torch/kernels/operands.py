"""What the kernel wrappers check before they launch."""
from __future__ import annotations

from typing import Optional, Sequence

import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}   # the sources' `dtype`
HEAD_DIMS = (16, 32, 64, 128)                          # instantiated dh


def refuse_autograd(kernel: str, *operands) -> None:
    """Raise if autograd would record a launch of ``kernel``: grad mode is
    on and an operand requires grad. The kernels fill their outputs through
    ctypes, so those carry no graph and the operands would get no gradient;
    the kernels have no backward, and the reference's Pallas kernels cannot
    be differentiated either. Training takes the plain route
    (``use_kernel=False``); serving runs under ``torch.inference_mode()``,
    where grad mode is off."""
    if torch.is_grad_enabled() and any(
            torch.is_tensor(t) and t.requires_grad for t in operands):
        raise RuntimeError(
            f"{kernel}: the kernel has no backward (nor can the reference's "
            f"Pallas kernel be differentiated), and an operand requires "
            f"grad; pass use_kernel=False to differentiate the plain "
            f"version, or run under torch.no_grad() / inference_mode()")


def wants_kernel(kernel: str, t: torch.Tensor,
                 use_kernel: Optional[bool], *operands) -> bool:
    """The kernel switch: ``None`` launches the kernel for a CUDA tensor and
    runs the plain version for a CPU tensor; ``False`` runs the plain
    version anywhere; ``True`` on a CPU tensor raises. Where the kernel
    would launch, ``refuse_autograd`` checks ``t`` and ``operands`` first,
    so a CPU tensor under ``use_kernel=True`` that requires grad meets the
    autograd error before the device error."""
    launch = t.is_cuda if use_kernel is None else bool(use_kernel)
    if launch:
        refuse_autograd(kernel, t, *operands)
    if use_kernel and not t.is_cuda:
        raise ValueError(f"{kernel}: use_kernel=True needs CUDA tensors, "
                         f"got a tensor on {t.device}")
    return launch


def check_operand(kernel: str, name: str, t: torch.Tensor,
                  shape: Sequence[int], dtype: torch.dtype,
                  device: torch.device, align: int = 16) -> None:
    """Raise unless ``t`` is what the kernel reads: on ``device``, of
    ``dtype`` and ``shape``, contiguous, its data ``align``-byte aligned
    (the attention kernels load 16 bytes at a time)."""
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, expected "
                         f"{device}")
    if t.dtype != dtype:
        raise TypeError(f"{kernel}: {name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{kernel}: {name} must be {align}-byte aligned")


def check_heads(kernel: str, H: int, G: int, dh: int,
                dtype: torch.dtype) -> None:
    if dtype not in DTYPE_CODES:
        raise TypeError(f"{kernel}: takes float32 or bfloat16, got {dtype}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"{kernel}: head size {dh} not in {HEAD_DIMS}")
    if G <= 0 or H % G:
        raise ValueError(f"{kernel}: {H} query heads do not group over "
                         f"{G} KV heads")
