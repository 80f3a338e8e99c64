"""Wrappers of the ``alloc_objective`` CUDA kernel — port of
``repro.kernels.alloc_objective.ops``.

On a CUDA tensor each wrapper launches the kernel (``csrc/
alloc_objective.cu``, built at first use) or raises; on a CPU tensor it runs
the plain PyTorch version in ``ref``. ``use_kernel=False`` asks for the
plain version on any device, as the reference's ``use_kernel`` does.

Unlike the Pallas wrappers these pad nothing: the kernel masks the ragged
tail of n itself and takes any number of rows.

``LAUNCHES`` counts the kernel launches of each entry: a plain integer per
entry, raised by one where the kernel is launched and nowhere else.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ...core.problem import AllocationProblem
from ..build import load_library
from ..operands import check_operand
from . import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "alloc_objective.cu"
MAX_M = 8   # kMaxM in the source
MAX_P = 8   # kMaxP in the source

LAUNCHES = {"alloc_objective_fleet": 0, "alloc_objective_fleet_value": 0,
            "alloc_objective": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    fn = lib.alloc_objective_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _launch(entry: str, X, K, E, c, d, scal, with_grad: bool):
    """Check every operand, allocate the outputs and launch on the current
    stream. X (B, T, n), K (B, m, n), E (B, p, n), c (B, n), d (B, m),
    scal (B, 8); a single problem passes its (m, n)-shaped data as B = 1."""
    B, T, n = X.shape
    m, p = K.shape[-2], E.shape[-2]
    if not X.is_cuda:
        raise ValueError("alloc_objective: the kernel takes CUDA tensors")
    if m > MAX_M or p > MAX_P:
        raise ValueError(f"alloc_objective: m={m}, p={p}; the kernel takes "
                         f"m <= {MAX_M} and p <= {MAX_P}")
    dev = X.device
    for name, t, shape in (("X", X, (B, T, n)), ("K", K, (B, m, n)),
                           ("E", E, (B, p, n)), ("c", c, (B, n)),
                           ("d", d, (B, m)), ("scalars", scal, (B, 8))):
        check_operand("alloc_objective", name, t, shape, torch.float32, dev,
                      align=4)
    f = torch.empty((B, T), dtype=torch.float32, device=dev)
    g = (torch.empty((B, T, n), dtype=torch.float32, device=dev)
         if with_grad else None)
    if B * T == 0:
        return f, g
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.alloc_objective_launch(
            X.data_ptr(), K.data_ptr(), E.data_ptr(), c.data_ptr(),
            d.data_ptr(), scal.data_ptr(), f.data_ptr(),
            g.data_ptr() if with_grad else None,
            B, T, n, m, p, int(with_grad), stream)
    if err != 0:
        raise RuntimeError(f"alloc_objective: launch failed with CUDA error "
                           f"{err}")
    LAUNCHES[entry] += 1
    return f, g


def _fleet_scalars(prob: AllocationProblem) -> torch.Tensor:
    """(B, 8) = [alpha, beta1, beta2, beta3, gamma, p_pad, 0, 0]: the PADDED
    provider count, so that all-zero E rows cancel (the reference's
    ``fleet_value_and_grad`` passes the same)."""
    P = prob.params
    B = prob.c.shape[0]
    p_pad = torch.full((B,), float(prob.E.shape[1]), dtype=torch.float32,
                       device=prob.c.device)
    zeros = torch.zeros_like(p_pad)
    return torch.stack([P.alpha, P.beta1, P.beta2, P.beta3, P.gamma,
                        p_pad, zeros, zeros], dim=1).contiguous()


def _single_scalars(prob: AllocationProblem) -> torch.Tensor:
    """(1, 8) = [alpha, beta1, beta2, beta3, gamma, p, 0, 0] of ONE
    problem."""
    P = prob.params
    dev = prob.c.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return torch.stack([P.alpha, P.beta1, P.beta2, P.beta3, P.gamma,
                        torch.full((), float(prob.p), dtype=torch.float32,
                                   device=dev), zero, zero])[None]


def _params(prob: AllocationProblem):
    P = prob.params
    return (P.alpha, P.beta1, P.beta2, P.beta3, P.gamma)


def fleet_value_and_grad(prob: AllocationProblem, X: torch.Tensor,
                         use_kernel: bool = True):
    """(f (B, T), grad (B, T, n)) for a STACKED problem and X (B, T, n)."""
    if not (use_kernel and X.is_cuda):
        return ref.alloc_objective_fleet_ref(X, prob.K, prob.E, prob.c,
                                             prob.d, *_params(prob))
    return _launch("alloc_objective_fleet", X, prob.K, prob.E, prob.c,
                   prob.d, _fleet_scalars(prob), with_grad=True)


def fleet_value(prob: AllocationProblem, X: torch.Tensor,
                use_kernel: bool = True) -> torch.Tensor:
    """f (B, T) only — the Armijo ladder's candidate values; the kernel's
    value-only instantiation skips the gradient pass."""
    if not (use_kernel and X.is_cuda):
        return ref.alloc_objective_fleet_value(X, prob.K, prob.E, prob.c,
                                               prob.d, *_params(prob))
    return _launch("alloc_objective_fleet_value", X, prob.K, prob.E, prob.c,
                   prob.d, _fleet_scalars(prob), with_grad=False)[0]


def batched_value_and_grad(prob: AllocationProblem, X: torch.Tensor):
    """(f (S,), grad (S, n)) for ONE problem and S points X (S, n): the
    same kernel with B = 1."""
    if not X.is_cuda:
        return ref.alloc_objective_ref(X, prob.K, prob.E, prob.c, prob.d,
                                       *_params(prob))
    f, g = _launch("alloc_objective", X[None], prob.K[None], prob.E[None],
                   prob.c[None], prob.d[None], _single_scalars(prob),
                   with_grad=True)
    return f[0], g[0]
