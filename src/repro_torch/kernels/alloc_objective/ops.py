"""Wrappers of the ``alloc_objective`` CUDA kernel — port of
``repro.kernels.alloc_objective.ops``.

On a CUDA tensor each wrapper launches the kernel (``csrc/
alloc_objective.cu``, built at first use) or raises; on a CPU tensor it runs
the plain PyTorch version in ``ref``. ``use_kernel=False`` asks for the
plain version on any device, as the reference's ``use_kernel`` does.

Unlike the Pallas wrappers these pad nothing: the kernel masks the ragged
tail of n itself and takes any number of rows. Its launch geometry comes
from ``launch_plan``, a plain function of the shapes and the card's SM
count.

``LAUNCHES`` counts the kernel launches of each entry: a plain integer per
entry, raised by one where the kernel is launched and nowhere else.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from pathlib import Path
from typing import NamedTuple

import torch

from ...core.problem import AllocationProblem
from ..build import load_library
from ..operands import check_operand, refuse_autograd
from . import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "alloc_objective.cu"
MAX_M = 8   # kMaxM in the source
MAX_P = 8   # kMaxP in the source
MAX_ROWS = 16            # kMaxRows: rows a block holds (8 warps, 2 a warp)
TILE_COLS = 512          # kTileCols: a tile of the stage starts at a multiple
SMEM_LIMIT = 232_448     # kSmemLimit: 227 KB of dynamic shared memory a block
WEIGHT_BYTES = 4 * MAX_ROWS * (MAX_M + MAX_P)   # the rows' gradient weights
H100_SMS = 132


class LaunchPlan(NamedTuple):
    """The kernel's geometry: grid (blocks, B) of 8-warp blocks, block j
    holding rows [j * rows_per_block, (j + 1) * rows_per_block) of its
    problem below T (warp w carries row w, or rows 2w and 2w + 1 where a
    block holds more than 8); the block stages ``n_tile`` columns of c_b,
    K_b, E_b at a time, after the rows' gradient weights, in ``smem_bytes``
    of shared memory. The fields are the C entry's arguments, in its
    order."""

    blocks: int
    rows_per_block: int
    n_tile: int
    smem_bytes: int


def launch_plan(B: int, T: int, n: int, m: int, p: int,
                sms: int = H100_SMS) -> LaunchPlan:
    """Rows per block from (B, T): 16 (two a warp) where T > 16, else up to
    8, but no more than leave every one of the ``sms`` SMs a block where
    the B T rows allow. Every block stages c_b, K_b, E_b once, so fuller
    blocks move fewer bytes; at small T a block's time is its load latency,
    which more blocks spread over more SMs. The stage is all of n where it
    fits in ``SMEM_LIMIT``, else the widest multiple of ``TILE_COLS`` that
    does."""
    full = MAX_ROWS if T > MAX_ROWS else MAX_ROWS // 2
    rows = max(1, min(full, T, -(-B * T // sms)))
    width = 4 * (1 + m + p)
    room = SMEM_LIMIT - WEIGHT_BYTES
    n_tile = (n if width * n <= room
              else room // (width * TILE_COLS) * TILE_COLS)
    return LaunchPlan(-(-T // rows), rows, n_tile,
                      width * n_tile + WEIGHT_BYTES)


@lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count

LAUNCHES = {"alloc_objective_fleet": 0, "alloc_objective_fleet_value": 0,
            "alloc_objective": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    fn = lib.alloc_objective_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _launch(entry: str, X, K, E, c, d, scal, with_grad: bool):
    """Check every operand, allocate the outputs and launch on the current
    stream. X (B, T, n), K (B, m, n), E (B, p, n), c (B, n), d (B, m),
    scal (B, 8); a single problem passes its (m, n)-shaped data as B = 1."""
    B, T, n = X.shape
    m, p = K.shape[-2], E.shape[-2]
    refuse_autograd("alloc_objective", X, K, E, c, d, scal)
    if not X.is_cuda:
        raise ValueError("alloc_objective: the kernel takes CUDA tensors")
    if m > MAX_M or p > MAX_P:
        raise ValueError(f"alloc_objective: m={m}, p={p}; the kernel takes "
                         f"m <= {MAX_M} and p <= {MAX_P}")
    dev = X.device
    vec = 16 if n % 4 == 0 else 4     # the kernel's 16-byte loads and copies
    for name, t, shape, align in (
            ("X", X, (B, T, n), vec), ("K", K, (B, m, n), vec),
            ("E", E, (B, p, n), vec), ("c", c, (B, n), vec),
            ("d", d, (B, m), 4), ("scalars", scal, (B, 8), 4)):
        check_operand("alloc_objective", name, t, shape, torch.float32, dev,
                      align=align)
    f = torch.empty((B, T), dtype=torch.float32, device=dev)
    g = (torch.empty((B, T, n), dtype=torch.float32, device=dev)
         if with_grad else None)
    if B * T == 0:
        return f, g
    lib = _lib()
    plan = launch_plan(B, T, n, m, p, _sm_count(dev.index))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.alloc_objective_launch(
            X.data_ptr(), K.data_ptr(), E.data_ptr(), c.data_ptr(),
            d.data_ptr(), scal.data_ptr(), f.data_ptr(),
            g.data_ptr() if with_grad else None,
            B, T, n, m, p, int(with_grad), *plan, stream)
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


def batched_value_and_grad(prob: AllocationProblem, X: torch.Tensor,
                           use_kernel: bool = True):
    """(f (S,), grad (S, n)) for ONE problem and S points X (S, n): the
    same kernel with B = 1."""
    if not (use_kernel and X.is_cuda):
        return ref.alloc_objective_ref(X, prob.K, prob.E, prob.c, prob.d,
                                       *_params(prob))
    f, g = _launch("alloc_objective", X[None], prob.K[None], prob.E[None],
                   prob.c[None], prob.d[None], _single_scalars(prob),
                   with_grad=True)
    return f[0], g[0]
