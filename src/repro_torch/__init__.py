"""repro_torch — the allocator of ``repro`` in PyTorch, for one NVIDIA H100.

A second package beside the JAX reference ``repro``: the same modules and
names where that helps a reader find the counterpart
(``repro_torch.core.objective`` mirrors ``repro.core.objective``), written
in PyTorch's idiom — plain functions on tensors, ``NamedTuple`` containers,
a written-out batch dimension where the reference uses ``vmap``, Python
loops with per-lane ``done`` masks where it uses ``lax.while_loop``, an
explicit ``device`` argument and an explicit ``torch.Generator``.

The package imports ``torch`` and numpy, never ``jax`` or ``repro``.

Entry points take ``device=None``, which means ``"cuda"``; on a machine
without a card they raise instead of running on the CPU (pass
``device="cpu"`` to ask for the CPU, as the tests do). On a CUDA tensor
every eq.(1) evaluation runs in the hand-written CUDA kernel of
``repro_torch.kernels.alloc_objective``; on a CPU tensor it runs the
kernel's plain PyTorch version.

Importing the package turns TF32 off for float32 matrix products and
convolutions (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` are set to False): the solver compares
objective values in float32 and TF32 keeps only about three decimal digits.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .device import resolve_device  # noqa: E402

__all__ = ["resolve_device"]
