"""Every registered config at reduced() size on the card: the kernel route
(``use_kernel=None`` on CUDA tensors: flash_attention in prefill,
decode_attention in each decode step, rwkv6_scan in both) against the plain
route (``use_kernel=False``) through the serving step functions, with the
MoE FFN, the Mamba block, the hybrid and the vision frontend in the wiring
(``repro_torch.launch.routes.check_routes``, which chip_smoke.py's families
phase runs too). These tests import no JAX, so they also run where only the
port is installed; without a CUDA device they skip. On a machine with a
card:

    python -m pytest -q --noconftest -m cuda tests/test_torch_families_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import list_archs  # noqa: E402
from repro_torch.launch.routes import TOL, check_routes  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("arch", list_archs())
def test_every_config_kernel_route_matches_plain(cuda, arch):
    rec = check_routes(arch, device=cuda)     # raises where routes part
    assert rec["prefill"]["max_err_over_tol"] <= 1
    assert rec["decode"]["max_err_over_tol"] <= 1
    assert rec["prefill"]["tol"] == TOL["prefill"]
    assert rec["launches"]["flash_attention"] + \
        rec["launches"]["rwkv6_scan"] > 0
