"""The distributed substrate on the card, in a world of one over NCCL:
``ElasticFleet``'s replans with the alloc_objective kernel against plain,
int8 gradient compression on the NCCL world, and the launcher on a 1x1
mesh against the one-device loop at one layer. These tests import no JAX;
without a CUDA device they skip. On a machine with a card:

    python -m pytest -q --noconftest -m cuda tests/test_torch_distributed_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.workloads import JobSpec  # noqa: E402
from repro_torch.distributed.elastic import ElasticFleet  # noqa: E402
from repro_torch.kernels.alloc_objective import ops as aops  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.launch.mesh import init_distributed, make_mesh  # noqa: E402
from repro_torch.optim import grad_compress as gc  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = 2e-4
JOB = dict(name="train-104b", hlo_flops=2.5e16, hlo_bytes=1e14,
           collective_bytes=5e12, bytes_per_device=8e9, devices=256,
           step_budget_s=1.0)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist
    dev = init_distributed("cuda")
    assert dist.get_backend() == "nccl"
    yield dev
    dist.destroy_process_group()


def _plans(use_kernel, dev):
    fleet = ElasticFleet(JobSpec(**JOB), delta_max=64.0, device=dev,
                         use_kernel=use_kernel)
    plans = [fleet.initial_plan()]
    failed = np.ceil(fleet.controller.x_current * 0.3)
    plans.append(fleet.replan_after_failure(failed))
    for s in (1.0, 1.3, 1.8, 1.4, 0.8, 0.6, 1.0):
        plans.append(fleet.replan_for_demand(s))
    return plans


def test_elastic_fleet_kernel_matches_plain(cuda):
    aops.reset_launches()
    kern = _plans(True, cuda)
    launched = aops.LAUNCHES["alloc_objective"]
    aops.reset_launches()
    plain = _plans(False, cuda)
    assert launched > 0 and not any(aops.LAUNCHES.values())
    for k, p in zip(kern, plain):
        np.testing.assert_array_equal(k.counts, p.counts)
        assert k.mesh_shape == p.mesh_shape


def test_compressed_psum_on_nccl_equals_compress_decompress(cuda):
    g = torch.randn((2560, 6912), generator=torch.Generator(
        device=cuda).manual_seed(0), device=cuda)
    err = torch.zeros_like(g)
    deq, new_err = gc.compress_decompress(g, err)
    summed, psum_err = gc.compressed_psum(g, err)
    assert torch.equal(deq, summed) and torch.equal(new_err, psum_err)
    gen = torch.Generator(device=cuda).manual_seed(1)
    true = torch.zeros(300, dtype=torch.float64, device=cuda)
    seen = torch.zeros_like(true)
    err = torch.zeros(300, device=cuda)
    for _ in range(50):
        g = torch.randn(300, generator=gen, device=cuda)
        deq, err = gc.compress_decompress(g, err)
        true += g.double()
        seen += deq.double()
    assert float((true - seen).abs().max()) <= float(err.abs().max()) + 1e-5


def test_launcher_on_a_1x1_mesh_matches_one_device(cuda, tmp_path):
    cfg = get_config("qwen1.5-4b").scaled(n_layers=1)
    mesh = make_mesh((1, 1), ("data", "model"), cuda)
    runs = []
    for m in (None, mesh):
        params, state, hist = launch.train(
            cfg, steps=2, batch=2, seq=128, device=cuda, mesh=m,
            ckpt_every=3, ckpt_dir=str(tmp_path), log=lambda *_: None)
        if m is not None:
            params, _ = launch.gather_state(params, state)
        runs.append((params, hist))
    (p1, h1), (pm, hm) = runs
    for a, b in zip(hm, h1):
        assert abs(a["loss"] - b["loss"]) <= TOL * abs(b["loss"])
        assert abs(a["grad_norm"] - b["grad_norm"]) <= TOL * b["grad_norm"]
    # a key bias's gradient is rounding noise (the softmax ignores a shift
    # of every score of a query), held at 10x
    def walk(a, b, key=""):
        if isinstance(b, dict):
            for k in b:
                walk(a[k], b[k], k)
        elif isinstance(b, list):
            for x, y in zip(a, b):
                walk(x, y)
        else:
            widen = 10 if key == "bk" else 1
            torch.testing.assert_close(
                a, b, rtol=TOL, atol=widen * TOL * float(b.abs().max()))

    walk(pm, p1)
