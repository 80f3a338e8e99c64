"""The GPipe schedule on gloo ranks against the sequential composition at
1e-5 (``tests/distributed/test_substrates.py::test_pipeline_parallel_
subprocess``'s tolerance): 4 tanh stages on a ("pipe",) mesh of 4 with 8
microbatches of 2 x 16, the same with 2 microbatches (fewer than the
stages), and 2 stages on the "pipe" dimension of a (2, 2) mesh; and
``bubble_fraction`` against the reference's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch_ranks as R  # noqa: E402

from repro.distributed.pipeline_parallel import \
    bubble_fraction as j_bubble  # noqa: E402

from repro_torch.distributed.pipeline_parallel import \
    bubble_fraction  # noqa: E402
from repro_torch.testing import spawn_world  # noqa: E402

TOL = 1e-5


def _case(n_stages, n_micro, mb=2, d=16, seed=0):
    rng = np.random.default_rng(seed)
    Ws = torch.as_tensor(rng.normal(0, 0.5, (n_stages, d, d)), dtype=torch.float32)
    x = torch.as_tensor(rng.normal(0, 1, (n_micro, mb, d)), dtype=torch.float32)
    return Ws, x


CASES = [("4 stages, 8 microbatches", (4,), ("pipe",), _case(4, 8)),
         ("4 stages, 2 microbatches", (4,), ("pipe",), _case(4, 2, seed=1)),
         ("2 stages on a 2x2 mesh", (2, 2), ("data", "pipe"),
          _case(2, 8, seed=2))]


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    out = tmp_path_factory.mktemp("pipe")
    spawn_world(R.pipeline_ranks, 4, out, str(out),
                [(shape, axes, Ws, x) for _, shape, axes, (Ws, x) in CASES])
    return [torch.load(out / f"pipe_{r}.pt") for r in range(4)]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_pipeline_matches_the_sequential_stages(outputs, case):
    _, _, _, (Ws, x) = CASES[case]
    ref = x
    for W in Ws:
        ref = torch.tanh(ref @ W)
    for rank in outputs:              # the last stage's outputs, everywhere
        got = rank[case]
        assert got.shape == x.shape
        assert float((got - ref).abs().max()) < TOL


@pytest.mark.parametrize("n_stages,n_micro", [(1, 1), (4, 8), (4, 2),
                                              (8, 32), (16, 4)])
def test_bubble_fraction_equals_the_reference(n_stages, n_micro):
    assert bubble_fraction(n_stages, n_micro) == j_bubble(n_stages, n_micro)
