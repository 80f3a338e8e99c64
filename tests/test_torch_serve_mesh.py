"""The serving steps on a mesh (``launch.steps.make_prefill_step`` and
``make_decode_step`` with ``mesh=``) on a 2x2 ("data", "model") world of
gloo ranks on the CPU, against the one-device steps: reduced qwen1.5-4b
(attention), rwkv6-7b (RWKV) and mixtral-8x22b (MoE), a prefill of 4 x 16
then 3 decode steps. The parameters are DTensors placed by
``make_shardings(param_axes(cfg), mesh, rules)`` under ``base_rules`` for
the prefill and ``decode_rules`` for decode; each rank serves its data
coordinate's 2 rows, and its logits equal the one-device step's on those
rows at 2e-4 (prefill) and 2e-3 (decode). The ranks run in spawned
processes (``repro_torch.testing.spawn_world``, a ``file://`` store in
tmp_path); their function is this module's ``serve_ranks``, and this
module imports no JAX, so the children start fast."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.steps import (make_decode_step,  # noqa: E402
                                      make_prefill_step)
from repro_torch.models import init_model, param_axes  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.testing import spawn_world  # noqa: E402

ARCHS = ("qwen1.5-4b", "rwkv6-7b", "mixtral-8x22b")
BATCH, PROMPT, STEPS, S_MAX, SEED = 4, 16, 3, 32, 3
PREFILL_TOL, DECODE_TOL = 2e-4, 2e-3


def _inputs(cfg):
    """The global prompts (BATCH, PROMPT) and each decode step's tokens
    (STEPS, BATCH, 1), from SEED."""
    rng = np.random.default_rng(SEED)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                           (BATCH, PROMPT)))
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (STEPS, BATCH, 1)))
    return prompts, tokens


def serve(arch, mesh=None, rows=slice(None)):
    """Prefill then STEPS decode steps of reduced ``arch`` (init_model
    seed 0) on ``rows`` of the batch; on ``mesh`` with the parameters
    placed as the module docstring says. Returns the logits of each
    step."""
    cfg = get_config(arch).reduced()
    full = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    prompts, tokens = _inputs(cfg)

    def placed(rules):
        if mesh is None:
            return full
        return adamw.tree_map(lambda t, pl: shd.shard_full(t, mesh, pl),
                              full, shd.make_shardings(param_axes(cfg), mesh,
                                                       rules(mesh, cfg), full))

    logits, caches = make_prefill_step(cfg, S_MAX, mesh=mesh)(
        placed(shd.base_rules),
        {"tokens": prompts[rows]})
    out = [logits]
    params = placed(shd.decode_rules)
    step = make_decode_step(cfg, mesh=mesh)
    for i in range(STEPS):
        logits, caches = step(params, caches, tokens[i][rows], PROMPT + i)
        out.append(logits)
    return out


def serve_ranks(rank, world, out):
    """Every arch on a 2x2 mesh; rank saves its rows and logits."""
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    per = BATCH // mesh.size(0)
    d = mesh.get_local_rank("data")
    rows = slice(d * per, (d + 1) * per)
    torch.save({"rows": (rows.start, rows.stop),
                "logits": {arch: serve(arch, mesh, rows) for arch in ARCHS}},
               os.path.join(out, f"serve_{rank}.pt"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("serve_mesh")
    spawn_world(serve_ranks, 4, out, str(out))
    return [torch.load(os.path.join(out, f"serve_{r}.pt")) for r in range(4)]


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_serving_equals_one_device(ranks, arch):
    want = serve(arch)
    assert sorted(r["rows"] for r in ranks) == [(0, 2), (0, 2), (2, 4),
                                                (2, 4)]
    for r in ranks:
        rows = slice(*r["rows"])
        got = r["logits"][arch]
        assert len(got) == len(want) == STEPS + 1
        for i, (g, w) in enumerate(zip(got, want)):
            tol = PREFILL_TOL if i == 0 else DECODE_TOL
            assert not isinstance(g, torch.distributed.tensor.DTensor)
            torch.testing.assert_close(g, w[rows], rtol=tol, atol=tol,
                                       msg=lambda m: f"{arch} step {i}: {m}")
