"""The port's dry run (``repro_torch.launch.dryrun``): the reference test's
cell (rwkv6-7b x decode_32k) through the command line on both production
meshes, held to ``tests/distributed/test_dryrun_cell.py``'s record schema
and its 16 GiB bound, and read by ``core.workloads.demand_from_dryrun_
record`` in both packages alike; a reduced qwen1.5-4b train cell on a fake
4x4 world, whose FLOPs equal a real CPU run of the same rank's step under
``FlopCounterMode`` and whose all-gather bytes equal each layer's leaves
gathered whole once in the forward and once more in the backward (remat
"full"), the other leaves once; and ``fake_world`` raising where torch's
fake backend cannot be imported. Each fake world runs in a process of its
own."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import abstract_params, init_model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
# mesh -> (name, ranks, rank 0's rows of decode_32k's 128: the batch
# splits over "data", and "pod" too)
MESHES = {"single": ("16x16", 256, 8), "multi": ("2x16x16", 512, 4)}
# the fake 4x4 cell: reduced qwen1.5-4b, 16 x 32 global, remat "full"
FAKE_SHAPE, FAKE_MESH, SEQ, BATCH = (4, 4), ("data", "model"), 32, 16

_FAKE_CELL = """
import json, sys
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.shapes import ShapeSpec
seq, batch = int(sys.argv[1]), int(sys.argv[2])
cfg = get_config("qwen1.5-4b").reduced().scaled(remat="full",
                                                loss_chunk=seq)
print(json.dumps(dryrun.count_on_fake_world(
    cfg, ShapeSpec("train", "train", seq, batch), 16,
    lambda: make_mesh((4, 4), ("data", "model"), "cpu"))))
"""


def _fake_cfg():
    return get_config("qwen1.5-4b").reduced().scaled(remat="full",
                                                     loss_chunk=SEQ)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun",
         "--arch", "rwkv6-7b", "--shape", "decode_32k", "--mesh", "both",
         "--out-dir", str(out)],
        capture_output=True, text=True, cwd=ROOT, env=ENV, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "[dryrun] done: 2 ok, 0 skipped, 0 errors" in r.stdout
    return {mesh: json.load(open(out / f"rwkv6-7b__decode_32k__{name}.json"))
            for mesh, (name, _, _) in MESHES.items()}


@pytest.fixture(scope="module")
def fake_cell():
    r = subprocess.run([sys.executable, "-c", _FAKE_CELL, str(SEQ),
                        str(BATCH)], capture_output=True, text=True,
                       cwd=ROOT, env=ENV, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_cell_record_schema(records, mesh):
    """``tests/distributed/test_dryrun_cell.py``'s checks, and the port's
    own: nothing but the mesh's small CPU rank tables off the meta
    device, whole counts (no extrapolation), the H100 rates."""
    rec = records[mesh]
    assert rec["status"] == "ok"
    assert rec["devices"] == MESHES[mesh][1]
    for key in ("flops", "bytes_accessed", "collective_bytes",
                "bytes_per_device", "roofline", "model_flops_per_device"):
        assert key in rec, key
    assert rec["roofline"]["dominant"] in ("compute_s", "memory_s",
                                           "collective_s")
    # an O(1)-state decode must fit comfortably
    assert rec["bytes_per_device"] < 16 * 2**30
    assert rec["extrapolation"] is None
    assert rec["raw_flops"] == rec["flops"] > 0
    assert rec["collective_bytes"] == rec["collectives"]["total"] > 0
    assert rec["rows"] == MESHES[mesh][2]
    assert set(rec["off_device_bytes"]) <= {"cpu"}
    assert sum(rec["off_device_bytes"].values()) < 2**16
    mem = rec["memory"]
    assert mem["argument_bytes"] + mem["temp_bytes"] \
        == rec["bytes_per_device"]
    # the RWKV state caches are replaced, not updated in place
    assert mem["alias_bytes"] == 0 < mem["output_bytes"]
    assert rec["params_numel"] > rec["params_total"]   # rwkv6's under-count
    assert rec["rates"] == {"peak_flops": 989.4e12, "hbm_bw": 3.35e12,
                            "net_bw": 50e9}


def test_records_give_the_reference_demand(records):
    from repro.core.workloads import demand_from_dryrun_record as ref
    from repro_torch.core.workloads import demand_from_dryrun_record as port
    for rec in records.values():
        got, want = port(rec), ref(rec)
        np.testing.assert_array_equal(got, want)
        assert np.all(got > 0)


def _rank0_batch(cfg, rows):
    rng = np.random.default_rng(0)
    return {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (rows, SEQ)))
            for k in ("tokens", "labels")}


def test_fake_world_flops_equal_a_real_step(fake_cell):
    """Rank 0 of the 4x4 world holds 16 / 4 rows; the one-device step on
    those rows, real tensors on the CPU, counts the same FLOPs."""
    cfg = _fake_cfg()
    rows = BATCH // FAKE_SHAPE[0]
    assert fake_cell["rows"] == rows
    params = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    step = make_train_step(cfg, adamw.AdamWConfig())
    counter = FlopCounterMode(display=False)
    with counter:
        step(params, adamw.init(params), _rank0_batch(cfg, rows))
    assert fake_cell["flops"] == counter.get_total_flops() > 0
    # the parameters and moments are updated in place: the arguments but
    # rank 0's batch (4 x 32 int32 tokens and labels) and the step counter
    assert fake_cell["alias_bytes"] \
        == fake_cell["argument_bytes"] - 2 * rows * SEQ * 4 - 4 > 0


def test_fake_world_all_gathers_are_the_analytic_sum(fake_cell):
    """Each leaf gathered whole: sharded over one mesh dimension, one
    all-gather gives the leaf; over both, the first gives a quarter of it
    (4 x 4) and the second the leaf. Layers' leaves are gathered again in
    the backward under remat "full"; the embedding, final norm and
    unembedding once."""
    cfg = _fake_cfg()
    meta, axes = abstract_params(cfg)
    mesh = shd.AxesMesh(FAKE_MESH, FAKE_SHAPE)
    specs = shd.make_specs(axes, mesh, shd.base_rules(mesh, cfg), meta)

    def gathered(tree, spec_tree):
        total = 0
        for t, spec in zip(adamw.tree_leaves(tree),
                           adamw.tree_leaves(spec_tree)):
            full = t.numel() * t.element_size()
            total += {0: 0, 1: full, 2: full + full // 4}[
                sum(s is not None for s in spec)]
        return total

    layers = gathered(meta["layers"], specs["layers"])
    rest = gathered({k: v for k, v in meta.items() if k != "layers"},
                    {k: v for k, v in specs.items() if k != "layers"})
    assert layers > 0 and rest > 0
    assert fake_cell["collectives"]["all-gather"] == 2 * layers + rest
    # every gradient comes back reduce-scattered onto its shard, and the
    # loss and the clip norm are all-reduced
    assert fake_cell["collective_calls"]["reduce-scatter"] > 0
    assert fake_cell["collective_calls"]["all-reduce"] > 0


def test_fake_world_raises_without_the_fake_backend(monkeypatch):
    monkeypatch.setitem(sys.modules,
                        "torch.testing._internal.distributed.fake_pg", None)
    with pytest.raises(RuntimeError, match="fake process-group backend"):
        with dryrun.fake_world(4):
            pass
    assert not torch.distributed.is_initialized()
