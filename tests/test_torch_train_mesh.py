"""``launch.train`` on ("data", "model") meshes of gloo ranks on the CPU
against the port's one-device run, which ``tests/test_torch_train_step.py``
holds to the reference (``tests/test_torch_train_mesh_reference.py``
holds the 2x2 run to the reference's own launcher): reduced qwen1.5-4b
for 3 steps on 2x1, 1x2 and 2x2 meshes and on 2x1 under remat "full"
(loss and grad norm at 2e-4; parameters at rtol 2e-4 with atol
2e-4 times the leaf's largest element), one step of each of the ten
reduced configs at 2x2, each rank's local bytes as its placements divide
them, a 2x2 checkpoint resumed by a 1x1 run, and a mesh that does not
match the world raising. The ranks run in spawned processes
(``repro_torch.testing.spawn_world``, a ``file://`` store in tmp_path);
their functions are in ``tests/torch_ranks.py``."""
import math

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch_ranks as R  # noqa: E402

from repro_torch.configs import list_archs  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import init_model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.testing import spawn_world  # noqa: E402

TOL = 2e-4                      # loss, grad norm; parameters (see above)
# a key bias (qkv_bias configs) has a zero gradient in exact arithmetic: a
# bias on k shifts every score of a query alike, and the softmax ignores
# it. What moves it is rounding noise, which Adam scales to lr-sized
# steps, so its largest element is noise too; it is held at 10x TOL of it
NOISE_LEAVES = ("bk",)
ARCHS = list_archs()


def _paths(tree, pre=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{pre}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{pre}[{i}]")
    else:
        yield pre, tree


def assert_params_close(got, want):
    got = dict(_paths(got))
    for path, w in _paths(want):
        g = got[path].detach()
        w = w.detach()
        scale = TOL * (10 if path.split(".")[-1] in NOISE_LEAVES else 1)
        torch.testing.assert_close(g, w, rtol=TOL,
                                   atol=scale * float(w.abs().max()),
                                   msg=lambda m: f"{path}: {m}")


@pytest.fixture(scope="module")
def no_mesh(tmp_path_factory):
    """The one-device launcher run (checkpoints after steps 1 and 2)."""
    cfg = launch.train_config(R.ARCH, True, R.SEQ)
    params, state, hist = launch.train(
        cfg, steps=R.STEPS, batch=R.BATCH, seq=R.SEQ, device="cpu",
        ckpt_every=R.STEPS + 1, ckpt_dir=str(tmp_path_factory.mktemp("ck")),
        log=lambda *_: None)
    return params, state, hist


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mesh run: 2x1 and 1x2 in a world of two, 2x2 (checkpoints,
    local bytes, the ten one-step configs) in a world of four, the 1x1
    resume in a world of one."""
    out = tmp_path_factory.mktemp("mesh")
    spawn_world(R.world_two, 2, out, str(out))
    spawn_world(R.world_four, 4, out, str(out), ARCHS)
    spawn_world(R.world_one, 1, out, str(out))
    load = lambda name: torch.load(out / f"{name}.pt", weights_only=False)
    return {"2x1": load("2x1"), "1x2": load("1x2"), "2x2": load("2x2"),
            "2x1-remat-full": load("2x1-remat-full"),
            "bytes": [load(f"bytes_{r}") for r in range(4)],
            "one_step": load("one_step_2x2"),
            "restored": load("restored_1x1")}


@pytest.mark.parametrize("shape", ["2x1", "1x2", "2x2", "2x1-remat-full"])
def test_launcher_on_a_mesh_matches_one_device(no_mesh, runs, shape):
    params, _, hist = no_mesh
    run = runs[shape]
    assert [h["step"] for h in run["history"]] == list(range(R.STEPS))
    for key in ("loss", "grad_norm", "lr"):
        torch.testing.assert_close(
            torch.tensor([h[key] for h in run["history"]]),
            torch.tensor([h[key] for h in hist]), rtol=TOL, atol=0)
    assert_params_close(run["params"], params)


@pytest.mark.parametrize("shape", ["2x1", "1x2", "2x2", "2x1-remat-full"])
def test_mesh_moments_match_one_device(no_mesh, runs, shape):
    _, state, _ = no_mesh
    got = runs[shape]["state"]
    assert int(got.step) == int(state.step) == R.STEPS
    for name in ("m", "v"):
        for g, w in zip(adamw.tree_leaves(getattr(got, name)),
                        adamw.tree_leaves(getattr(state, name))):
            torch.testing.assert_close(g, w, rtol=2 * TOL,
                                       atol=2 * TOL * float(w.abs().max()))


@pytest.fixture(scope="module")
def one_device_steps():
    """One make_train_step of every reduced config on the whole batch."""
    out = {}
    for arch in ARCHS:
        cfg = R.one_step_config(arch)
        params = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
        step = make_train_step(cfg, adamw.AdamWConfig(
            lr=1e-3, warmup_steps=20, total_steps=3))
        params, _, metrics = step(params, adamw.init(params),
                                  R.one_step_batch(cfg))
        out[arch] = ({k: float(v) for k, v in metrics.items()}, params)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_one_step_at_2x2_matches_one_device(one_device_steps, runs, arch):
    want_m, want_p = one_device_steps[arch]
    got_m, got_p = runs["one_step"][arch]
    for key in ("loss", "xent", "aux", "grad_norm"):
        assert math.isclose(got_m[key], want_m[key], rel_tol=TOL,
                            abs_tol=1e-7), (key, got_m[key], want_m[key])
    assert_params_close(got_p, want_p)


def test_each_rank_holds_its_shards(runs):
    """Each rank's leaves have the local shape its placements give (a
    Shard(d) on a mesh dimension of 2 halves dim d), and the four ranks'
    bytes add up to the state's bytes times its replication."""
    for rank in runs["bytes"]:
        for local, full, placements in rank["leaves"]:
            want = list(full)
            for p in placements:
                if p.startswith("S("):
                    want[int(p[2:-1])] //= 2
            assert list(local) == want, (local, full, placements)
    assert len({r["bytes"] for r in runs["bytes"]}) == 1
    params, state = runs["2x2"]["params"], runs["2x2"]["state"]
    full = sum(t.numel() * t.element_size() for t in adamw.tree_leaves(
        [params, state.m, state.v]))
    assert runs["bytes"][0]["bytes"] < full
    sharded = sum(1 for r in runs["bytes"] for _, _, pl in r["leaves"]
                  if any(p.startswith("S(") for p in pl))
    assert sharded > 0


def test_a_2x2_checkpoint_resumes_on_1x1(runs):
    rec = runs["restored"]
    assert rec["step"] == R.RESUME
    tail = runs["2x2"]["history"][R.RESUME + 1:]
    assert [h["step"] for h in rec["history"]] == [h["step"] for h in tail]
    for key in ("loss", "grad_norm"):
        torch.testing.assert_close(
            torch.tensor([h[key] for h in rec["history"]]),
            torch.tensor([h[key] for h in tail]), rtol=TOL, atol=0)
    assert_params_close(rec["params"], runs["2x2"]["params"])


def test_a_mesh_off_the_world_size_raises(runs):
    assert "needs 2 ranks; the world has 1" in runs["restored"]["mismatch"]
