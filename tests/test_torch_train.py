"""The training launcher's pieces on the CPU: the data pipeline's copy
(pinned to ``repro.data.pipeline``), checkpoints of torch trees (a round
trip, an uncommitted step skipped by ``load_latest``, the async writer and
its garbage collection), and ``python -m repro_torch.launch.train`` end to
end with ``--device cpu`` and a checkpoint every step."""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.data.pipeline as jpipe  # noqa: E402

import repro_torch.data.pipeline as tpipe  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.models import init_model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402


def test_pipeline_copy_equals_the_original():
    """The copy is the reference's file, and draws the same batches."""
    assert (Path(tpipe.__file__).read_text()
            == Path(jpipe.__file__).read_text())
    cfg = dict(vocab_size=300, seq_len=17, global_batch=6, seed=3)
    a = jpipe.SyntheticLM(jpipe.DataConfig(**cfg))
    b = tpipe.SyntheticLM(tpipe.DataConfig(**cfg))
    for step in (0, 5):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a.global_batch(step)[k],
                                          b.global_batch(step)[k])
            np.testing.assert_array_equal(a.shard_batch(step, 1, 3)[k],
                                          b.shard_batch(step, 1, 3)[k])


def _state(seed=0, dtype="float32"):
    cfg = get_config("qwen1.5-4b").reduced().scaled(param_dtype=dtype)
    params = init_model(cfg, torch.Generator().manual_seed(seed), "cpu")
    state = adamw.init(params)
    state = state._replace(step=state.step + 7)
    return {"p": params, "o": state}


def _equal(a, b):
    la, lb = adamw.tree_leaves([a["p"], list(a["o"])]), \
        adamw.tree_leaves([b["p"], list(b["o"])])
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_round_trip(tmp_path, dtype):
    tree = _state(0, dtype)
    step_dir = ckpt.save(str(tmp_path), 12, tree, extra={"loss": 2.5})
    names = {p.name for p in Path(step_dir).iterdir()}
    n = len(adamw.tree_leaves([tree["p"], list(tree["o"])]))
    assert names == {"_COMMITTED", "manifest.json"} | {
        f"arr_{i}.npy" for i in range(n)}
    step, back, extra = ckpt.load(step_dir, _state(1, dtype))
    assert step == 12 and extra == {"loss": 2.5}
    assert isinstance(back["o"], adamw.AdamWState)
    assert _equal(back, tree)
    with pytest.raises(ValueError, match="leaves"):
        ckpt.load(step_dir, {"p": tree["p"]})


def test_load_latest_skips_an_uncommitted_step(tmp_path):
    assert ckpt.load_latest(str(tmp_path), _state()) is None
    ckpt.save(str(tmp_path), 3, _state(3))
    partial = Path(ckpt.save(str(tmp_path), 5, _state(5)))
    (partial / "_COMMITTED").unlink()           # a write cut before commit
    (tmp_path / "step_00000009.tmp").mkdir()    # and one cut before rename
    assert ckpt.latest_step_dir(str(tmp_path)).endswith("step_00000003")
    step, back, _ = ckpt.load_latest(str(tmp_path), _state())
    assert step == 3 and _equal(back, _state(3))


def test_async_checkpointer_copies_then_writes_and_keeps_two(tmp_path):
    """save() copies the leaves at once: an in-place update after it does
    not reach the file; steps past ``keep`` are removed."""
    saver = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    tree = _state(0)
    want = _state(0)
    for step in (1, 2, 3):
        saver.save(step, tree, extra={"step": step})
        with torch.no_grad():
            for p in adamw.tree_leaves(tree["p"]):
                p.add_(1.0)
    saver.wait()
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000002", "step_00000003"]
    with torch.no_grad():
        for p in adamw.tree_leaves(want["p"]):
            p.add_(1.0).add_(1.0)       # the tree as step 3 saw it
    step, back, extra = ckpt.load_latest(str(tmp_path), _state(1))
    assert step == 3 and extra == {"step": 3} and _equal(back, want)


def test_launch_train_runs_end_to_end_on_cpu(tmp_path, capsys):
    """The reference's defaults on the reduced qwen1.5-4b, 4 steps of 2 x
    32, a checkpoint every step (steps 1-3, two kept), then a restart from
    the latest checkpoint."""
    launch.main(["--arch", "qwen1.5-4b", "--steps", "4", "--batch", "2",
                 "--seq", "32", "--ckpt-dir", str(tmp_path),
                 "--ckpt-every", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[launch] done" in out and "step    3 loss=" in out
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000002", "step_00000003"]
    cfg = launch.train_config("qwen1.5-4b", True, 32)
    like = init_model(cfg, torch.Generator(), "cpu")
    step, tree, extra = ckpt.load_latest(str(tmp_path), {
        "p": like, "o": adamw.init(like)})
    assert step == 3 and int(tree["o"].step) == 4 and np.isfinite(
        extra["loss"])
    params, state, hist = launch.train(
        cfg, steps=2, batch=2, seq=32, ckpt_dir=str(tmp_path / "more"),
        device="cpu", params=tree["p"], opt_state=tree["o"], first_step=4,
        total_steps=6, log=lambda *_: None)
    assert [h["step"] for h in hist] == [4, 5] and int(state.step) == 6
    assert all(np.isfinite(h["loss"]) and h["grad_norm"] > 0 for h in hist)


def test_launch_train_wants_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.main(["--steps", "1"])
