"""int8 gradient compression with error feedback against
``repro.optim.grad_compress``: ``compress_decompress`` over 50 error-
feedback steps at sizes that are and are not multiples of BLOCK = 256, in
float32 and bfloat16; ``compressed_psum`` and ``tree_compressed_psum`` on
4 gloo ranks against the reference's under ``shard_map`` on 4 host
devices (in a subprocess, as the reference's own multi-device test runs
it). The port's outputs lie within one quantisation step (the element's
block scale) of the reference's; the count of elements that differ at
all is asserted at its measured value, 0."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import torch_ranks as R  # noqa: E402

import repro.optim.grad_compress as jgc  # noqa: E402

import repro_torch.optim.grad_compress as tgc  # noqa: E402
from repro_torch.testing import spawn_world  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
STEPS = 50
SHAPES = [(256,), (300,), (3, 100), (4, 512)]


def _scale_per_element(x: np.ndarray) -> np.ndarray:
    """One quantisation step of each element: its block's max |x| / 127."""
    flat = x.astype(np.float32).reshape(-1)
    pad = (-flat.size) % tgc.BLOCK
    blocks = np.pad(flat, (0, pad)).reshape(-1, tgc.BLOCK)
    scale = np.maximum(np.abs(blocks).max(1, keepdims=True) / 127.0, 1e-12)
    return np.broadcast_to(scale, blocks.shape).reshape(-1)[:flat.size]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_compress_decompress_matches_the_reference(shape, dtype):
    rng = np.random.default_rng(0)
    err_j = jnp.zeros(shape, jnp.float32)
    err_t = torch.zeros(shape, dtype=torch.float32)
    unequal = 0
    for _ in range(STEPS):
        g = rng.normal(0, 1, shape).astype(np.float32)
        gt = torch.as_tensor(g).to(getattr(torch, dtype))
        gj = jnp.asarray(gt.float().numpy()).astype(getattr(jnp, dtype))
        step = _scale_per_element(np.asarray(gt.float()) + np.asarray(err_t))
        deq_j, err_j = jgc.compress_decompress(gj, err_j)
        deq_t, err_t = tgc.compress_decompress(gt, err_t)
        assert deq_t.dtype == gt.dtype and err_t.dtype == torch.float32
        dj = np.asarray(deq_j.astype(jnp.float32)).reshape(-1)
        dt = deq_t.float().numpy().reshape(-1)
        assert (np.abs(dt - dj) <= step).all()
        assert (np.abs(err_t.numpy().reshape(-1)
                       - np.asarray(err_j).reshape(-1)) <= step).all()
        unequal += int((dt != dj).sum())
    assert unequal == 0


def test_error_feedback_tracks_the_running_sum():
    """The reference's test on the port: the running sum of the
    dequantised gradients stays within one quantisation step of the true
    running sum."""
    rng = np.random.default_rng(0)
    true_sum = np.zeros(300, np.float32)
    seen_sum = np.zeros(300, np.float32)
    err = torch.zeros(300)
    for _ in range(STEPS):
        g = torch.as_tensor(rng.normal(0, 1, 300), dtype=torch.float32)
        deq, err = tgc.compress_decompress(g, err)
        true_sum += g.numpy()
        seen_sum += deq.numpy()
    resid = np.abs(true_sum - seen_sum).max()
    assert resid <= float(err.abs().max()) + 1e-5
    assert resid < 0.2


_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.optim.grad_compress import (compressed_psum, init_state,
                                           tree_compressed_psum)
    from repro.launch.mesh import make_mesh
    from repro.distributed.sharding import shard_map_compat
    data = np.load(sys.argv[1])
    mesh = make_mesh((4,), ("data",))
    g = jnp.asarray(data["g"])
    tree = {"a": jnp.asarray(data["a"]), "b": [jnp.asarray(data["b"])]}
    f = shard_map_compat(lambda g, e: compressed_psum(g, e, "data"),
                         mesh=mesh, in_specs=(P("data"), P("data")),
                         out_specs=(P("data"), P("data")))
    out, err = f(g, jnp.zeros(g.shape, jnp.float32))
    def tf(t):
        s, st = tree_compressed_psum(t, init_state(t), "data")
        return s, st.error
    spec = {"a": P("data"), "b": [P("data")]}
    ft = shard_map_compat(tf, mesh=mesh, in_specs=(spec,),
                          out_specs=(spec, spec))
    sums, errs = ft(tree)
    np.savez(sys.argv[2], out=np.asarray(out), err=np.asarray(err),
             a=np.asarray(sums["a"]), b=np.asarray(sums["b"][0]),
             a_err=np.asarray(errs["a"]), b_err=np.asarray(errs["b"][0]))
""")


@pytest.fixture(scope="module")
def psums(tmp_path_factory):
    """The reference's and the port's sums of the same rows."""
    out = tmp_path_factory.mktemp("psum")
    rng = np.random.default_rng(0)
    data = {"g": rng.normal(0, 1, (4, 300)).astype(np.float32),
            "a": rng.normal(0, 1, (4, 3, 100)).astype(np.float32),
            "b": rng.normal(0, 1e-3, (4, 512)).astype(np.float32)}
    np.savez(out / "in.npz", **data)
    r = subprocess.run([sys.executable, "-c", _REFERENCE,
                        str(out / "in.npz"), str(out / "ref.npz")],
                       capture_output=True, text=True, cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    tensors = {k: torch.as_tensor(v) for k, v in data.items()}
    spawn_world(R.psum_ranks, 4, out, str(out), tensors["g"],
                {"a": tensors["a"], "b": [tensors["b"]]})
    ranks = [torch.load(out / f"psum_{r}.pt") for r in range(4)]
    return data, dict(np.load(out / "ref.npz")), ranks


def _within_a_step(got, want, summed_rows):
    """|got - want| within one step of the shared grid (the block's max
    scale over the ranks), and the count of unequal elements."""
    step = np.max([_scale_per_element(r) for r in summed_rows], axis=0)
    got, want = got.reshape(-1), want.reshape(-1)
    assert (np.abs(got - want) <= step).all()
    return int((got != want).sum())


def test_compressed_psum_on_four_ranks_matches_the_reference(psums):
    data, ref, ranks = psums
    unequal = 0
    for r, rank in enumerate(ranks):
        unequal += _within_a_step(rank["out"].numpy(), ref["out"][r],
                                  list(data["g"]))
        unequal += _within_a_step(rank["err"].numpy(), ref["err"][r],
                                  list(data["g"]))
    assert unequal == 0
    true = data["g"].sum(0)
    got = ranks[0]["out"].numpy()
    assert np.abs(got - true).max() / np.abs(true).max() < 0.05
    for rank in ranks[1:]:
        assert torch.equal(rank["out"], ranks[0]["out"])


@pytest.mark.parametrize("leaf", ["a", "b"])
def test_tree_compressed_psum_matches_the_reference(psums, leaf):
    data, ref, ranks = psums
    unequal = 0
    for r, rank in enumerate(ranks):
        got = rank["tree"][leaf] if leaf == "a" else rank["tree"]["b"][0]
        err = (rank["tree_err"][leaf] if leaf == "a"
               else rank["tree_err"]["b"][0])
        rows = list(data[leaf])
        unequal += _within_a_step(got.numpy(), ref[leaf][r], rows)
        unequal += _within_a_step(err.numpy(), ref[f"{leaf}_err"][r], rows)
    assert unequal == 0
