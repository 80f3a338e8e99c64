"""The port's launcher on a 2x2 ("data", "model") mesh of gloo ranks
against the reference's own ``repro.launch.train`` with ``--mesh 2x2`` on
4 host devices (in a subprocess, as the reference's multi-device tests
run): reduced qwen1.5-4b, 3 steps of 4 x 32, the port starting from the
reference's ``init_model(cfg, PRNGKey(0))`` through ``bridge``. Each
step's loss, grad norm and lr at 2e-4; the parameters after step 3 at
rtol 2e-4 with atol 2e-4 times the leaf's largest element (the key bias,
whose gradient is rounding noise, at 10x that), the tolerances that
``tests/test_torch_train_mesh.py`` holds the mesh runs to. The reference
side records each jitted step's metrics and last parameters by wrapping
the launcher's ``jax.jit``; its ``main()`` runs unchanged."""
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import torch_ranks as R  # noqa: E402
from test_torch_train_mesh import TOL, assert_params_close  # noqa: E402

import repro.models as jm  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402

from repro_torch.bridge import model_params_from_reference  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.testing import spawn_world  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

_REFERENCE = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, numpy as np
    import repro.launch.train as T
    records, last = [], {}

    class _Jax:
        def __getattr__(self, name):
            return getattr(jax, name)

        def jit(self, fn, **kw):
            compiled = jax.jit(fn, **kw)
            def step(*args):
                out = compiled(*args)
                records.append({k: float(v) for k, v in out[2].items()})
                last["params"] = out[0]
                return out
            return step

    T.jax = _Jax()
    out, arch, steps, batch, seq = sys.argv[1:6]
    sys.argv = ["train", "--arch", arch, "--mesh", "2x2", "--steps", steps,
                "--batch", batch, "--seq", seq, "--ckpt-dir",
                os.path.join(os.path.dirname(out), "ck"), "--ckpt-every",
                "50"]
    T.main()
    with open(out, "wb") as f:
        pickle.dump({"history": records, "params": jax.tree_util.tree_map(
            np.asarray, last["params"])}, f)
""")


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The reference's 2x2 launcher run and the port's from the same
    initial parameters."""
    out = tmp_path_factory.mktemp("ref_mesh")
    r = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(out / "ref.pkl"), R.ARCH,
         str(R.STEPS), str(R.BATCH), str(R.SEQ)],
        capture_output=True, text=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    with open(out / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    cfg = launch.train_config(R.ARCH, True, R.SEQ)
    cfg_j = jget(R.ARCH).reduced().scaled(loss_chunk=min(64, R.SEQ))
    values, _ = jm.split(jm.init_model(cfg_j, jax.random.PRNGKey(0)))
    start = model_params_from_reference(
        jax.tree_util.tree_map(np.asarray, values), cfg, "cpu")
    spawn_world(R.world_four_from, 4, out, str(out), start)
    port = torch.load(out / "2x2-from.pt", weights_only=False)
    return ref, port, cfg


@pytest.mark.parametrize("key", ["loss", "grad_norm", "lr"])
def test_port_2x2_metrics_match_the_reference_launcher(both, key):
    ref, port, _ = both
    assert [h["step"] for h in port["history"]] == list(range(R.STEPS))
    assert len(ref["history"]) == R.STEPS
    torch.testing.assert_close(
        torch.tensor([h[key] for h in port["history"]]),
        torch.tensor([h[key] for h in ref["history"]]), rtol=TOL, atol=0)


def test_port_2x2_params_match_the_reference_launcher(both):
    ref, port, cfg = both
    assert_params_close(port["params"],
                        model_params_from_reference(ref["params"], cfg,
                                                    "cpu"))
