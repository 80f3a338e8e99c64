"""The port stands alone: it imports neither JAX nor the reference package,
and its entry points never fall back to the CPU unasked."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_BLOCKED_IMPORT = """
import importlib, pkgutil, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
assert not any(k.split(".")[0] in ("jax", "jaxlib", "repro")
               for k in sys.modules), sorted(sys.modules)
print(" ".join(names))
print(len(names))
"""


def test_every_module_imports_without_jax_or_repro():
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT],
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT, env={**os.environ,
                                        "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20
    walked = set(out.stdout.split())
    for mod in ("forecast", "problem", "solver", "admm", "controller"):
        assert f"repro_torch.horizon.{mod}" in walked, mod


def test_no_jax_or_repro_import_in_source():
    pattern = re.compile(
        r"^\s*(import\s+(jax|jaxlib|repro)\b|from\s+(jax|jaxlib|repro)\b)",
        re.M)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                          ROOT / "mma_probe.py",
                                          ROOT / "bnb_spread.py",
                                          ROOT / "attention_witness.py"]
    assert len(files) > 20
    hits = [f"{f}: {m.group(0).strip()}" for f in files
            for m in pattern.finditer(f.read_text())]
    assert hits == []


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_the_cpu_unasked(no_cuda):
    from repro_torch import resolve_device
    from repro_torch.core import make_cloud_catalog, problem_from_demand
    from repro_torch.fleet import (TenantSpec, make_trace, replay_fleet,
                                   solve_fleet, solve_fleet_step)
    cat = make_cloud_catalog(n_per_provider=20)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        problem_from_demand(cat, np.ones(4))
    prob = problem_from_demand(cat, np.ones(4), device="cpu")
    with pytest.raises(RuntimeError):
        solve_fleet([prob])
    with pytest.raises(RuntimeError):
        solve_fleet_step(prob, np.zeros((1, cat.n)), 1.0)
    spec = TenantSpec(name="t", trace=make_trace("diurnal", np.ones(4), 2))
    with pytest.raises(RuntimeError):
        replay_fleet(cat, [spec], replay_mode="batched",
                     run_ca_baseline=False)
    for mode in ("sequential", "batched"):
        with pytest.raises(RuntimeError):
            replay_fleet(cat, [spec], replay_mode=mode, controller="mpc",
                         horizon=2, run_ca_baseline=False)
    from repro_torch.horizon import stack_windows, solve_horizon_fleet_step
    with pytest.raises(RuntimeError):
        solve_horizon_fleet_step(stack_windows([[prob, prob]]),
                                 np.zeros((1, cat.n)), 1.0)
    assert resolve_device("cpu").type == "cpu"


def test_model_entry_points_refuse_the_cpu_unasked(no_cuda):
    from repro_torch.bridge import model_params_from_reference
    from repro_torch.configs import get_config
    from repro_torch.models import init_caches, init_model
    for arch in ("qwen1.5-4b", "rwkv6-7b"):
        cfg = get_config(arch).reduced()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_model(cfg, torch.Generator())
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_caches(cfg, 1, 8)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            model_params_from_reference({}, cfg)
        params = init_model(cfg, torch.Generator(), device="cpu")
        assert params["embed"]["table"].device.type == "cpu"
        cache = init_caches(cfg, 1, 8, device="cpu")[0]
        assert all(t.device.type == "cpu" for t in cache)


def test_tf32_is_off():
    import repro_torch  # noqa: F401
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_smoke_script_alone_fails_without_a_result(tmp_path):
    """chip_smoke.py in a directory without the rest of the repo (or without
    a card) exits non-zero and prints no result."""
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
