"""The port's provenance block and bench regression sentinel, and the two
tools over them: ``repro_torch.obs.regress`` is pinned to the reference's
code; ``config_digest`` gives the reference's digests, for torch values as
for their numpy twins; ``provenance_block`` stamps torch, CUDA and the
backend in place of jax; and ``python -m repro_torch.tools.bench_compare``
/ ``trace_demo --validate`` keep the reference tools' exit codes."""
import ast
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.obs as jobs  # noqa: E402
import repro.obs.regress as jregress  # noqa: E402

import repro_torch.obs as tobs  # noqa: E402
import repro_torch.obs.regress as tregress  # noqa: E402
from repro_torch.tools import bench_compare, trace_demo  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# regress: a pinned copy
# ---------------------------------------------------------------------------

def _code(module):
    """The module's statements as source, its docstring and imports left
    out (the copy's docstring names the port's tool)."""
    src = inspect.getsource(module)
    body = ast.parse(src).body
    if (body and isinstance(body[0], ast.Expr)
            and isinstance(body[0].value, ast.Constant)):
        body = body[1:]
    return [ast.get_source_segment(src, node) for node in body
            if not isinstance(node, (ast.Import, ast.ImportFrom))]


def test_regress_is_the_reference_code():
    got, want = _code(tregress), _code(jregress)
    assert len(got) == len(want) >= 8
    for g, w in zip(got, want):
        assert g == w


def test_regress_compares_card_provenance_by_platform_and_backend_only():
    """Kept on purpose, as in the reference: two cards under one platform
    string and backend are compared, not refused."""
    def doc(device, p50):
        return {"provenance": {"platform": "linux", "backend": "cuda",
                               "device": device, "power_limit": "700.00 W",
                               "config_digest": "d1"},
                "steady_state": {"tick_ms": {"p50": p50}}}
    a, b = doc("NVIDIA H100 80GB HBM3", 10.0), doc("another card", 10.5)
    got = tobs.compare_bench(a, b)
    assert got.ok and not got.refusals
    cpu = dict(doc("x", 10.0), provenance={"platform": "linux",
                                           "backend": "cpu"})
    refused = tobs.compare_bench(a, cpu)
    assert refused.refusals == jobs.compare_bench(a, cpu).refusals
    assert any("backend mismatch" in r for r in refused.refusals)


# ---------------------------------------------------------------------------
# provenance
# ---------------------------------------------------------------------------

CONFIGS = [
    {"B": 3, "quick": True, "seeds": (0, 1, 2), "name": "fleet"},
    {"solver": {"max_iters": 600, "tol": 1e-6, "ladder": [1.0, 0.5]},
     "catalog_stride": 40, "nothing": None},
    {"b": np.float32(0.1), "a": np.int64(7), "grid": np.arange(4.0),
     "nested": {"x": np.array([[1, 2], [3, 4]], np.int32)}},
]


@pytest.mark.parametrize("config", CONFIGS)
def test_config_digest_equals_the_reference(config):
    assert tobs.config_digest(config) == jobs.config_digest(config)


def _torch_twin(obj):
    """The config with every numpy value replaced by its torch twin."""
    if isinstance(obj, dict):
        return {k: _torch_twin(v) for k, v in obj.items()}
    if isinstance(obj, np.generic) or isinstance(obj, np.ndarray):
        return torch.from_numpy(np.asarray(obj))
    return obj


def test_config_digest_takes_torch_values_as_numpy_ones():
    config = CONFIGS[2]
    twin = _torch_twin(config)
    assert isinstance(twin["b"], torch.Tensor) and twin["b"].dim() == 0
    assert tobs.config_digest(twin) == tobs.config_digest(config)
    assert tobs.config_digest(twin) == jobs.config_digest(config)
    # values decide: a different value is a different digest
    assert tobs.config_digest({**twin, "a": torch.tensor(8)}) != \
        tobs.config_digest(twin)
    assert tobs.config_digest({"x": (1, 2)}) == tobs.config_digest(
        {"x": [1, 2]})


def test_provenance_block_on_the_cpu():
    prov = tobs.provenance_block(argv=["--quick"], config=CONFIGS[0],
                                 seeds=[0, np.int64(1)], device="cpu")
    assert prov["backend"] == "cpu"
    assert prov["torch"] == torch.__version__
    assert prov["cuda"] == torch.version.cuda
    assert "jax" not in prov and "jaxlib" not in prov
    assert prov["device"] is None and prov["power_limit"] is None
    assert prov["argv"] == ["--quick"]
    assert prov["seeds"] == [0, 1]
    assert prov["config_digest"] == jobs.config_digest(CONFIGS[0])
    ref = jobs.provenance_block(argv=["--quick"], config=CONFIGS[0],
                                seeds=[0, 1])
    assert (set(ref) - {"jax", "jaxlib"}) < set(prov)
    assert prov["git_sha"] == ref["git_sha"]
    doc = {"provenance": prov}
    assert tobs.validate_bench(doc) == ["no numeric metric leaves found"]
    doc["objective"] = {"cost_integral": 1.0}
    assert tobs.validate_bench(doc) == []
    json.dumps(doc)


def test_provenance_block_never_raises():
    prov = tobs.provenance_block(device=None)     # "cuda", card or not
    assert prov["backend"] == "cuda"
    if not torch.cuda.is_available():
        assert prov["device"] is None
    assert tobs.provenance_block(device="no-such-device")["backend"] is None


# ---------------------------------------------------------------------------
# trace_demo --validate (tests/test_tools_obs.py, on the port's tool)
# ---------------------------------------------------------------------------

def _artifact_pair(tmp_path):
    """A real (trace.json, trace.jsonl) pair from a tiny recorder."""
    with tobs.telemetry() as rec:
        with rec.span("replay/tick", cat="replay", compile_key=("t", 0)):
            pass
    trace = tobs.write_chrome_trace(rec, tmp_path / "trace.json")
    tobs.write_jsonl(rec, tmp_path / "trace.jsonl")
    return trace


def test_trace_demo_validate_ok_on_valid_pair(tmp_path, capsys):
    trace = _artifact_pair(tmp_path)
    assert trace_demo.main(["--validate", str(trace)]) == 0
    assert "OK" in capsys.readouterr().out


def test_trace_demo_validate_nonzero_on_corrupt_jsonl(tmp_path, capsys):
    trace = _artifact_pair(tmp_path)
    (tmp_path / "trace.jsonl").write_text('{"type": "mystery"}\n')
    assert trace_demo.main(["--validate", str(trace)]) == 1
    assert "jsonl schema" in capsys.readouterr().out


def test_trace_demo_validate_nonzero_on_corrupt_trace(tmp_path, capsys):
    trace = _artifact_pair(tmp_path)
    trace.write_text(json.dumps({"traceEvents": [{"ph": "Z", "ts": -1}]}))
    assert trace_demo.main(["--validate", str(trace)]) == 1
    assert "trace schema" in capsys.readouterr().out


def test_trace_demo_replays_on_the_cpu_when_asked(tmp_path, capsys):
    out = tmp_path / "demo" / "trace.json"
    assert trace_demo.main(["--device", "cpu", "--out", str(out)]) == 0
    text = capsys.readouterr().out
    assert "replay report: 4 ticks" in text and "OK" in text
    assert tobs.validate_chrome_trace(out) == []
    assert tobs.validate_jsonl(out.with_suffix(".jsonl")) == []
    assert trace_demo.DEFAULT_OUT.parent == (ROOT / "build"
                                             / "repro_torch_trace")


def test_trace_demo_raises_without_a_card_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trace_demo.main(["--out", str(tmp_path / "trace.json")])
    assert not (tmp_path / "trace.json").exists()


# ---------------------------------------------------------------------------
# bench_compare exit codes (tests/test_tools_obs.py, on the port's tool)
# ---------------------------------------------------------------------------

def _doc(digest="d1", cost=100.0, p50=10.0):
    return {"provenance": {"platform": "linux", "backend": "cpu",
                           "config_digest": digest},
            "objective": {"cost_integral": cost},
            "steady_state": {"tick_ms": {"p50": p50}}}


def _write(tmp_path, name, doc):
    p = tmp_path / name
    p.write_text(json.dumps(doc))
    return str(p)


def test_cli_exit_0_on_clean_pair(tmp_path, capsys):
    a = _write(tmp_path, "a.json", _doc())
    b = _write(tmp_path, "b.json", _doc(cost=100.2, p50=10.5))
    assert bench_compare.main([a, b]) == 0
    assert "OK" in capsys.readouterr().out


def test_cli_exit_1_on_regression(tmp_path, capsys):
    a = _write(tmp_path, "a.json", _doc())
    b = _write(tmp_path, "b.json", _doc(cost=105.0))   # +5% objective
    assert bench_compare.main([a, b]) == 1
    assert "REGRESSION" in capsys.readouterr().out
    # a looser tolerance turns the same pair green
    assert bench_compare.main([a, b, "--objective-rtol", "0.10"]) == 0


def test_cli_exit_2_on_refusal(tmp_path, capsys):
    a = _write(tmp_path, "a.json", _doc())
    b = _write(tmp_path, "b.json", _doc(digest="d2"))
    assert bench_compare.main([a, b]) == 2
    assert "REFUSED" in capsys.readouterr().out


def test_cli_set_path_helper():
    doc = {"a": {"b": [1.0, {"c": 2.0}]}}
    bench_compare._set_path(doc, "a.b.1.c", 9.0)
    bench_compare._set_path(doc, "a.b.0", 7.0)
    assert doc == {"a": {"b": [7.0, {"c": 9.0}]}}


def _stamped_doc(tmp_path):
    """A BENCH document stamped by the port's provenance block, with a
    timing, an objective and a quality leaf and a telemetry section."""
    with tobs.telemetry() as rec:
        with rec.span("replay/tick", cat="replay", compile_key=("t", 0)):
            pass
        with rec.span("replay/tick", cat="replay", compile_key=("t", 0)):
            pass
    config = {"tenants": 2, "ticks": 4, "catalog_stride": 40}
    doc = {"provenance": tobs.provenance_block(argv=[], config=config,
                                               seeds=[0, 1], device="cpu"),
           "config": config,
           "steady_state": {"tick_ms": {"p50": 12.5, "p95": 20.0}},
           "objective": {"cost_integral": 101.3, "total_churn": 8.0},
           "quality": {"savings_vs_ca_pct": 12.4},
           "telemetry": tobs.ReplayReport.from_recorder(rec).to_dict()}
    assert tobs.validate_bench(doc) == []
    return _write(tmp_path, "bench.json", doc)


def test_cli_selftest_passes_on_a_stamped_doc(tmp_path, capsys):
    path = _stamped_doc(tmp_path)
    assert bench_compare.main(["--selftest", path]) == 0
    assert "selftest OK" in capsys.readouterr().out


def test_cli_selftest_fails_without_objective_leaves(tmp_path):
    doc = json.loads(Path(_stamped_doc(tmp_path)).read_text())
    del doc["objective"]
    with pytest.raises(SystemExit, match="objective"):
        bench_compare.main(["--selftest", _write(tmp_path, "no_obj.json",
                                                 doc)])


def test_cli_runs_as_a_module(tmp_path):
    path = _stamped_doc(tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.tools.bench_compare",
         "--selftest", path], capture_output=True, text=True, timeout=120,
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert "selftest OK" in out.stdout
