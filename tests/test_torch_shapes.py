"""The port's dry-run shapes and abstract trees against the reference's:
``launch.shapes`` (``SHAPES``, ``cell_applicable``, ``ruleset_name``,
``input_specs`` as meta tensors, ``batch_axes``) and ``dryrun._model_flops``
for all ten configs and four shapes; ``models.cache_axes`` against the
reference's per layer (its stacked "layers" axis dropped) and against
``init_caches`` on the meta device; ``models.abstract_params`` against the
reference's ``abstract_params`` in the per-layer layout; and
``adamw.abstract_state``. Nothing here allocates: the port's trees are on
the meta device, the reference's are ShapeDtypeStructs."""
import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.launch.shapes as JS  # noqa: E402
import repro.optim.adamw as jadamw  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.models import abstract_params as j_abstract_params  # noqa: E402
from repro.models.transformer import cache_axes as j_cache_axes  # noqa: E402

import repro_torch.launch.shapes as TS  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import (abstract_params, cache_axes,  # noqa: E402
                                init_caches, param_axes)
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = list_archs()
DTYPES = {torch.int32: jnp.int32, torch.bfloat16: jnp.bfloat16,
          torch.float32: jnp.float32}


def _reference_model_flops():
    """The reference's ``_model_flops``, taken from its source: importing
    ``repro.launch.dryrun`` would set XLA_FLAGS for this process."""
    src = (ROOT / "src" / "repro" / "launch" / "dryrun.py").read_text()
    fn = next(n for n in ast.parse(src).body
              if isinstance(n, ast.FunctionDef) and n.name == "_model_flops")
    scope = {}
    exec(compile(ast.Module([fn], []), "dryrun.py", "exec"), scope)
    return scope["_model_flops"]


def _same_leaf(got, want):
    assert got.device.type == "meta"
    assert tuple(got.shape) == tuple(want.shape)
    assert DTYPES[got.dtype] == want.dtype


def test_shapes_equal_the_reference():
    assert list(TS.SHAPES) == list(JS.SHAPES)
    for name, s in TS.SHAPES.items():
        w = JS.SHAPES[name]
        assert (s.name, s.kind, s.seq, s.batch, s.long) \
            == (w.name, w.kind, w.seq, w.batch, w.long)
    assert (TS.SHAPES["long_500k"].batch, TS.SHAPES["long_500k"].seq,
            TS.SHAPES["long_500k"].long) == (1, 524288, True)


@pytest.mark.parametrize("arch", ARCHS)
def test_cells_rules_and_model_flops_equal_the_reference(arch):
    ref_flops = _reference_model_flops()
    for name in TS.SHAPES:
        shape, jshape = TS.SHAPES[name], JS.SHAPES[name]
        cfg = dryrun.cell_config(arch, shape)
        jcfg = j_config(arch).scaled(dtype="bfloat16", param_dtype="bfloat16",
                                     loss_chunk=shape.seq)
        assert TS.cell_applicable(cfg, shape) \
            == JS.cell_applicable(jcfg, jshape)
        assert TS.ruleset_name(shape) == JS.ruleset_name(jshape)
        assert dryrun._model_flops(cfg, shape) == ref_flops(jcfg, jshape)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_are_meta_with_the_reference_shapes(arch):
    cfg, jcfg = get_config(arch), j_config(arch)
    for name, shape in TS.SHAPES.items():
        got = TS.input_specs(cfg, shape)
        want = JS.input_specs(jcfg, JS.SHAPES[name])
        assert list(got) == list(want)
        if shape.kind != "decode":
            assert list(got["batch"]) == list(want["batch"])
            for k, t in got["batch"].items():
                _same_leaf(t, want["batch"][k])
            continue
        _same_leaf(got["tokens"], want["tokens"])
        _same_leaf(got["pos"], want["pos"])
        # the reference's group entry j holds layers j, j + period, ...
        # stacked along its first axis; the port's list holds each alone
        caches, stacked = got["caches"], want["caches"]
        assert len(caches) == cfg.n_layers
        for i, cache in enumerate(caches):
            ref = stacked[i % cfg.period]
            assert type(cache).__name__ == type(ref).__name__
            for t, w in zip(cache, ref):
                assert w.shape[0] == cfg.n_groups
                _same_leaf(t, jax.ShapeDtypeStruct(w.shape[1:], w.dtype))


def _drop_layers(tree):
    """The reference's axes without their leading "layers" entry."""
    if type(tree) is tuple:
        assert tree[0] == "layers"
        return tree[1:]
    return type(tree)(*map(_drop_layers, tree))


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_axes_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), j_config(arch)
    want = [_drop_layers(c) for c in j_cache_axes(jcfg)]
    got = cache_axes(cfg)
    assert len(got) == cfg.n_layers
    for i, axes in enumerate(got):
        assert type(axes).__name__ == type(want[i % cfg.period]).__name__
        assert tuple(axes) == tuple(want[i % cfg.period])
    for name, shape in TS.SHAPES.items():
        g, w = TS.batch_axes(cfg, shape), JS.batch_axes(jcfg, JS.SHAPES[name])
        if shape.kind == "decode":
            stacked = w.pop("caches")
            assert [tuple(c) for c in g.pop("caches")] \
                == [tuple(_drop_layers(stacked[i % cfg.period]))
                    for i in range(cfg.n_layers)]
        assert g == w


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "rwkv6-7b",
                                  "jamba-1.5-large-398b"])
def test_cache_axes_match_init_caches_rank_by_rank(arch):
    cfg = get_config(arch)
    for axes, cache in zip(cache_axes(cfg),
                           init_caches(cfg, 3, 8, device="meta")):
        assert type(axes) is type(cache)
        for a, t in zip(axes, cache):
            assert len(a) == t.ndim


def test_cache_axes_raise_when_a_table_drifts(monkeypatch):
    """init_caches on the meta device is the source: axes of another rank
    raise, naming the cache."""
    cfg = get_config("qwen1.5-4b").reduced()
    kv = tt._CACHE_AXES["attn"]
    monkeypatch.setitem(tt._CACHE_AXES, "attn",
                        type(kv)(kv.k[:-1], kv.v))
    with pytest.raises(ValueError, match=r"cache_axes: caches\[0\]\.k"):
        cache_axes(cfg)


def _port_layout(cfg, tree):
    """The reference's parameter tree (groups stacked) in the port's
    per-layer layout, each group leaf without its leading axis."""
    def drop(t):
        if isinstance(t, dict):
            return {k: drop(v) for k, v in t.items()}
        return tuple(t.shape[1:]), t.dtype
    out = {k: jax.tree_util.tree_map(lambda t: (tuple(t.shape), t.dtype), v)
           for k, v in tree.items() if k != "groups"}
    out["layers"] = [drop(tree["groups"][i % cfg.period])
                     for i in range(cfg.n_layers)]
    return out


def _flat(tree, pre=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{pre}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{pre}[{i}]")
    else:
        yield pre, tree


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_equal_the_reference_unstacked(arch):
    cfg = get_config(arch)
    meta, axes = abstract_params(cfg)
    assert axes == param_axes(cfg)
    want = dict(_flat(_port_layout(cfg, j_abstract_params(j_config(arch))[0])))
    got = dict(_flat(meta))
    assert sorted(got) == sorted(want)
    for path, t in got.items():
        shape, dtype = want[path]
        assert t.device.type == "meta", path
        assert (tuple(t.shape), DTYPES[t.dtype]) == (shape, dtype), path


def test_abstract_state_dtypes():
    cfg = get_config("mixtral-8x22b").reduced().scaled(param_dtype="bfloat16")
    meta, _ = abstract_params(cfg)
    state = adamw.abstract_state(meta)
    jstate = jadamw.abstract_state(
        j_abstract_params(j_config("mixtral-8x22b").reduced().scaled(
            param_dtype="bfloat16"))[0])
    assert state.step.device.type == "meta" and state.step.shape == ()
    assert DTYPES[state.step.dtype] == jstate.step.dtype
    for tree, jtree in ((state.m, jstate.m), (state.v, jstate.v)):
        for t, p in zip(adamw.tree_leaves(tree), adamw.tree_leaves(meta)):
            assert t.device.type == "meta"
            assert t.dtype == torch.float32 and t.shape == p.shape
        assert {leaf.dtype for leaf in jax.tree_util.tree_leaves(jtree)} \
            == {jnp.dtype(jnp.float32)}
