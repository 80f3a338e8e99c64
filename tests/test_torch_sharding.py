"""The port's sharding rules against ``repro.distributed.sharding``: the
rule sets on 2-axis and 3-axis meshes, ``spec_for``'s divisibility skip
(``tests/distributed/test_dryrun_cell.py::test_logical_rules_
divisibility``'s two cases), ``param_axes(cfg)`` for all ten configs
against the reference's ``abstract_params(cfg)`` axes in the per-layer
layout, ``make_specs`` for all ten full-size configs on 16x16 and 2x16x16
meshes (duck-typed: names and sizes, no ranks) against the reference's
PartitionSpecs, ``adamw.state_axes``, the placements of a spec, and
``constrain`` and the rule context."""
import threading

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from jax.sharding import PartitionSpec as P  # noqa: E402

import repro.distributed.sharding as J  # noqa: E402
import repro.optim.adamw as jadamw  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.models import abstract_params  # noqa: E402

import repro_torch.distributed.sharding as T  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.models import init_model, param_axes  # noqa: E402
from repro_torch.models.transformer import layer_kinds  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

ARCHS = list_archs()
MESHES = {"16x16": T.AxesMesh(("data", "model"), (16, 16)),
          "2x16x16": T.AxesMesh(("pod", "data", "model"), (2, 16, 16)),
          "2x8": T.AxesMesh(("data", "model"), (2, 8))}


def _map(fn, tree, is_leaf):
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v, is_leaf) for k, v in tree.items()}
    return [_map(fn, v, is_leaf) for v in tree]


def _to_port_layout(cfg, tree, drop_first, is_leaf):
    """Reference tree (groups stacked) -> port layout, dropping each group
    leaf's first entry (its "layers" axis or spec entry)."""
    out = {k: v for k, v in tree.items() if k != "groups"}
    out["layers"] = [
        _map(drop_first, tree["groups"][i % cfg.period], is_leaf)
        for i in range(cfg.n_layers)]
    return out


def _sorted(tree):
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_sorted(v) for v in tree]
    return tree


@pytest.fixture(scope="module")
def trees():
    """Per config: the reference's (shapes, axes) and the port's (meta
    tree, axes)."""
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch)
        out[arch] = (abstract_params(j_config(arch)),
                     init_model(cfg, torch.Generator(), "meta"),
                     param_axes(cfg))
    return out


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("which", ["train", "prefill", "decode", "long"])
@pytest.mark.parametrize("arch", [None, "qwen1.5-4b", "jamba-1.5-large-398b",
                                  "rwkv6-7b"])
def test_rules_equal_the_reference(mesh, which, arch):
    m = MESHES[mesh]
    got = T.RULESETS[which](m, None if arch is None else get_config(arch))
    want = J.RULESETS[which](m, None if arch is None else j_config(arch))
    assert got == want
    assert list(T.RULESETS) == list(J.RULESETS)


@pytest.mark.parametrize("experts,want", [(6, (None, "data", "model")),
                                          (8, ("model", "data", None))])
def test_spec_for_skips_an_indivisible_assignment(experts, want):
    mesh = MESHES["2x8"]
    rules = T.base_rules(mesh)
    got = T.spec_for(("expert", "embed", "mlp"), rules, mesh,
                     shape=(experts, 64, 128))
    assert got == want
    assert got == tuple(J.spec_for(("expert", "embed", "mlp"),
                                   J.base_rules(mesh), mesh,
                                   shape=(experts, 64, 128)))


def test_spec_for_without_rules_or_axes_is_empty():
    assert T.spec_for(("embed",)) == () == tuple(J.spec_for(("embed",)))
    rules = T.base_rules(MESHES["16x16"])
    assert T.spec_for(None, rules) == () == tuple(J.spec_for(None, rules))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_equal_the_reference(trees, arch):
    (_, ref_axes), meta, axes = trees[arch]
    cfg = get_config(arch)
    want = _to_port_layout(cfg, ref_axes, lambda a: a[1:], J.is_axes_leaf)
    assert all(g[0] == "layers"
               for g in adamw.tree_leaves(ref_axes["groups"]))
    assert _sorted(axes) == _sorted(want)
    # keyed and ordered as init_model's tree, one axis per dimension
    assert list(axes) == list(meta)
    assert len(axes["layers"]) == len(layer_kinds(cfg))
    for layer in axes["layers"]:
        assert set(layer) == {"norm1", "mix", "norm2", "ffn"}
    for a, t in zip(adamw.tree_leaves(axes), adamw.tree_leaves(meta)):
        assert len(a) == t.ndim


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_make_specs_equal_the_reference(trees, arch, mesh):
    (ref_vals, ref_axes), meta, axes = trees[arch]
    m = MESHES[mesh]
    cfg = get_config(arch)
    want = J.make_specs(ref_axes, m, J.base_rules(m, j_config(arch)),
                        ref_vals)
    assert all(s[0] is None for s in adamw.tree_leaves(
        _map(tuple, want["groups"], lambda x: isinstance(x, P))))
    want = _to_port_layout(cfg, _map(tuple, want, lambda x: isinstance(x, P)),
                           lambda s: s[1:], lambda x: type(x) is tuple)
    got = T.make_specs(axes, m, T.base_rules(m, cfg), meta)
    assert _sorted(got) == _sorted(want)
    # without shapes too
    want_ns = J.make_specs(ref_axes, m, J.base_rules(m, j_config(arch)))
    want_ns = _to_port_layout(
        cfg, _map(tuple, want_ns, lambda x: isinstance(x, P)),
        lambda s: s[1:], lambda x: type(x) is tuple)
    assert _sorted(T.make_specs(axes, m, T.base_rules(m, cfg))) \
        == _sorted(want_ns)


def test_state_axes_mirror_the_params(trees):
    _, _, axes = trees["qwen1.5-4b"]
    got = adamw.state_axes(axes)
    want = jadamw.state_axes(axes)
    assert type(got).__name__ == type(want).__name__ == "AdamWState"
    assert got.step is None and got.m is axes and got.v is axes
    assert tuple(got) == tuple(want)
    m = MESHES["16x16"]
    _, meta, _ = trees["qwen1.5-4b"]
    specs = T.make_specs(got, m, None, adamw.AdamWState(
        torch.zeros((), device="meta"), meta, meta))
    assert specs.step == () and specs.m == specs.v


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard
    m = MESHES["2x16x16"]
    assert T.placements_for((("pod", "data"), None, "model"), m) == (
        Shard(0), Shard(0), Shard(2))
    assert T.placements_for((), m) == (Replicate(),) * 3
    sh = T.make_shardings({"w": ("embed", "mlp"), "n": None,
                           "l": [("vocab", "embed")]}, m)
    assert sh == {"w": (Replicate(), Shard(0), Shard(1)),
                  "n": (Replicate(),) * 3,
                  "l": [(Replicate(), Shard(1), Shard(0))]}


def test_constrain_is_the_identity_on_plain_tensors_and_outside_rules():
    x = torch.ones(4, 8)
    assert T.constrain(x, "batch", "embed") is x
    with T.use_rules(T.base_rules(MESHES["16x16"])):
        assert T.constrain(x, "batch", "embed") is x
        assert T.batch_shards() == 1 and T.batch_mean(x) is x


def test_rules_are_thread_local():
    rules = T.base_rules(MESHES["16x16"])
    seen = []
    with T.use_rules(rules):
        assert T.current_rules() is rules
        t = threading.Thread(target=lambda: seen.append(T.current_rules()))
        t.start()
        t.join()
    assert seen == [None] and T.current_rules() is None


def test_is_axes_leaf_equals_the_reference():
    for x in (None, (), ("embed", None), ("a", 1), [("a",)],
              adamw.AdamWState(None, None, None), {"a": None}):
        assert T.is_axes_leaf(x) == J.is_axes_leaf(x)


@pytest.mark.parametrize("mod", ["distributed.sharding", "distributed.elastic",
                                 "distributed.fault_tolerance",
                                 "distributed.pipeline_parallel",
                                 "optim.grad_compress", "launch.mesh"])
def test_public_names_match_the_reference(mod):
    """Every public name the reference's module defines is in the port's,
    but ``shard_map_compat`` (a shim over jax versions)."""
    import importlib
    import inspect
    ref = importlib.import_module(f"repro.{mod}")
    port = importlib.import_module(f"repro_torch.{mod}")
    own = {n for n, v in vars(ref).items() if not n.startswith("_")
           and (getattr(v, "__module__", None) == ref.__name__
                or not (inspect.ismodule(v) or callable(v)))}
    missing = own - set(vars(port)) - {"shard_map_compat"}
    assert not missing


def test_no_fallback_to_the_cpu_or_another_backend():
    from repro_torch.launch import mesh as tmesh
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device|none is "
                                               "available"):
            tmesh.init_distributed("cuda")
    with pytest.raises(ValueError, match="no process-group backend"):
        tmesh.init_distributed("meta")
    assert tmesh.BACKENDS == {"cuda": "nccl", "cpu": "gloo"}


def test_param_axes_raises_when_a_table_drifts_from_the_init(monkeypatch):
    """The init's meta tree is the source: a leaf missing from a table, or
    axes of another rank, raises."""
    import repro_torch.models.transformer as tt
    cfg = get_config("qwen1.5-4b").reduced()
    table = dict(tt._BLOCK_AXES["attn"])
    del table["wq"]
    monkeypatch.setitem(tt._BLOCK_AXES, "attn", table)
    with pytest.raises(KeyError, match="wq"):
        param_axes(cfg)
    table["wq"] = ("embed", "heads")
    with pytest.raises(ValueError, match="wq"):
        param_axes(cfg)
