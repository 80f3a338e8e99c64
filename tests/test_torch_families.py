"""The model families this port serves beside the dense and RWKV ones —
MoE (mixtral-8x22b, llama4-maverick-400b-a17b with its shared expert and
dense/MoE interleave), the attention/Mamba hybrid (jamba-1.5-large-398b,
period 8) and the vision frontend (internvl2-26b) — held to the JAX
reference on the CPU at reduced() size through ``forward``, ``prefill``
and ``decode_step``, with the same weights on both sides through
``repro_torch.bridge.model_params_from_reference``; and every registered
config served end to end on the port."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models as jm  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402

import repro_torch.models as tm  # noqa: E402
from repro_torch.bridge import model_params_from_reference  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs import list_archs  # noqa: E402
from repro_torch.launch.routes import RING_WINDOW, TOL, check_routes  # noqa: E402,E501
from repro_torch.launch.steps import (make_decode_step,  # noqa: E402
                                      make_prefill_step)

FULL = dict(rtol=2e-4, atol=2e-4)     # prefill / forward
DECODE = dict(rtol=2e-3, atol=2e-3)   # tests/models/test_model_parts.py:40
RING = dict(rtol=3e-3, atol=3e-3)     # tests/models/test_model_parts.py:61
FAMILIES = ["mixtral-8x22b", "llama4-maverick-400b-a17b",
            "jamba-1.5-large-398b", "internvl2-26b"]


def _weights(cfg_j, seed=0):
    """Reference init, then numpy noise on every leaf."""
    values, _ = jm.split(jm.init_model(cfg_j, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(0, 0.05, a.shape)
                   ).astype(np.float32), values)


def _batches(cfg, B, S, seed):
    """The same prompt batch for both packages: tokens, and for the vision
    frontend precomputed patch embeddings."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    bj, bt = {"tokens": jnp.asarray(toks)}, {"tokens": torch.tensor(toks)}
    if cfg.frontend == "vision":
        fe = rng.normal(0, 1, (B, cfg.n_frontend_tokens, cfg.d_frontend)
                        ).astype(np.float32)
        bj["frontend_embeds"] = jnp.asarray(fe)
        bt["frontend_embeds"] = torch.tensor(fe)
    return bj, bt


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    cfg_j = jget(request.param).reduced()
    cfg_t = tget(request.param).reduced()
    values = _weights(cfg_j)
    return cfg_j, cfg_t, values, model_params_from_reference(values, cfg_t,
                                                             "cpu")


def test_forward_prefill_decode_match_reference(family):
    """forward (logits and aux) and prefill at 2e-4, then 4 greedy decode
    steps at 2e-3, the port's default switch (plain versions on the CPU)
    against the reference's plain path."""
    cfg_j, cfg_t, values, params = family
    B, S = 2, 24
    bj, bt = _batches(cfg_t, B, S, seed=1)
    lj, aj = jm.forward(cfg_j, values, bj)
    lt, at = tm.forward(cfg_t, params, bt)
    _close(lt, lj, FULL)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-5, atol=1e-7)
    pj, cj = jm.prefill(cfg_j, values, bj, s_max=S + 8)
    pt, ct = tm.prefill(cfg_t, params, bt, s_max=S + 8)
    _close(pt, pj, FULL)
    tok = np.asarray(jnp.argmax(pj, -1))[:, None].astype(np.int32)
    for step in range(4):
        dj, cj = jm.decode_step(cfg_j, values, cj, jnp.asarray(tok),
                                jnp.asarray(S + step))
        dt, ct = tm.decode_step(cfg_t, params, ct, torch.tensor(tok),
                                S + step)
        _close(dt, dj, DECODE)
        tok = np.asarray(jnp.argmax(dj, -1))[:, None].astype(np.int32)


def test_caches_match_reference(family):
    """After a prefill, each layer's cache (KV, or a Mamba layer's conv and
    SSM states) equals the reference's stacked cache's slice."""
    cfg_j, cfg_t, values, params = family
    bj, bt = _batches(cfg_t, 2, 20, seed=2)
    _, cj = jm.prefill(cfg_j, values, bj, s_max=24)
    _, ct = tm.prefill(cfg_t, params, bt, s_max=24)
    assert len(ct) == cfg_t.n_layers
    for i, cache in enumerate(ct):
        ref = cj[i % cfg_t.period]
        assert type(cache).__name__ == type(ref).__name__
        for name in cache._fields:
            got, want = getattr(cache, name), getattr(ref, name)[
                i // cfg_t.period]
            assert got.dtype == getattr(torch, str(want.dtype)), (i, name)
            _close(got, want, FULL)


def test_sliding_window_ring_buffer_with_moe():
    """mixtral with window 16: a 24-token prompt into a 16-slot ring, then
    4 decode steps past the boundary, MoE in every layer, at 3e-3."""
    cfg_j = jget("mixtral-8x22b").reduced().scaled(window=16)
    cfg_t = tget("mixtral-8x22b").reduced().scaled(window=16)
    values = _weights(cfg_j)
    params = model_params_from_reference(values, cfg_t, "cpu")
    bj, bt = _batches(cfg_t, 1, 24, seed=3)
    pj, cj = jm.prefill(cfg_j, values, bj, s_max=16)
    pt, ct = tm.prefill(cfg_t, params, bt, s_max=16)
    assert ct[0].k.shape[2] == 16
    _close(pt, pj, RING)
    tok = np.asarray(jnp.argmax(pj, -1))[:, None].astype(np.int32)
    for step in range(4):
        dj, cj = jm.decode_step(cfg_j, values, cj, jnp.asarray(tok),
                                jnp.asarray(24 + step))
        dt, ct = tm.decode_step(cfg_t, params, ct, torch.tensor(tok),
                                24 + step)
        _close(dt, dj, RING)
        tok = np.asarray(jnp.argmax(dj, -1))[:, None].astype(np.int32)


def test_jamba_layers_follow_the_period_of_eight(family):
    """Layer l takes slice l // period of block l % period: jamba's 16
    reduced layers are two periods of 8 (attention at 4 and 12, MoE on the
    odd layers)."""
    cfg_j, cfg_t, values, params = family
    kinds = [tuple(k) for k in tm.transformer.layer_kinds(cfg_t)]
    assert len(params["layers"]) == cfg_t.n_layers
    for i, (layer, (blk, fk)) in enumerate(zip(params["layers"], kinds)):
        block = values["groups"][i % cfg_t.period]
        for part in ("mix", "ffn"):
            name = sorted(layer[part])[0]
            np.testing.assert_array_equal(
                layer[part][name].numpy(),
                block[part][name][i // cfg_t.period])
    if cfg_t.name.startswith("jamba"):
        assert cfg_t.period == 8 and cfg_t.n_layers == 16
        assert [b for b, _ in kinds].count("attn") == 2
        assert tm.transformer._first_attention(cfg_t) == 4
        assert [f for _, f in kinds[:4]] == ["dense", "moe"] * 2


def test_vision_frontend_replaces_the_first_positions():
    """internvl2: the first n_frontend_tokens positions are the projected
    patch embeddings, whatever tokens sit there; later positions are the
    tokens' embeddings."""
    cfg_t = tget("internvl2-26b").reduced()
    params = tm.init_model(cfg_t, torch.Generator().manual_seed(0), "cpu")
    n = cfg_t.n_frontend_tokens
    _, bt = _batches(cfg_t, 2, 12, seed=4)
    x = tm.transformer._embed_inputs(cfg_t, params, bt)
    torch.testing.assert_close(
        x[:, :n], bt["frontend_embeds"] @ params["frontend_proj"])
    torch.testing.assert_close(
        x[:, n:], params["embed"]["table"][bt["tokens"][:, n:].long()])
    other = dict(bt, tokens=bt["tokens"].clone())
    other["tokens"][:, :n] = 0
    a, _ = tm.forward(cfg_t, params, bt)
    b, _ = tm.forward(cfg_t, params, other)
    assert torch.equal(a, b)


@pytest.mark.parametrize("arch", list_archs())
def test_every_registered_config_serves(arch):
    """Every registered config at reduced() size on the port alone: init,
    the prefill and decode step functions, and prefill then decode agreeing
    with forward over prompt + generated tokens (at 2e-3; a capacity-bound
    MoE would not, but B S K stays under 4096 here, so it is dropless)."""
    cfg = tget(arch).reduced()
    params = tm.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    B, S = 2, 16
    _, batch = _batches(cfg, B, S, seed=5)
    logits, caches = make_prefill_step(cfg, s_max=S + 3)(params, batch)
    assert logits.shape == (B, cfg.vocab_size)
    decode = make_decode_step(cfg)
    seq = batch["tokens"]
    for step in range(3):
        tok = logits.argmax(-1, keepdim=True)
        seq = torch.cat([seq, tok], dim=1)
        logits, caches = decode(params, caches, tok, S + step)
        full, aux = tm.forward(cfg, params, dict(batch, tokens=seq))
        _close(logits, full[:, -1].numpy(), DECODE)
        assert bool(torch.isfinite(logits).all())
    assert (float(aux) > 0) == ("moe" in cfg.ffn_pattern)


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "internvl2-26b"])
def test_new_leaves_keep_their_types(arch):
    """Under param_dtype bfloat16: Mamba's A_log, D and dt_bias stay
    float32, every other new leaf (MoE, Mamba projections, frontend_proj)
    is bfloat16, in the bridged tree and in the port's own init alike."""
    cfg_j = jget(arch).reduced().scaled(param_dtype="bfloat16")
    cfg_t = tget(arch).reduced().scaled(param_dtype="bfloat16")
    values, _ = jm.split(jm.init_model(cfg_j, jax.random.PRNGKey(0)))
    values = jax.tree_util.tree_map(np.asarray, values)
    bridged = model_params_from_reference(values, cfg_t, "cpu")
    own = tm.init_model(cfg_t, torch.Generator().manual_seed(0), "cpu")
    flat = lambda t: jax.tree_util.tree_leaves_with_path(t)
    ref_types = {jax.tree_util.keystr(k[2:] if k[0].key == "groups" else k):
                 str(v.dtype) for k, v in flat(values)}
    for tree in (bridged, own):
        for path, leaf in flat(tree):
            if path[0].key == "layers":
                key = jax.tree_util.keystr(path[2:])
            else:
                key = jax.tree_util.keystr(path)
            assert str(leaf.dtype) == f"torch.{ref_types[key]}", key
    if arch == "internvl2-26b":
        assert own["frontend_proj"].shape == (cfg_t.d_frontend,
                                              cfg_t.d_model)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "jamba-1.5-large-398b",
                                  "rwkv6-7b"])
def test_route_check_on_the_cpu(arch):
    """``launch.routes.check_routes`` (the card's kernel-against-plain check
    of every family) on CPU tensors: both routes plain, no launch, the
    logits within tolerance; mixtral's window cut so that its ring wraps,
    under the ring tolerance."""
    rec = check_routes(arch, device="cpu")
    assert not any(rec["launches"].values())
    assert rec["prefill"]["max_err_over_tol"] <= 1
    assert rec["decode"]["max_err_over_tol"] <= 1
    ring = arch == "mixtral-8x22b"
    assert rec["decode"]["tol"] == TOL["ring" if ring else "decode"]
    assert (rec["window"] == RING_WINDOW) == ring
