"""The port's RWKV6 model (time mix, channel mix, forward, prefill,
decode_step and the serving step functions) held to the JAX reference on
the CPU at rwkv6-7b's reduced() size, with the same weights on both sides
through ``repro_torch.bridge.model_params_from_reference``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models as jm  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402

import repro_torch.models as tm  # noqa: E402
from repro_torch.bridge import model_params_from_reference  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as tsops  # noqa: E402
from repro_torch.launch.steps import (make_decode_step,  # noqa: E402
                                      make_prefill_step)
from repro_torch.models import rwkv as trwkv  # noqa: E402

FULL = dict(rtol=2e-4, atol=2e-4)     # prefill / forward
DECODE = dict(rtol=2e-3, atol=2e-3)   # tests/models/test_model_parts.py:40


def _weights(cfg_j, seed=0):
    """Reference init, then numpy noise on every leaf; the bonus u drawn
    from N(0, 0.5) and w_base spread over [-6, -1] across channels (RWKV-6's
    own decay range), so the bonus term and a range of decays are
    exercised (the reference's init has u = 0 and w_base = -6)."""
    values, _ = jm.split(jm.init_model(cfg_j, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    values = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(0, 0.1, a.shape)
                   ).astype(np.float32), values)
    mix = values["groups"][0]["mix"]
    mix["u"] = rng.normal(0, 0.5, mix["u"].shape).astype(np.float32)
    mix["w_base"] = np.broadcast_to(
        np.linspace(-6.0, -1.0, cfg_j.d_model, dtype=np.float32),
        mix["w_base"].shape).copy()
    return values


@pytest.fixture(scope="module")
def rwkv():
    cfg_j = jget("rwkv6-7b").reduced()
    cfg_t = tget("rwkv6-7b").reduced()
    values = _weights(cfg_j)
    return cfg_j, cfg_t, values, model_params_from_reference(values, cfg_t,
                                                             "cpu")


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _cache_pair(cfg, B, seed):
    """The same nonzero RWKV cache for both packages."""
    rng = np.random.default_rng(seed)
    H, hs, D = cfg.n_rwkv_heads, cfg.rwkv_head_size, cfg.d_model
    arrays = (rng.normal(0, 1, (B, D)), rng.normal(0, 1, (B, D)),
              rng.normal(0, 0.5, (B, H, hs, hs)))
    arrays = [a.astype(np.float32) for a in arrays]
    return (jrwkv.RWKVCache(*(jnp.asarray(a) for a in arrays)),
            trwkv.RWKVCache(*(torch.tensor(a) for a in arrays)))


def test_bridge_carries_rwkv_layers_and_keeps_constants_float32(rwkv):
    cfg_j, cfg_t, values, params = rwkv
    assert len(params["layers"]) == cfg_t.n_layers == 2
    for i, layer in enumerate(params["layers"]):
        np.testing.assert_array_equal(layer["mix"]["u"].numpy(),
                                      values["groups"][0]["mix"]["u"][i])
        np.testing.assert_array_equal(layer["ffn"]["wk"].numpy(),
                                      values["groups"][0]["ffn"]["wk"][i])
    own = tm.init_model(cfg_t, torch.Generator().manual_seed(0), "cpu")
    shapes = lambda t: jax.tree_util.tree_map(lambda a: tuple(a.shape), t)
    assert shapes(own) == shapes(params)
    half = cfg_t.scaled(param_dtype="bfloat16")
    p16 = model_params_from_reference(values, half, "cpu")
    own16 = tm.init_model(half, torch.Generator().manual_seed(0), "cpu")
    for tree in (p16, own16):
        mix = tree["layers"][0]["mix"]
        assert mix["wr"].dtype == torch.bfloat16
        for name in ("mix", "w_base", "u", "ln_x"):
            assert mix[name].dtype == torch.float32, name
        assert tree["layers"][0]["ffn"]["mix"].dtype == torch.float32


@pytest.mark.parametrize("use_kernel", [False, None])
def test_time_and_channel_mix_with_a_nonzero_cache(rwkv, use_kernel):
    cfg_j, cfg_t, values, params = rwkv
    B, S = 2, 21
    x = np.random.default_rng(1).normal(0, 1, (B, S, cfg_j.d_model)
                                        ).astype(np.float32)
    cj, ct = _cache_pair(cfg_j, B, seed=2)
    pj = jax.tree_util.tree_map(lambda a: jnp.asarray(a[1]),
                                values["groups"][0])
    pt = params["layers"][1]
    yj, nj = jrwkv.rwkv_time_mix(pj["mix"], cfg_j, jnp.asarray(x), cj)
    yt, nt = trwkv.rwkv_time_mix(pt["mix"], cfg_t, torch.tensor(x), ct,
                                 use_kernel=use_kernel)
    _close(yt, yj, FULL)
    for got, want in zip(nt, nj):
        _close(got, want, FULL)
    zj, mj = jrwkv.rwkv_channel_mix(pj["ffn"], cfg_j, jnp.asarray(x), nj)
    zt, mt = trwkv.rwkv_channel_mix(pt["ffn"], cfg_t, torch.tensor(x), nt)
    _close(zt, zj, FULL)
    for got, want in zip(mt, mj):
        _close(got, want, FULL)
    # no cache (teacher forcing): zero state, no cache out of the channel mix
    yj, _ = jrwkv.rwkv_time_mix(pj["mix"], cfg_j, jnp.asarray(x), None)
    yt, _ = trwkv.rwkv_time_mix(pt["mix"], cfg_t, torch.tensor(x), None)
    _close(yt, yj, FULL)
    assert trwkv.rwkv_channel_mix(pt["ffn"], cfg_t, torch.tensor(x),
                                  None)[1] is None


@pytest.mark.parametrize("use_pallas,use_kernel", [(False, False),
                                                   (True, None)])
def test_forward_prefill_decode_match_reference(rwkv, use_pallas,
                                                use_kernel):
    """forward and prefill at 2e-4, the caches too, then two greedy decode
    steps at 2e-3, against the reference (which runs _wkv_chunked in jnp
    whatever use_pallas says)."""
    cfg_j, cfg_t, values, params = rwkv
    B, S = 2, 48
    tokens = np.random.default_rng(3).integers(
        0, cfg_j.vocab_size, (B, S)).astype(np.int32)
    lj, _ = jm.forward(cfg_j, values, {"tokens": jnp.asarray(tokens)},
                       use_pallas=use_pallas)
    lt, aux = tm.forward(cfg_t, params, {"tokens": torch.tensor(tokens)},
                         use_kernel=use_kernel)
    _close(lt, lj, FULL)
    assert float(aux) == 0.0
    pj, cj = jm.prefill(cfg_j, values, {"tokens": jnp.asarray(tokens)},
                        s_max=S + 8, use_pallas=use_pallas)
    pt, ct = tm.prefill(cfg_t, params, {"tokens": torch.tensor(tokens)},
                        s_max=S + 8, use_kernel=use_kernel)
    _close(pt, pj, FULL)
    for layer, cache in enumerate(ct):
        for got, want in zip(cache, cj[0]):
            _close(got, want[layer], FULL)
    tok = np.asarray(jnp.argmax(pj, -1))[:, None].astype(np.int32)
    for step in range(2):
        dj, cj = jm.decode_step(cfg_j, values, cj, jnp.asarray(tok),
                                jnp.asarray(S + step), use_pallas=use_pallas)
        dt, ct = tm.decode_step(cfg_t, params, ct, torch.tensor(tok),
                                S + step, use_kernel=use_kernel)
        _close(dt, dj, DECODE)
        tok = np.asarray(jnp.argmax(dj, -1))[:, None].astype(np.int32)


def test_prefill_then_decode_matches_teacher_forcing(rwkv):
    """The port against itself: each greedy decode step's logits equal the
    forward pass's last-position logits over prompt + generated tokens; a
    70-token sequence runs forward with a ragged last chunk of 6."""
    _, cfg_t, _, params = rwkv
    B, S = 2, 64
    tokens = torch.tensor(np.random.default_rng(4).integers(
        0, cfg_t.vocab_size, (B, S)))
    prefill_step = make_prefill_step(cfg_t, s_max=S + 8)
    decode = make_decode_step(cfg_t)
    logits, caches = prefill_step(params, {"tokens": tokens})
    assert torch.is_inference(logits)
    seq = tokens
    for step in range(6):
        tok = logits.argmax(-1, keepdim=True)
        seq = torch.cat([seq, tok], dim=1)
        logits, caches = decode(params, caches, tok, S + step)
    full, _ = tm.forward(cfg_t, params, {"tokens": seq})
    _close(logits, full[:, -1], DECODE)


def test_init_caches_match_reference_shapes_and_types(rwkv):
    cfg_j, cfg_t, _, _ = rwkv
    cj = jm.init_caches(cfg_j, 3, 16)
    ct = tm.init_caches(cfg_t, 3, 16, device="cpu")
    assert len(ct) == cfg_t.n_layers
    for cache in ct:
        assert isinstance(cache, tm.RWKVCache)
        for got, want in zip(cache, cj[0]):
            assert tuple(got.shape) == tuple(want.shape[1:])
            assert str(got.dtype).split(".")[-1] == str(want.dtype)
            assert not got.any()


def test_step_functions_equal_the_model_calls_and_never_launch_on_cpu(rwkv):
    _, cfg_t, _, params = rwkv
    tokens = torch.tensor(np.random.default_rng(5).integers(
        0, cfg_t.vocab_size, (2, 16)))
    tsops.reset_launches()
    a, ca = make_prefill_step(cfg_t, s_max=20)(params, {"tokens": tokens})
    b, cb = tm.prefill(cfg_t, params, {"tokens": tokens}, s_max=20)
    assert torch.equal(a, b)
    tok = a.argmax(-1, keepdim=True)
    a, _ = make_decode_step(cfg_t)(params, ca, tok, 16)
    b, _ = tm.decode_step(cfg_t, params, cb, tok, 16)
    assert torch.equal(a, b)
    assert tsops.LAUNCHES["rwkv6_scan"] == 0
    with pytest.raises(ValueError, match="use_kernel=True"):
        make_decode_step(cfg_t, use_kernel=True)(params, ca, tok, 16)


@pytest.mark.parametrize("entry", ["forward", "prefill", "decode"])
def test_on_layer_sees_every_block_and_reruns_it(rwkv, entry):
    """The per-layer hook of the layer loop: called once per layer in
    order, with the block's output and cache; its rerun gives the same
    block on the same input again and changes nothing downstream."""
    _, cfg_t, _, params = rwkv
    tokens = torch.tensor(np.random.default_rng(6).integers(
        0, cfg_t.vocab_size, (2, 12)))
    _, caches = tm.prefill(cfg_t, params, {"tokens": tokens}, s_max=16)
    seen = []

    def on_layer(i, y, cache, rerun):
        y2, cache2 = rerun(False)
        assert torch.equal(y, y2)
        for got, want in zip(cache, cache2):
            assert torch.equal(got, want)
        seen.append(i)

    def run(hook):
        if entry == "forward":
            return tm.forward(cfg_t, params, {"tokens": tokens},
                              on_layer=hook)[0]
        if entry == "prefill":
            return tm.prefill(cfg_t, params, {"tokens": tokens}, s_max=16,
                              on_layer=hook)[0]
        return tm.decode_step(cfg_t, params, list(caches), tokens[:, :1], 12,
                              on_layer=hook)[0]

    assert torch.equal(run(on_layer), run(None))
    assert seen == list(range(cfg_t.n_layers))
