"""The port's transformer (forward, prefill, decode_step and the serving
step functions) held to the JAX reference on the CPU at qwen1.5-4b's
reduced() size, with the same weights on both sides through
``repro_torch.bridge.model_params_from_reference``."""
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
from repro_torch.kernels.decode_attention import ops as tdops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as tfops  # noqa: E402
from repro_torch.launch.steps import (make_decode_step,  # noqa: E402
                                      make_prefill_step)
from repro_torch.models.transformer import NOT_PORTED  # noqa: E402

FULL = dict(rtol=2e-4, atol=2e-4)     # prefill / forward
DECODE = dict(rtol=2e-3, atol=2e-3)   # tests/models/test_model_parts.py:40
RING = dict(rtol=3e-3, atol=3e-3)     # tests/models/test_model_parts.py:61


def _weights(cfg_j, seed=0):
    """Reference init, then numpy noise on every leaf so that the QKV
    biases and the norm scales are not trivially 0 and 1."""
    values, _ = jm.split(jm.init_model(cfg_j, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(0, 0.1, a.shape)
                   ).astype(np.float32), values)


def _setup(window=0, **overrides):
    cfg_j = jget("qwen1.5-4b").reduced().scaled(window=window, **overrides)
    cfg_t = tget("qwen1.5-4b").reduced().scaled(window=window, **overrides)
    values = _weights(cfg_j)
    return cfg_j, cfg_t, values, model_params_from_reference(values, cfg_t,
                                                             "cpu")


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.fixture(scope="module")
def qwen():
    return _setup()


def test_bridge_slices_stacked_groups_per_layer(qwen):
    cfg_j, cfg_t, values, params = qwen
    assert len(params["layers"]) == cfg_t.n_layers == 2
    for i, layer in enumerate(params["layers"]):
        np.testing.assert_array_equal(
            layer["mix"]["wq"].numpy(), values["groups"][0]["mix"]["wq"][i])
    # the port's own init has the reference's tree, shapes and dtypes
    own = tm.init_model(cfg_t, torch.Generator().manual_seed(0), "cpu")
    shapes = lambda t: jax.tree_util.tree_map(lambda a: tuple(a.shape), t)
    assert shapes(own) == shapes(params)
    assert own["layers"][0]["mix"]["wq"].dtype == torch.float32


@pytest.mark.parametrize("use_pallas,use_kernel", [(False, False),
                                                   (True, None)])
def test_forward_prefill_decode_match_reference(qwen, use_pallas,
                                                use_kernel):
    """forward and prefill at 2e-4, then 4 greedy decode steps at 2e-3,
    against the reference with its Pallas kernels off and on (interpret
    mode). The port runs its plain path (use_kernel=False) or the default
    switch, which on CPU tensors runs the kernels' plain versions."""
    cfg_j, cfg_t, values, params = qwen
    B, S = 2, 48
    tokens = np.random.default_rng(1).integers(
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
        _close(cache.k, cj[0].k[layer], FULL)
        _close(cache.v, cj[0].v[layer], FULL)
    tok = np.asarray(jnp.argmax(pj, -1))[:, None].astype(np.int32)
    for step in range(4):
        dj, cj = jm.decode_step(cfg_j, values, cj, jnp.asarray(tok),
                                jnp.asarray(S + step), use_pallas=use_pallas)
        dt, ct = tm.decode_step(cfg_t, params, ct, torch.tensor(tok),
                                S + step, use_kernel=use_kernel)
        _close(dt, dj, DECODE)
        tok = np.asarray(jnp.argmax(dj, -1))[:, None].astype(np.int32)


def test_sliding_window_ring_buffer_matches_reference():
    """window 16, a 24-token prompt into a 16-slot ring, 4 decode steps past
    the ring boundary, against the reference (kernels on and off)."""
    cfg_j, cfg_t, values, params = _setup(window=16)
    B, S = 1, 24
    tokens = np.random.default_rng(2).integers(
        0, cfg_j.vocab_size, (B, S)).astype(np.int32)
    for use_pallas, use_kernel in ((False, False), (True, None)):
        pj, cj = jm.prefill(cfg_j, values, {"tokens": jnp.asarray(tokens)},
                            s_max=16, use_pallas=use_pallas)
        pt, ct = tm.prefill(cfg_t, params, {"tokens": torch.tensor(tokens)},
                            s_max=16, use_kernel=use_kernel)
        assert ct[0].k.shape[2] == cfg_t.window == 16
        _close(pt, pj, RING)
        tok = np.asarray(jnp.argmax(pj, -1))[:, None].astype(np.int32)
        for step in range(4):
            dj, cj = jm.decode_step(cfg_j, values, cj, jnp.asarray(tok),
                                    jnp.asarray(S + step),
                                    use_pallas=use_pallas)
            dt, ct = tm.decode_step(cfg_t, params, ct, torch.tensor(tok),
                                    S + step, use_kernel=use_kernel)
            _close(dt, dj, RING)
            tok = np.asarray(jnp.argmax(dj, -1))[:, None].astype(np.int32)


@pytest.mark.parametrize("window,s_max", [(0, 40), (12, 12)])
def test_prefill_then_decode_matches_teacher_forcing(window, s_max):
    """The port against itself: each greedy decode step's logits equal the
    forward pass's last-position logits over prompt + generated tokens."""
    _, cfg_t, _, params = _setup(window=window)
    B, S = 2, 30
    tokens = torch.tensor(np.random.default_rng(3).integers(
        0, cfg_t.vocab_size, (B, S)))
    prefill_step = make_prefill_step(cfg_t, s_max=s_max)
    decode = make_decode_step(cfg_t)
    logits, caches = prefill_step(params, {"tokens": tokens})
    assert torch.is_inference(logits)
    full, _ = tm.forward(cfg_t, params, {"tokens": tokens})
    _close(logits, full[:, -1], FULL)
    seq = tokens
    for step in range(4):
        tok = logits.argmax(-1, keepdim=True)
        seq = torch.cat([seq, tok], dim=1)
        logits, caches = decode(params, caches, tok, S + step)
        full, _ = tm.forward(cfg_t, params, {"tokens": seq})
        _close(logits, full[:, -1], DECODE)


def test_step_functions_equal_the_model_calls_and_never_launch_on_cpu(qwen):
    _, cfg_t, _, params = qwen
    tokens = torch.tensor(np.random.default_rng(4).integers(
        0, cfg_t.vocab_size, (2, 16)))
    tfops.reset_launches()
    tdops.reset_launches()
    a, ca = make_prefill_step(cfg_t, s_max=20)(params, {"tokens": tokens})
    b, cb = tm.prefill(cfg_t, params, {"tokens": tokens}, s_max=20)
    assert torch.equal(a, b)
    tok = a.argmax(-1, keepdim=True)
    a, _ = make_decode_step(cfg_t)(params, ca, tok, 16)
    b, _ = tm.decode_step(cfg_t, params, cb, tok, 16)
    assert torch.equal(a, b)
    assert tfops.LAUNCHES["flash_attention"] == 0
    assert tdops.LAUNCHES["decode_attention"] == 0
    with pytest.raises(ValueError, match="use_kernel=True"):
        make_prefill_step(cfg_t, s_max=20, use_kernel=True)(
            params, {"tokens": tokens})


def test_layers_follow_the_repeat_unit():
    """A period-2 unit of attention blocks: layer l is group l // 2 of block
    l % 2 in the reference's stacked tree."""
    cfg_j, cfg_t, values, params = _setup(block_pattern=("attn", "attn"),
                                          n_layers=4)
    assert cfg_t.period == 2 and len(params["layers"]) == 4
    np.testing.assert_array_equal(params["layers"][3]["mix"]["wk"].numpy(),
                                  values["groups"][1]["mix"]["wk"][1])
    tokens = np.random.default_rng(5).integers(
        0, cfg_j.vocab_size, (1, 12)).astype(np.int32)
    lj, _ = jm.forward(cfg_j, values, {"tokens": jnp.asarray(tokens)})
    lt, _ = tm.forward(cfg_t, params, {"tokens": torch.tensor(tokens)})
    _close(lt, lj, FULL)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "jamba-1.5-large-398b",
                                  "internvl2-26b"])
def test_unported_blocks_raise(arch):
    """These families (MoE, Mamba, the vision frontend) build now; a layer
    whose (block, FFN) pairing no registered config has still raises, and
    the message names what is left to port."""
    cfg = tget(arch).reduced()
    tm.init_model(cfg, torch.Generator(), "cpu")
    tm.init_caches(cfg, 1, 8, device="cpu")
    odd = cfg.scaled(ffn_pattern=("rwkv_cm",))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tm.init_model(odd, torch.Generator(), "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tm.init_caches(odd, 1, 8, device="cpu")
    assert "training" not in NOT_PORTED
