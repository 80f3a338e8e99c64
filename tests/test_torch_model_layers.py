"""The port's shared model layers (rmsnorm, rotary embeddings, embedding,
FFN variants) and initialisers, held to the JAX reference on the CPU."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models.layers as jl  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402

import repro_torch.models.layers as tl  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models.param import dense_init  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)    # tests/kernels/test_kernels.py:10
BF16 = dict(rtol=2e-2, atol=2e-2)   # tests/kernels/test_kernels.py:11


def _close(got, want, **tol):
    got = got.float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               **(tol or TOL))


def _normal(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)
            ).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_reference(dtype):
    x = _normal(0, (2, 5, 64), 3.0)
    scale = _normal(1, (64,)) + 1.0
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jl.rmsnorm({"scale": jnp.asarray(scale, jdt)},
                      jnp.asarray(x, jdt), 1e-5)
    got = tl.rmsnorm({"scale": torch.tensor(scale).to(tdt)},
                     torch.tensor(x).to(tdt), 1e-5)
    assert got.dtype == tdt
    _close(got, want.astype(jnp.float32), **(TOL if dtype == "float32"
                                             else BF16))


@pytest.mark.parametrize("d_head,theta", [(16, 10_000.0), (128, 10_000.0),
                                          (64, 500_000.0)])
def test_rope_matches_reference(d_head, theta):
    pos = np.arange(37, dtype=np.int32) * 29    # positions past 1000
    cj, sj = jl.rope_tables(jnp.asarray(pos), d_head, theta)
    ct, st = tl.rope_tables(torch.tensor(pos), d_head, theta)
    _close(ct, cj, rtol=1e-5, atol=1e-5)
    _close(st, sj, rtol=1e-5, atol=1e-5)
    x = _normal(2, (2, 37, 3, d_head))
    _close(tl.apply_rope(torch.tensor(x), ct, st),
           jl.apply_rope(jnp.asarray(x), cj, sj))
    # (B, S, D/2) tables broadcast over heads the same way
    cb, sb = cj[None].repeat(2, 0), sj[None].repeat(2, 0)
    _close(tl.apply_rope(torch.tensor(x), torch.tensor(np.asarray(cb)),
                         torch.tensor(np.asarray(sb))),
           jl.apply_rope(jnp.asarray(x), cb, sb))


def test_rope_is_half_split_not_interleaved():
    x = torch.zeros(1, 1, 1, 8)
    x[..., 0] = 1.0                   # pairs (0, 4), not (0, 1)
    c, s = tl.rope_tables(torch.tensor([3]), 8, 10_000.0)
    out = tl.apply_rope(x, c, s)[0, 0, 0]
    assert out[0] == pytest.approx(math.cos(3.0), abs=1e-6)
    assert out[4] == pytest.approx(math.sin(3.0), abs=1e-6)
    assert out[1] == 0.0


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu", "sqrelu"])
def test_ffn_matches_reference(activation):
    cfg_j = jget("qwen1.5-4b").reduced().scaled(activation=activation)
    cfg_t = tget("qwen1.5-4b").reduced().scaled(activation=activation)
    gated = activation in ("swiglu", "geglu")
    D, F = cfg_j.d_model, cfg_j.d_ff
    p = {"w_up": _normal(3, (D, F), D ** -0.5),
         "w_down": _normal(4, (F, D), F ** -0.5)}
    if gated:
        p["w_gate"] = _normal(5, (D, F), D ** -0.5)
    x = _normal(6, (2, 7, D), 2.0)
    want = jl.ffn({k: jnp.asarray(v) for k, v in p.items()}, cfg_j,
                  jnp.asarray(x))
    got = tl.ffn({k: torch.tensor(v) for k, v in p.items()}, cfg_t,
                 torch.tensor(x))
    _close(got, want)


def test_gelu_is_the_tanh_form_of_the_reference():
    """jax.nn.gelu defaults to approximate=True; the port pins the tanh
    form (granite and musicgen use gelu)."""
    x = np.linspace(-6, 6, 2001, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = tl._act("gelu", torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    exact = torch.nn.functional.gelu(torch.tensor(x)).numpy()
    assert np.abs(exact - want).max() > 1e-4     # the pin is not vacuous
    assert jget("granite-34b").activation == "gelu"


def test_embed_unembed_match_reference():
    table = _normal(7, (50, 16))
    tok = np.random.default_rng(8).integers(0, 50, (3, 9)).astype(np.int32)
    _close(tl.embed({"table": torch.tensor(table)}, torch.tensor(tok)),
           jl.embed({"table": jnp.asarray(table)}, jnp.asarray(tok)), rtol=0,
           atol=0)
    x = _normal(9, (3, 9, 16))
    _close(tl.unembed({"table": torch.tensor(table)}, torch.tensor(x)),
           jl.unembed({"table": jnp.asarray(table)}, jnp.asarray(x)))


@pytest.mark.parametrize("shape,scale", [((256, 64), None), ((300,), 1.0),
                                         ((64, 4, 16), None)])
def test_dense_init_is_a_truncated_normal(shape, scale):
    gen = torch.Generator().manual_seed(0)
    w = dense_init(gen, shape, torch.float32, torch.device("cpu"), scale)
    s = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    assert w.shape == shape and w.dtype == torch.float32
    assert float(w.abs().max()) <= 2.0 * s + 1e-6
    # the std of N(0, 1) truncated to [-2, 2] is 0.8796
    assert float(w.std()) == pytest.approx(0.8796 * s, rel=0.1)
    assert abs(float(w.mean())) < 0.1 * s
    again = dense_init(torch.Generator().manual_seed(0), shape, torch.float32,
                       torch.device("cpu"), scale)
    assert torch.equal(w, again)
    ref = np.asarray(jl.init_embedding(jax.random.PRNGKey(0), 400, 64,
                                       jnp.float32)["table"].value)
    assert float(np.std(ref)) == pytest.approx(0.8796, rel=0.05)


def test_ffn_init_shapes_match_reference():
    for act in ("swiglu", "sqrelu"):
        cfg_j = jget("qwen1.5-4b").reduced().scaled(activation=act)
        cfg_t = tget("qwen1.5-4b").reduced().scaled(activation=act)
        want = jl.init_ffn(jax.random.PRNGKey(0), cfg_j, 96, jnp.float32)
        got = tl.init_ffn(torch.Generator().manual_seed(0), cfg_t, 96,
                          torch.float32, torch.device("cpu"))
        assert {k: tuple(v.shape) for k, v in got.items()} == {
            k: tuple(v.value.shape) for k, v in want.items()}
