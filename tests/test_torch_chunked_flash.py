"""The training path's attention and embedding against the JAX reference
on the CPU: ``_chunked_flash`` (values and q/k/v gradients, causal and
windowed, GQA, small Q and KV chunks, bf16 probabilities), the plain
route's switch at S = 1024, and ``embed_lookup``'s gradient against the
reference's custom VJP ``_embed_bwd`` (float32 and bfloat16 tables)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models.attention as jattn  # noqa: E402
import repro.models.layers as jlayers  # noqa: E402

import repro_torch.models.attention as tattn  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.layers import embed_lookup  # noqa: E402

TOL = 2e-4      # tests/kernels/test_kernels.py:10-11, float32 attention


def _qkv(seed, B, S, H, G, dh):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(0, 1, (B, S, n, dh)).astype(np.float32)
               for n in (H, G, G))
    return q, k, v, rng.normal(0, 1, (B, S, H, dh)).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("B,S,H,G,dh,window,qc,kc,bf16", [
    (2, 64, 4, 4, 16, 0, 16, 32, False),
    (2, 64, 8, 2, 16, 0, 32, 16, False),    # GQA, KV chunks finer than Q
    (1, 96, 4, 2, 32, 20, 32, 32, False),   # a window across chunks
    (2, 64, 4, 1, 16, 8, 16, 16, False),    # MQA, rows whose first chunks
                                            # are all masked
    (1, 64, 4, 2, 16, 0, 16, 32, True),     # bf16 probabilities
])
def test_chunked_flash_matches_reference(B, S, H, G, dh, window, qc, kc,
                                         bf16):
    """Output and the q, k, v gradients of a random cotangent."""
    q, k, v, dy = _qkv(S + H + window, B, S, H, G, dh)
    fn = lambda q, k, v: jattn._chunked_flash(
        q, k, v, window, q_chunk=qc, kv_chunk=kc, probs_bf16=bf16)
    out_j, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads_j = vjp(jnp.asarray(dy))
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out_t = tattn._chunked_flash(qt, kt, vt, window, q_chunk=qc,
                                 kv_chunk=kc, probs_bf16=bf16)
    grads_t = torch.autograd.grad(out_t, (qt, kt, vt), torch.tensor(dy))
    _close(out_t, out_j)
    for g, w in zip(grads_t, grads_j):
        _close(g, w)


def test_chunked_flash_equals_sdpa_and_unroll_changes_nothing():
    """The chunked form is the same attention as _sdpa over a mask, values
    and gradients; unroll (no checkpoint) gives the same numbers bit for
    bit."""
    q, k, v, dy = _qkv(3, 2, 128, 8, 4, 16)
    mask = tattn.causal_mask(128, 128, 0, 40)

    def run(fn):
        qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
        out = fn(qt, kt, vt)
        return (out,) + torch.autograd.grad(out, (qt, kt, vt),
                                            torch.tensor(dy))

    sdpa = run(lambda q, k, v: tattn._sdpa(q, k, v, mask))
    ckpt = run(lambda q, k, v: tattn._chunked_flash(q, k, v, 40, 32, 64))
    flat = run(lambda q, k, v: tattn._chunked_flash(q, k, v, 40, 32, 64,
                                                    unroll=True))
    for a, b, c in zip(sdpa, ckpt, flat):
        _close(b, a.detach().numpy())
        assert torch.equal(b, c)


def test_plain_route_takes_chunked_flash_past_1024():
    """use_kernel=False: _sdpa at S <= 1024, _chunked_flash above, as the
    reference's _attend_full; S not a multiple of the chunk raises, as the
    reference asserts."""
    cfg = get_config("qwen1.5-4b").reduced()
    calls = []
    real = tattn._chunked_flash
    tattn._chunked_flash = lambda *a, **kw: calls.append(a[0].shape[1]) \
        or real(*a, **kw)
    try:
        for S in (1024, 2048):
            q = torch.zeros((1, S, 4, 16))
            k = torch.zeros((1, S, 2, 16))
            tattn._attend_full(q, k, k, cfg, use_kernel=False)
        with pytest.raises(ValueError, match="multiple"):
            q = torch.zeros((1, 1056, 4, 16))
            tattn._attend_full(q, q[:, :, :2], q[:, :, :2], cfg, False)
    finally:
        tattn._chunked_flash = real
    assert calls == [2048, 1056]


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-6),
                                       (jnp.bfloat16, 0.0)])
def test_embed_gradient_matches_embed_bwd(dtype, tol):
    """dTable: table rows summed in float32, cast to the table's type; a
    repeated token's rows add up. bfloat16 cast after the float32 sum
    equals the reference's exactly."""
    rng = np.random.default_rng(1)
    V, D, B, S = 50, 24, 3, 64
    table = rng.normal(0, 1, (V, D)).astype(np.float32)
    toks = rng.integers(0, 12, (B, S)).astype(np.int32)   # many repeats
    g = rng.normal(0, 1, (B, S, D)).astype(np.float32)
    tj = jnp.asarray(table).astype(dtype)
    out_j, vjp = jax.vjp(lambda t: jlayers.embed_lookup(t, jnp.asarray(toks)),
                         tj)
    (dt_j,) = vjp(jnp.asarray(g).astype(dtype))
    tdt = torch.bfloat16 if dtype is jnp.bfloat16 else torch.float32
    tt = torch.tensor(table).to(tdt).requires_grad_(True)
    out_t = embed_lookup(tt, torch.tensor(toks))
    (dt_t,) = torch.autograd.grad(out_t, tt, torch.tensor(g).to(tdt))
    assert dt_t.dtype == tdt
    np.testing.assert_array_equal(out_t.detach().float().numpy(),
                                  np.asarray(out_j, np.float32))
    np.testing.assert_allclose(dt_t.float().numpy(),
                               np.asarray(dt_j, np.float32), rtol=tol,
                               atol=tol)
