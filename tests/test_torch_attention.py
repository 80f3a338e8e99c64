"""The plain versions of the two attention kernels and the port's attention
layer, held to the JAX reference on the CPU: to the reference's oracles
(``ref.py``), to its Pallas kernels in interpret mode, and to its
``models.attention`` functions (full, prefill with its ring-buffer branch,
decode with its ring slot and validity)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import repro.models.attention as ja  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.kernels.decode_attention import ops as jdops  # noqa: E402
from repro.kernels.decode_attention import ref as jdref  # noqa: E402
from repro.kernels.flash_attention import ops as jfops  # noqa: E402
from repro.kernels.flash_attention import ref as jfref  # noqa: E402

import repro_torch.models.attention as ta  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.kernels.decode_attention import ops as tdops  # noqa: E402
from repro_torch.kernels.decode_attention import ref as tdref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as tfops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as tfref  # noqa: E402

# tests/kernels/test_kernels.py:10-11
TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _normal(rng, shape):
    return rng.normal(0, 1, shape).astype(np.float32)


def _pair(a, dtype):
    """The same values for both packages, rounded to ``dtype``."""
    j = jnp.asarray(a, getattr(jnp, dtype))
    return j, torch.tensor(np.asarray(j.astype(jnp.float32))).to(
        getattr(torch, dtype))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


# ---------------------------------------------------------------------------
# the two plain versions against the reference's oracles and Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,H,G,dh,win,bq", [
    (2, 128, 4, 2, 32, 0, 32),
    (1, 64, 8, 8, 16, 0, 64),
    (2, 128, 4, 1, 32, 48, 32),       # MQA + sliding window
    (1, 64, 2, 2, 128, 0, 32),
    (1, 96, 6, 3, 64, 16, 32),        # GQA R = 2, window < block
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_reference(B, S, H, G, dh, win, bq, dtype):
    rng = np.random.default_rng(B * S + H + win)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(_normal(rng, shape), dtype)
        for shape in ((B, S, H, dh), (B, S, G, dh), (B, S, G, dh)))
    f32 = lambda a: a.astype(jnp.float32)
    oracle = jfref.flash_attention_ref(f32(qj), f32(kj), f32(vj), window=win)
    got = tfref.flash_attention_ref(qt.float(), kt.float(), vt.float(),
                                    window=win)
    _close(got, oracle, TOL["float32"])
    # the port's wrapper on CPU tensors of the working type, against the
    # Pallas kernel (interpret mode) at the reference's tolerance
    pallas = jfops.flash_attention(qj, kj, vj, window=win, block_q=bq,
                                   block_k=bq)
    out = tfops.flash_attention(qt, kt, vt, window=win)
    assert out.dtype == qt.dtype and out.shape == (B, S, H, dh)
    _close(out, f32(pallas), TOL[dtype])


@pytest.mark.parametrize("B,H,G,S,dh,valid", [
    (2, 4, 2, 256, 32, "prefix:256"),
    (1, 8, 1, 128, 64, "prefix:100"),
    (2, 2, 2, 512, 16, "prefix:307"),
    (1, 4, 4, 64, 128, "prefix:1"),
    (2, 4, 2, 64, 32, "ring:10"),      # a ring buffer: slots <= 10 and the
                                       # window's tail past the wrap
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_reference(B, H, G, S, dh, valid, dtype):
    rng = np.random.default_rng(S + dh)
    kind, n = valid.split(":")
    kpos = np.arange(S)
    ok = kpos < int(n) if kind == "prefix" else (kpos <= int(n)) | (kpos > 40)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(_normal(rng, shape), dtype)
        for shape in ((B, 1, H, dh), (B, G, S, dh), (B, G, S, dh)))
    f32 = lambda a: a.astype(jnp.float32)
    oracle = jdref.decode_attention_ref(f32(qj), f32(kj), f32(vj),
                                        jnp.asarray(ok))
    got = tdref.decode_attention_ref(qt.float(), kt.float(), vt.float(),
                                     torch.tensor(ok))
    _close(got, oracle, TOL["float32"])
    pallas = jdops.decode_attention(qj, kj, vj, jnp.asarray(ok),
                                    block_k=min(64, S))
    out = tdops.decode_attention(qt, kt, vt, torch.tensor(ok.astype(np.int32)))
    assert out.dtype == qt.dtype and out.shape == (B, 1, H, dh)
    _close(out, f32(pallas), TOL[dtype])


def test_wrappers_switch_on_the_device_and_launch_nothing_on_cpu():
    rng = np.random.default_rng(0)
    q, k, v = (torch.tensor(_normal(rng, (1, 16, 2, 16))) for _ in range(3))
    tfops.reset_launches()
    tdops.reset_launches()
    want = tfref.flash_attention_ref(q, k, v, 4)
    assert torch.equal(tfops.flash_attention(q, k, v, 4), want)
    assert torch.equal(tfops.flash_attention(q, k, v, 4, use_kernel=False),
                       want)
    with pytest.raises(ValueError, match="use_kernel=True"):
        tfops.flash_attention(q, k, v, 4, use_kernel=True)
    kc, vc = (t.transpose(1, 2).contiguous() for t in (k, v))
    valid = torch.arange(16) < 9
    with pytest.raises(ValueError, match="use_kernel=True"):
        tdops.decode_attention(q[:, :1].contiguous(), kc, vc, valid,
                               use_kernel=True)
    assert torch.equal(tdops.decode_attention(q[:, :1], kc, vc, valid),
                       tdref.decode_attention_ref(q[:, :1], kc, vc, valid))
    assert tfops.LAUNCHES == {"flash_attention": 0}
    assert tdops.LAUNCHES == {"decode_attention": 0}


# ---------------------------------------------------------------------------
# the attention layer against repro.models.attention
# ---------------------------------------------------------------------------

def _configs(window=0):
    return (jget("qwen1.5-4b").reduced().scaled(window=window),
            tget("qwen1.5-4b").reduced().scaled(window=window))


def _attn_params(cfg, seed):
    rng = np.random.default_rng(seed)
    D, H, G, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    return {"wq": 0.2 * _normal(rng, (D, H, dh)),
            "wk": 0.2 * _normal(rng, (D, G, dh)),
            "wv": 0.2 * _normal(rng, (D, G, dh)),
            "wo": 0.2 * _normal(rng, (H, dh, D)),
            "bq": _normal(rng, (H, dh)), "bk": _normal(rng, (G, dh)),
            "bv": _normal(rng, (G, dh))}


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.tensor(v) for k, v in p.items()})


@pytest.mark.parametrize("window", [0, 5])
def test_sdpa_and_causal_mask_match_reference(window):
    rng = np.random.default_rng(window)
    q, k, v = (_normal(rng, s) for s in ((2, 12, 4, 8), (2, 12, 2, 8),
                                          (2, 12, 2, 8)))
    mj = ja.causal_mask(12, 12, 0, window)
    mt = ta.causal_mask(12, 12, 0, window)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    _close(ta._sdpa(*map(torch.tensor, (q, k, v)), mt),
           ja._sdpa(*map(jnp.asarray, (q, k, v)), mj), TOL["float32"])


@pytest.mark.parametrize("use_kernel", [None, False])
@pytest.mark.parametrize("window", [0, 6])
def test_attention_matches_reference(use_kernel, window):
    cj, ct = _configs(window)
    pj, pt = _both(_attn_params(cj, 1))
    x = _normal(np.random.default_rng(2), (2, 20, cj.d_model))
    pos = np.arange(20, dtype=np.int32)
    want = ja.attention(pj, cj, jnp.asarray(x), jnp.asarray(pos))
    got = ta.attention(pt, ct, torch.tensor(x), torch.tensor(pos),
                       use_kernel=use_kernel)
    _close(got, want, TOL["float32"])
    with pytest.raises(ValueError, match="use_kernel=True"):
        ta.attention(pt, ct, torch.tensor(x), torch.tensor(pos),
                     use_kernel=True)


@pytest.mark.parametrize("window,S,s_max", [(0, 20, 28), (8, 20, 8),
                                            (8, 20, 28)])
def test_prefill_then_decode_attention_match_reference(window, S, s_max):
    """Prefill writes the cache (a ring buffer when s_max < S), then decode
    steps write their slot and attend under the reference's validity."""
    cj, ct = _configs(window)
    pj, pt = _both(_attn_params(cj, 3))
    rng = np.random.default_rng(4)
    x = _normal(rng, (2, S, cj.d_model))
    pos = np.arange(S, dtype=np.int32)
    cache_j = ja.KVCache.zeros(2, cj.n_kv_heads, s_max, cj.d_head,
                               jnp.float32)
    cache_t = ta.KVCache.zeros(2, ct.n_kv_heads, s_max, ct.d_head,
                               torch.float32, torch.device("cpu"))
    yj, cache_j = ja.prefill_attention(pj, cj, jnp.asarray(x),
                                       jnp.asarray(pos), cache_j)
    yt, same = ta.prefill_attention(pt, ct, torch.tensor(x),
                                    torch.tensor(pos), cache_t)
    assert same is cache_t                       # written in place
    _close(yt, yj, TOL["float32"])
    _close(cache_t.k, cache_j.k, TOL["float32"])
    _close(cache_t.v, cache_j.v, TOL["float32"])
    for step in range(3):
        xs = _normal(rng, (2, 1, cj.d_model))
        yj, cache_j = ja.decode_attention_step(
            pj, cj, jnp.asarray(xs), jnp.asarray(S + step, jnp.int32),
            cache_j)
        for use_kernel in (None, False):
            snap = ta.KVCache(cache_t.k.clone(), cache_t.v.clone())
            yt, _ = ta.decode_attention_step(pt, ct, torch.tensor(xs),
                                             S + step, snap,
                                             use_kernel=use_kernel)
            _close(yt, yj, dict(rtol=2e-3, atol=2e-3))
            _close(snap.k, cache_j.k, TOL["float32"])
        ta.decode_attention_step(pt, ct, torch.tensor(xs), S + step, cache_t)


@pytest.mark.parametrize("window,s_max", [(0, 32), (6, 32), (8, 8)])
def test_decode_valid_matches_reference_rule(window, s_max):
    """The validity vector of the reference's decode_attention_step, for
    positions before, at and past a ring buffer's wrap."""
    cfg = tget("qwen1.5-4b").reduced().scaled(window=window)
    kpos = np.arange(s_max)
    ring = window > 0 and s_max <= window
    for pos in range(0, 20 if ring else s_max):
        if ring:
            want = (np.ones(s_max, bool) if pos >= s_max - 1
                    else kpos <= pos % s_max)
        else:
            want = kpos <= pos
            if window > 0:
                want &= kpos > pos - window
        np.testing.assert_array_equal(
            ta.decode_valid(cfg, pos, s_max, "cpu").numpy(), want)
