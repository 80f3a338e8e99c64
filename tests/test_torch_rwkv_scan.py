"""The port's RWKV6 WKV scan on the CPU held to the JAX reference: the plain
chunked form against the reference model's ``_wkv_chunked`` and against the
Pallas kernel in interpret mode, the sequential copy against the
reference's oracle, all at rtol = atol = 1e-3
(``tests/kernels/test_kernels.py:138-139``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.rwkv6_scan.ops import rwkv6_scan as j_scan  # noqa: E402
from repro.kernels.rwkv6_scan.ref import rwkv6_scan_ref as j_seq  # noqa: E402
from repro.models.rwkv import _wkv_chunked  # noqa: E402

from repro_torch.kernels.rwkv6_scan import ops, ref  # noqa: E402

TOL = dict(rtol=1e-3, atol=1e-3)


def _inputs(B, S, H, hs, seed, w_lo=0.7, w_hi=0.999, s0_scale=0.5):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(0, 1, (B, S, H, hs)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(w_lo, w_hi, (B, S, H, hs)).astype(np.float32)
    u = rng.normal(0, 1, (H, hs)).astype(np.float32)
    s0 = rng.normal(0, s0_scale, (B, H, hs, hs)).astype(np.float32)
    return r, k, v, w, u, s0


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL)


def _both(fn_j, fn_t, arrays, **kw):
    yj, sj = fn_j(*(jnp.asarray(a) for a in arrays), **kw)
    yt, st = fn_t(*(torch.tensor(a) for a in arrays), **kw)
    assert yt.shape == yj.shape and st.dtype == torch.float32
    _close(yt, yj)
    _close(st, sj)


@pytest.mark.parametrize("chunk", [8, 16, 40, 64])
@pytest.mark.parametrize("S", [80, 83, 1])
def test_chunked_matches_model_wkv_chunked(chunk, S):
    """S divisible by 8 and 16 (80), ragged for every chunk (83), and the
    decode shape (1), with a nonzero bonus u and state s0."""
    arrays = _inputs(2, S, 2, 16, seed=S * 100 + chunk)
    _both(lambda *a, chunk: _wkv_chunked(*a, chunk),
          lambda *a, chunk: ref.rwkv6_scan_chunked(*a, chunk),
          arrays, chunk=chunk)


@pytest.mark.parametrize("chunk", [16, 64])
def test_chunked_follows_the_model_where_the_clamp_bites(chunk):
    """Decays in [0.02, 0.5] push log W below -60 inside a chunk: the chunked
    form (the model's) then departs from the recurrence, and the port
    follows the chunked form."""
    arrays = _inputs(2, 128, 2, 16, seed=7, w_lo=0.02, w_hi=0.5)
    _both(lambda *a, chunk: _wkv_chunked(*a, chunk),
          lambda *a, chunk: ref.rwkv6_scan_chunked(*a, chunk),
          arrays, chunk=chunk)
    if chunk == 64:
        y_seq, _ = ref.rwkv6_scan_ref(*(torch.tensor(a) for a in arrays))
        y_chunk, _ = ref.rwkv6_scan_chunked(
            *(torch.tensor(a) for a in arrays), chunk)
        assert (y_seq - y_chunk).abs().max() > 1.0


@pytest.mark.parametrize("B,S,H,hs,chunk", [
    (2, 64, 2, 16, 16), (1, 128, 4, 32, 32), (2, 96, 1, 8, 48),
    (1, 64, 2, 64, 64),
])   # tests/kernels/test_kernels.py:123-126
def test_wrapper_matches_pallas_kernel_interpret(B, S, H, hs, chunk):
    """ops.rwkv6_scan on CPU tensors (the plain version) against the Pallas
    kernel run in interpret mode, at the reference's own kernel shapes."""
    arrays = _inputs(B, S, H, hs, seed=B * S + hs)
    _both(lambda *a, chunk: j_scan(*a, chunk=chunk),
          lambda *a, chunk: ops.rwkv6_scan(*a, chunk=chunk),
          arrays, chunk=chunk)


@pytest.mark.parametrize("B,S,H,hs", [(2, 40, 2, 8), (1, 17, 3, 16)])
def test_sequential_copy_matches_reference_oracle(B, S, H, hs):
    arrays = _inputs(B, S, H, hs, seed=S, w_lo=0.6)
    _both(j_seq, ref.rwkv6_scan_ref, arrays)


def test_chunked_matches_sequential_without_the_clamp():
    """Away from the clamp the chunked form is the recurrence, whatever the
    chunk."""
    t = [torch.tensor(a) for a in _inputs(2, 70, 2, 8, seed=3, w_lo=0.8)]
    y_seq, s_seq = ref.rwkv6_scan_ref(*t)
    for chunk in (1, 7, 64):
        y, s = ref.rwkv6_scan_chunked(*t, chunk)
        _close(y, y_seq.numpy())
        _close(s, s_seq.numpy())


def test_bf16_inputs_keep_their_type_and_compute_in_float32():
    t = [torch.tensor(a) for a in _inputs(1, 33, 2, 16, seed=4)]
    half = [a.to(torch.bfloat16) for a in t[:4]]
    y, s = ops.rwkv6_scan(*half, t[4], t[5], chunk=16)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    y32, s32 = ref.rwkv6_scan_chunked(*(a.float() for a in half), t[4], t[5],
                                      16)
    assert torch.equal(y, y32.to(torch.bfloat16))
    assert torch.equal(s, s32)


def test_kernel_switch_on_cpu_tensors():
    t = [torch.tensor(a) for a in _inputs(1, 8, 1, 8, seed=5)]
    ops.reset_launches()
    y, s = ops.rwkv6_scan(*t, chunk=4)
    y2, s2 = ops.rwkv6_scan(*t, chunk=4, use_kernel=False)
    assert torch.equal(y, y2) and torch.equal(s, s2)
    with pytest.raises(ValueError, match="use_kernel=True"):
        ops.rwkv6_scan(*t, chunk=4, use_kernel=True)
    assert ops.LAUNCHES["rwkv6_scan"] == 0
