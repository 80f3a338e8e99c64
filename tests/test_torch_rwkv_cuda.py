"""The rwkv6_scan CUDA kernel against its plain PyTorch version, on the card,
and an RWKV6 model's launches of it. These tests import no JAX, so they also
run where only the port is installed; without a CUDA device they skip. On a
machine with a card:

    python -m pytest -q --noconftest -m cuda tests/test_torch_rwkv_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops, ref  # noqa: E402
from repro_torch.models import (decode_step, forward, init_model,  # noqa: E402
                                prefill)

pytestmark = pytest.mark.cuda
# tests/kernels/test_kernels.py:138-139 in float32; bf16 outputs round
TOL = {torch.float32: 1e-3, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(gen, B, S, H, hs, dtype, device, w_lo=0.7, w_hi=0.999):
    rand = lambda *shape: torch.randn(shape, generator=gen, device=device)
    r, k, v = (rand(B, S, H, hs).to(dtype) for _ in range(3))
    w = (w_lo + (w_hi - w_lo) * torch.rand((B, S, H, hs), generator=gen,
                                           device=device)).to(dtype)
    return r, k, v, w, rand(H, hs), 0.5 * rand(B, H, hs, hs)


@pytest.mark.parametrize("B,S,H,hs,chunk,w_lo,w_hi,dtype", [
    (8, 1024, 64, 64, 64, 0.7, 0.999, torch.float32),   # rwkv6-7b prefill
    (8, 1, 64, 64, 1, 0.7, 0.999, torch.float32),       # rwkv6-7b decode
    (8, 1056, 64, 64, 64, 0.7, 0.999, torch.float32),   # ragged last chunk
    (2, 256, 64, 64, 64, 0.02, 0.5, torch.float32),     # the clamp bites
    (2, 256, 8, 16, 16, 0.7, 0.999, torch.float32),
    (2, 96, 3, 8, 48, 0.6, 0.999, torch.float32),
    (2, 100, 4, 32, 7, 0.6, 0.999, torch.float32),
    (8, 1024, 64, 64, 64, 0.7, 0.999, torch.bfloat16),
    (3, 77, 5, 16, 16, 0.6, 0.999, torch.bfloat16),
])
def test_kernel_matches_plain(cuda, B, S, H, hs, chunk, w_lo, w_hi, dtype):
    gen = torch.Generator(device=cuda).manual_seed(S + hs + chunk)
    r, k, v, w, u, s0 = _inputs(gen, B, S, H, hs, dtype, cuda, w_lo, w_hi)
    ops.reset_launches()
    y, sf = ops.rwkv6_scan(r, k, v, w, u, s0, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["rwkv6_scan"] == 1
    assert y.dtype == dtype and sf.dtype == torch.float32
    yr, sr = ref.rwkv6_scan_chunked(r.float(), k.float(), v.float(),
                                    w.float(), u, s0, chunk)
    for got, want in ((y, yr), (sf, sr)):
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.cpu().numpy(), rtol=TOL[dtype],
                                   atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hs", [8, 16, 32, 64])
def test_decode_form_matches_plain(cuda, hs, dtype):
    """S = 1 runs the decode form (the wrapper cuts chunk to 1)."""
    gen = torch.Generator(device=cuda).manual_seed(hs)
    r, k, v, w, u, s0 = _inputs(gen, 5, 1, 6, hs, dtype, cuda)
    ops.reset_launches()
    y, sf = ops.rwkv6_scan(r, k, v, w, u, s0, chunk=64)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["rwkv6_scan"] == 1
    assert y.dtype == dtype and sf.dtype == torch.float32
    yr, sr = ref.rwkv6_scan_chunked(r.float(), k.float(), v.float(),
                                    w.float(), u, s0, 1)
    for got, want in ((y, yr), (sf, sr)):
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.cpu().numpy(), rtol=TOL[dtype],
                                   atol=TOL[dtype])


@pytest.mark.parametrize("hs", [16, 64])
@pytest.mark.parametrize("chunk,S", [(1, 37), (7, 100), (17, 150),
                                     (48, 200)])
def test_chunks_with_a_ragged_end(cuda, chunk, S, hs):
    """Chunks that are not a multiple of 16 (padded inside the tile) at an
    S that is not a multiple of the chunk."""
    gen = torch.Generator(device=cuda).manual_seed(chunk * S + hs)
    r, k, v, w, u, s0 = _inputs(gen, 2, S, 3, hs, torch.float32, cuda,
                                0.5, 0.999)
    y, sf = ops.rwkv6_scan(r, k, v, w, u, s0, chunk=chunk)
    yr, sr = ref.rwkv6_scan_chunked(r, k, v, w, u, s0, chunk)
    for got, want in ((y, yr), (sf, sr)):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-3, atol=1e-3)


def test_prefill_error_against_float64_is_near_the_plain_versions(cuda):
    """At rwkv6-7b's prefill shape the kernel (3xTF32 products) lies no
    farther from the chunked form in float64, by rms, than twice the plain
    version (float32 products) does."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    r, k, v, w, u, s0 = _inputs(gen, 8, 1024, 64, 64, torch.float32, cuda)
    y, _ = ops.rwkv6_scan(r, k, v, w, u, s0, chunk=64)
    yr, _ = ref.rwkv6_scan_chunked(r, k, v, w, u, s0, 64)
    y64, _ = ref.rwkv6_scan_chunked(*(a.double() for a in (r, k, v, w, u,
                                                            s0)), 64,
                                    compute_dtype=torch.float64)
    rms = lambda t: t.pow(2).mean().sqrt().item()
    assert rms(y.double() - y64) <= 2 * rms(yr.double() - y64)


@pytest.mark.parametrize("B,S,H,hs,chunk,w_lo,w_hi", [
    (8, 1024, 64, 64, 64, 0.7, 0.999),     # rwkv6-7b prefill
    (8, 1056, 64, 64, 64, 0.7, 0.999),     # a ragged last chunk
    (8, 1024, 64, 64, 64, 0.02, 0.5),      # the clamp at e^-60 bites
    (8, 1024, 256, 16, 16, 0.7, 0.999),
])
def test_prefill_kernel_float32_rounds_as_float32_does(cuda, B, S, H, hs,
                                                       chunk, w_lo, w_hi):
    """Against the chunked form in float64, the float32 prefill form's rms
    error, of y and of the final state, is at most twice the plain float32
    version's: its 3xTF32 products round as float32's do. (With the chains
    of products in the tensor cores' accumulators, which truncate, and the
    approximate exp, the clamp case's y reached 2.25 times it.)"""
    gen = torch.Generator(device=cuda).manual_seed(S + hs + int(100 * w_lo))
    r, k, v, w, u, s0 = _inputs(gen, B, S, H, hs, torch.float32, cuda,
                                w_lo, w_hi)
    kern = ops.rwkv6_scan(r, k, v, w, u, s0, chunk=chunk)
    plain = ref.rwkv6_scan_chunked(r, k, v, w, u, s0, chunk)
    exact = ref.rwkv6_scan_chunked(*(a.double() for a in (r, k, v, w, u,
                                                           s0)), chunk,
                                   compute_dtype=torch.float64)
    rms = lambda t: t.pow(2).mean().sqrt().item()
    for got, want, x in zip(kern, plain, exact):
        assert rms(got.double() - x) <= 2 * rms(want.double() - x), (
            rms(got.double() - x) / rms(want.double() - x))


@pytest.mark.parametrize("S", [1, 130])
def test_s0_is_not_written(cuda, S):
    gen = torch.Generator(device=cuda).manual_seed(S)
    r, k, v, w, u, s0 = _inputs(gen, 3, S, 4, 64, torch.float32, cuda)
    kept = s0.clone()
    _, sf = ops.rwkv6_scan(r, k, v, w, u, s0, chunk=64)
    torch.cuda.synchronize()
    assert torch.equal(s0, kept) and not torch.equal(sf, s0)


def test_a_decode_row_does_not_depend_on_its_batch(cuda):
    gen = torch.Generator(device=cuda).manual_seed(2)
    r, k, v, w, u, s0 = _inputs(gen, 6, 1, 8, 64, torch.float32, cuda)
    y, sf = ops.rwkv6_scan(r, k, v, w, u, s0)
    one = [a[4:5].contiguous() for a in (r, k, v, w)]
    y1, sf1 = ops.rwkv6_scan(*one, u, s0[4:5].contiguous())
    assert torch.equal(y[4:5], y1) and torch.equal(sf[4:5], sf1)


def test_a_row_does_not_depend_on_its_batch(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    r, k, v, w, u, s0 = _inputs(gen, 4, 130, 4, 32, torch.float32, cuda)
    y, sf = ops.rwkv6_scan(r, k, v, w, u, s0, chunk=32)
    one = [a[2:3].contiguous() for a in (r, k, v, w)]
    y1, sf1 = ops.rwkv6_scan(*one, u, s0[2:3].contiguous(), chunk=32)
    assert torch.equal(y[2:3], y1) and torch.equal(sf[2:3], sf1)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    r, k, v, w, u, s0 = _inputs(gen, 1, 16, 2, 16, torch.float32, cuda)
    with pytest.raises(TypeError):
        ops.rwkv6_scan(*(a.double() for a in (r, k, v, w)), u, s0)
    with pytest.raises(ValueError, match="head size"):
        narrow = [a[..., :12].contiguous() for a in (r, k, v, w)]
        ops.rwkv6_scan(*narrow, u[:, :12].contiguous(),
                       s0[:, :, :12, :12].contiguous())
    long_r, long_k, long_v, long_w, _, _ = _inputs(gen, 1, 200, 2, 16,
                                                   torch.float32, cuda)
    with pytest.raises(ValueError, match="chunk"):
        ops.rwkv6_scan(long_r, long_k, long_v, long_w, u, s0, chunk=128)
    with pytest.raises(ValueError, match="chunk"):
        ops.rwkv6_scan(r, k, v, w, u, s0, chunk=0)
    with pytest.raises(ValueError, match="contiguous"):
        ops.rwkv6_scan(r.transpose(1, 2).contiguous().transpose(1, 2), k, v,
                       w, u, s0)
    with pytest.raises(ValueError, match="device|cpu"):
        ops.rwkv6_scan(r, k.cpu(), v, w, u, s0)
    with pytest.raises(TypeError):
        ops.rwkv6_scan(r, k.to(torch.bfloat16), v, w, u, s0)
    ops.reset_launches()
    assert ops.LAUNCHES["rwkv6_scan"] == 0


def test_model_launches_one_scan_per_layer_and_matches_plain(cuda):
    """rwkv6-7b's reduced() shape on the card: prefill and each decode step
    launch the scan once per layer; use_kernel=False launches none and
    agrees (2e-4 prefill, 2e-3 decode: tests/models/test_model_parts.py:40);
    decode agrees with teacher forcing."""
    cfg = get_config("rwkv6-7b").reduced()
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = init_model(cfg, gen, device=cuda)
    for layer in params["layers"]:
        layer["mix"]["u"].normal_(0.0, 0.5, generator=gen)
        layer["mix"]["w_base"].copy_(torch.linspace(-6.0, -1.0,
                                                    cfg.d_model))
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda,
                           generator=gen)
    ops.reset_launches()
    lg, caches = prefill(cfg, params, {"tokens": tokens}, s_max=44)
    assert ops.LAUNCHES["rwkv6_scan"] == cfg.n_layers
    tok = lg.argmax(-1, keepdim=True)
    dl, caches = decode_step(cfg, params, caches, tok, 40)
    assert ops.LAUNCHES["rwkv6_scan"] == 2 * cfg.n_layers
    plg, pc = prefill(cfg, params, {"tokens": tokens}, s_max=44,
                      use_kernel=False)
    pdl, _ = decode_step(cfg, params, pc, tok, 40, use_kernel=False)
    assert ops.LAUNCHES["rwkv6_scan"] == 2 * cfg.n_layers
    np.testing.assert_allclose(lg.cpu().numpy(), plg.cpu().numpy(),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(dl.cpu().numpy(), pdl.cpu().numpy(),
                               rtol=2e-3, atol=2e-3)
    full, _ = forward(cfg, params, {"tokens": torch.cat([tokens, tok], 1)})
    np.testing.assert_allclose(dl.cpu().numpy(), full[:, -1].cpu().numpy(),
                               rtol=2e-3, atol=2e-3)
