"""The flash_attention and decode_attention CUDA kernels against their plain
PyTorch versions, on the card, and the model's launches of them. These tests
import no JAX, so they also run where only the port is installed; without a
CUDA device they skip. On a machine with a card:

    python -m pytest -q --noconftest -m cuda tests/test_torch_attention_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dops  # noqa: E402
from repro_torch.kernels.decode_attention import ref as dref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fref  # noqa: E402
from repro_torch.models import (decode_step, forward, init_model,  # noqa: E402
                                prefill)

pytestmark = pytest.mark.cuda
# tests/kernels/test_kernels.py:10-11
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rand(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def _close(got, want, dtype):
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("B,S,H,G,dh,window,dtype", [
    (8, 1024, 20, 20, 128, 0, torch.float32),    # qwen1.5-4b prefill
    (2, 1024, 48, 8, 128, 0, torch.float32),     # nemotron-4-15b heads
    (2, 1024, 20, 20, 128, 256, torch.float32),  # sliding window
    (2, 1000, 20, 20, 128, 0, torch.float32),    # ragged last tile
    (2, 1024, 20, 20, 128, 0, torch.bfloat16),
    (2, 77, 4, 1, 64, 0, torch.float32),
    (3, 130, 6, 2, 32, 40, torch.bfloat16),
    (1, 5, 2, 2, 16, 0, torch.float32),
    (2, 1024, 16, 4, 128, 256, torch.bfloat16),  # bf16 GQA + window
    (2, 700, 12, 4, 64, 100, torch.bfloat16),
    (2, 5, 4, 2, 16, 3, torch.float32),
    # window 20, a multiple of no tile: the later rows of a query tile have
    # no live key in the first key tile it visits, its earlier rows do
    (2, 333, 4, 2, 64, 20, torch.float32),
    (2, 333, 4, 2, 64, 20, torch.bfloat16),
    (1, 200, 4, 1, 32, 1, torch.float32),        # one live key a row
])
def test_flash_kernel_matches_plain(cuda, B, S, H, G, dh, window, dtype):
    gen = torch.Generator(device=cuda).manual_seed(S + H + window)
    q = _rand(gen, (B, S, H, dh), dtype, cuda)
    k, v = (_rand(gen, (B, S, G, dh), dtype, cuda) for _ in range(2))
    fops.reset_launches()
    out = fops.flash_attention(q, k, v, window)
    torch.cuda.synchronize()
    assert fops.LAUNCHES["flash_attention"] == 1
    _close(out, fref.flash_attention_ref(q.float(), k.float(), v.float(),
                                         window), dtype)


@pytest.mark.parametrize("B,S,H,G,dh,window", [
    (2, 512, 8, 2, 128, 0),
    (2, 300, 4, 4, 64, 100),
    (1, 77, 2, 1, 16, 0),
])
def test_flash_kernel_float32_keeps_2e4_at_wide_scores(cuda, B, S, H, G, dh,
                                                        window):
    """q scaled by 8: the scores spread with a standard deviation of about
    8, so a product that kept only TF32's 10 mantissa bits (or lost 3xTF32's
    small terms) shows at 2e-4 against the float64 plain version."""
    gen = torch.Generator(device=cuda).manual_seed(S + dh)
    q = 8.0 * _rand(gen, (B, S, H, dh), torch.float32, cuda)
    k, v = (_rand(gen, (B, S, G, dh), torch.float32, cuda) for _ in range(2))
    out = fops.flash_attention(q, k, v, window)
    want = fref.flash_attention_ref(q.double(), k.double(), v.double(),
                                    window)
    _close(out, want, torch.float32)


@pytest.mark.parametrize("B,S,H,G,dh,window", [
    (1, 1024, 48, 8, 128, 4096),    # mixtral-8x22b's heads and window
    (2, 1024, 20, 20, 128, 256),
    (2, 700, 12, 4, 64, 0),
])
def test_flash_kernel_float32_rounds_as_float32_does(cuda, B, S, H, G, dh,
                                                     window):
    """Against the plain version in float64, the float32 kernel's rms error
    is at most twice the plain float32 version's: its sums round as
    float32's do. (Long sums kept in the tensor cores' accumulators, which
    truncate, reached 8-10 times it at mixtral-8x22b's shape.)"""
    gen = torch.Generator(device=cuda).manual_seed(S + H + window)
    q = _rand(gen, (B, S, H, dh), torch.float32, cuda)
    k, v = (_rand(gen, (B, S, G, dh), torch.float32, cuda) for _ in range(2))
    exact = fref.flash_attention_ref(q.double(), k.double(), v.double(),
                                     window)
    rms = lambda t: float(t.pow(2).mean().sqrt())
    kern = rms(fops.flash_attention(q, k, v, window).double() - exact)
    plain = rms(fref.flash_attention_ref(q, k, v, window).double() - exact)
    assert kern <= 2 * plain, (kern / rms(exact), plain / rms(exact))


@pytest.mark.parametrize("B,S,H,G,dh,valid,dtype", [
    (8, 1056, 20, 20, 128, "all", torch.float32),     # qwen1.5-4b decode
    (8, 1056, 20, 20, 128, "prefix:700", torch.float32),
    (8, 250, 20, 20, 128, "prefix:181", torch.float32),   # ring, pre-wrap
    (8, 1056, 20, 20, 128, "band:256", torch.float32),    # sliding window
    (8, 1056, 48, 8, 128, "all", torch.float32),
    (8, 1056, 20, 20, 128, "all", torch.bfloat16),
    (2, 37, 4, 2, 64, "prefix:1", torch.float32),
    (3, 100, 8, 1, 16, "band:9", torch.bfloat16),
    (2, 64, 4, 4, 32, "none", torch.float32),   # no valid slot: mean of v
])
def test_decode_kernel_matches_plain(cuda, B, S, H, G, dh, valid, dtype):
    gen = torch.Generator(device=cuda).manual_seed(S + H)
    kind, _, n = valid.partition(":")
    pos = torch.arange(S, device=cuda)
    ok = {"all": pos >= 0, "none": pos < 0,
          "prefix": pos < int(n or 0), "band": pos >= S - int(n or 0)}[kind]
    q = _rand(gen, (B, 1, H, dh), dtype, cuda)
    kc, vc = (_rand(gen, (B, G, S, dh), dtype, cuda) for _ in range(2))
    dops.reset_launches()
    out = dops.decode_attention(q, kc, vc, ok)
    torch.cuda.synchronize()
    assert dops.LAUNCHES["decode_attention"] == 1
    _close(out, dref.decode_attention_ref(q.float(), kc.float(), vc.float(),
                                          ok), dtype)


def test_a_row_does_not_depend_on_its_batch(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = _rand(gen, (4, 200, 8, 64), torch.float32, cuda)
    k, v = (_rand(gen, (4, 200, 2, 64), torch.float32, cuda) for _ in range(2))
    out = fops.flash_attention(q, k, v, 50)
    one = fops.flash_attention(q[2:3].contiguous(), k[2:3].contiguous(),
                               v[2:3].contiguous(), 50)
    assert torch.equal(out[2:3], one)
    qd = _rand(gen, (4, 1, 8, 64), torch.float32, cuda)
    kc, vc = (_rand(gen, (4, 2, 300, 64), torch.float32, cuda)
              for _ in range(2))
    valid = torch.arange(300, device=cuda) < 211
    out = dops.decode_attention(qd, kc, vc, valid)
    one = dops.decode_attention(qd[1:2].contiguous(), kc[1:2].contiguous(),
                                vc[1:2].contiguous(), valid)
    assert torch.equal(out[1:2], one)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.randn(1, 64, 4, 32, device=cuda)
    k = torch.randn(1, 64, 2, 32, device=cuda)
    with pytest.raises(TypeError):
        fops.flash_attention(q.double(), k.double(), k.double())
    with pytest.raises(ValueError, match="contiguous"):
        fops.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                             k, k)
    with pytest.raises(ValueError, match="head size"):
        narrow = k[..., :24].contiguous()
        fops.flash_attention(q[..., :24].contiguous(), narrow, narrow)
    with pytest.raises(ValueError, match="group"):
        fops.flash_attention(q[:, :, :3].contiguous(), k, k)
    kc = torch.randn(1, 2, 64, 32, device=cuda)
    with pytest.raises(ValueError, match="valid"):
        dops.decode_attention(q[:, :1].contiguous(), kc, kc,
                              torch.ones(63, dtype=torch.bool, device=cuda))


def test_model_launches_one_kernel_per_layer_and_matches_plain(cuda):
    """qwen1.5-4b's reduced() shape on the card: prefill launches the flash
    kernel once per layer, each decode step the decode kernel once per
    layer; use_kernel=False launches neither and agrees (2e-4 prefill,
    2e-3 decode: tests/models/test_model_parts.py:40)."""
    cfg = get_config("qwen1.5-4b").reduced()
    params = init_model(cfg, torch.Generator(device=cuda).manual_seed(0),
                        device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda)
    fops.reset_launches()
    dops.reset_launches()
    lg, caches = prefill(cfg, params, {"tokens": tokens}, s_max=44)
    tok = lg.argmax(-1, keepdim=True)
    dl, caches = decode_step(cfg, params, caches, tok, 40)
    assert fops.LAUNCHES["flash_attention"] == cfg.n_layers
    assert dops.LAUNCHES["decode_attention"] == cfg.n_layers
    plg, pc = prefill(cfg, params, {"tokens": tokens}, s_max=44,
                      use_kernel=False)
    pdl, _ = decode_step(cfg, params, pc, tok, 40, use_kernel=False)
    assert fops.LAUNCHES["flash_attention"] == cfg.n_layers
    assert dops.LAUNCHES["decode_attention"] == cfg.n_layers
    np.testing.assert_allclose(lg.cpu().numpy(), plg.cpu().numpy(),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(dl.cpu().numpy(), pdl.cpu().numpy(),
                               rtol=2e-3, atol=2e-3)
    full, _ = forward(cfg, params, {"tokens": torch.cat([tokens, tok], 1)})
    np.testing.assert_allclose(dl.cpu().numpy(), full[:, -1].cpu().numpy(),
                               rtol=2e-3, atol=2e-3)
