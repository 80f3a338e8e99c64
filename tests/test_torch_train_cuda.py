"""The training path on the card: ``make_train_step`` on reduced configs
(dense, MoE, RWKV6, the Mamba hybrid) three steps on the card against the
same steps on the CPU, and the kernel wrappers refusing operands that
require grad. These tests import no JAX, so they also run where only the
port is installed; without a CUDA device they skip. On a machine with a
card:

    python -m pytest -q --noconftest -m cuda tests/test_torch_train_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels.alloc_objective import ops as aops  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as sops  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import init_model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = 2e-4      # a leaf at 2e-4 of its largest element (ROADMAP)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "mixtral-8x22b", "rwkv6-7b",
                                  "jamba-1.5-large-398b"])
def test_train_steps_on_the_card_match_the_cpu(cuda, arch):
    """Three steps of the reduced config from the same weights and
    batches: every step's loss, xent, aux, grad norm and lr at 2e-4, and
    the first step's moments m and v (the gradient, from the same
    parameters on both sides) at 2e-4 of each leaf's largest element; no
    kernel launched. (Past the first step the moments carry AdamW's sign
    caveat: an element whose gradient is within rounding of zero moves 2 lr
    apart on the two sides, and reduced jamba's later gradients carry that
    on: on the CPU alone, float32 against float64, 66-184 elements of its
    moments pass 2e-4 at steps 2 and 3, none at step 1; ROADMAP.)"""
    cfg = get_config(arch).reduced().scaled(loss_chunk=16)
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=3)
    cpu = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    card = adamw.tree_map(lambda p: p.to(cuda), cpu)
    states = [adamw.init(cpu), adamw.init(card)]
    data = SyntheticLM(DataConfig(cfg.vocab_size, 32, 2, seed=0))
    step = make_train_step(cfg, opt)
    for o in (aops, dops, fops, sops):
        o.reset_launches()
    for s in range(3):
        b = data.global_batch(s)
        cpu, states[0], m_cpu = step(cpu, states[0], {
            k: torch.as_tensor(v) for k, v in b.items()})
        card, states[1], m_card = step(card, states[1], {
            k: torch.as_tensor(v, device=cuda) for k, v in b.items()})
        for k in ("loss", "xent", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m_card[k]), float(m_cpu[k]),
                                       rtol=TOL, atol=TOL, err_msg=k)
        if s:
            continue
        for tree_cpu, tree_card in ((states[0].m, states[1].m),
                                    (states[0].v, states[1].v)):
            for a, b_ in zip(adamw.tree_leaves(tree_card),
                             adamw.tree_leaves(tree_cpu)):
                np.testing.assert_allclose(
                    a.cpu().numpy(), b_.numpy(), rtol=TOL,
                    atol=TOL * float(b_.abs().max()))
    torch.cuda.synchronize()
    assert not any(v for o in (aops, dops, fops, sops)
                   for v in o.LAUNCHES.values())


def test_kernels_refuse_autograd_on_the_card(cuda):
    """Operands that require grad: every wrapper raises before its launch;
    under inference_mode the same calls launch."""
    g = torch.Generator(device=cuda).manual_seed(0)
    t = lambda *s: torch.randn(s, generator=g, device=cuda)
    q = t(1, 64, 4, 64).requires_grad_(True)
    kv, cache = t(1, 64, 4, 64), t(1, 4, 64, 64)
    r = t(1, 64, 4, 64).requires_grad_(True)
    w = torch.rand((1, 64, 4, 64), generator=g, device=cuda)
    X = torch.rand((1, 4, 128), generator=g, device=cuda).requires_grad_(True)
    z = lambda *s: torch.zeros(s, device=cuda)
    valid = torch.ones(64, dtype=torch.int32, device=cuda)
    calls = [
        lambda: fops.flash_attention(q, kv, kv),
        lambda: dops.decode_attention(q[:, :1], cache, cache, valid),
        lambda: sops.rwkv6_scan(r, kv, kv, w, t(4, 64), t(1, 4, 64, 64)),
        lambda: aops._launch("alloc_objective_fleet", X, z(1, 4, 128),
                             z(1, 2, 128), z(1, 128), z(1, 4), z(1, 8), True)]
    for o in (aops, dops, fops, sops):
        o.reset_launches()
    for call in calls:
        with pytest.raises(RuntimeError, match="has no backward"):
            call()
    assert not any(v for o in (aops, dops, fops, sops)
                   for v in o.LAUNCHES.values())
    with torch.inference_mode():
        for call in calls:
            call()
    torch.cuda.synchronize()
    assert sum(v for o in (aops, dops, fops, sops)
               for v in o.LAUNCHES.values()) == 4
