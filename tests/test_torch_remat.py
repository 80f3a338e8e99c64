"""Remat and autograd safety of the port's training path, on the CPU:
``cfg.remat`` "none", "full" and "dots" give the same loss and gradients
(attention, MoE, Mamba and RWKV configs at reduced() size); the Mamba chunk
scan's out-of-place steps under autograd compute what the in-place ones do
under inference; and every kernel wrapper refuses autograd before anything
else, while serving under ``torch.inference_mode()`` is unaffected."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro_torch.models as tm  # noqa: E402
import repro_torch.models.mamba as tmamba  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.problem import AllocationProblem  # noqa: E402
from repro_torch.kernels.alloc_objective import ops as aops  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as sops  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.testing import make_toy_problem  # noqa: E402

NO_BACKWARD = "has no backward"


def _loss_and_grads(cfg, seed=0):
    params = tm.init_model(cfg, torch.Generator().manual_seed(seed), "cpu")
    rng = np.random.default_rng(seed)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (2, 33)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss, metrics = tm.loss_fn(cfg, params, batch)
    return loss, metrics, torch.autograd.grad(loss, leaves,
                                              materialize_grads=True)


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "mixtral-8x22b",
                                  "jamba-1.5-large-398b", "rwkv6-7b"])
def test_remat_policies_change_no_value(arch):
    """Checkpointing recomputes the same operations on the same inputs:
    the loss and every gradient leaf are equal under the three policies
    (the Mamba and WKV chunk bodies and, past S = 1024, the flash chunks
    are checkpointed under every policy, as in the reference)."""
    base = get_config(arch).reduced().scaled(loss_chunk=16)
    runs = {policy: _loss_and_grads(base.scaled(remat=policy))
            for policy in ("none", "full", "dots")}
    loss, metrics, grads = runs["none"]
    assert torch.isfinite(loss)
    for policy in ("full", "dots"):
        l2, m2, g2 = runs[policy]
        assert torch.equal(l2, loss) and torch.equal(m2["aux"],
                                                     metrics["aux"])
        for a, b in zip(grads, g2):
            assert torch.equal(a, b), policy


def test_bad_remat_policy_and_loss_chunk_raise():
    cfg = get_config("qwen1.5-4b").reduced()
    with pytest.raises(ValueError, match="remat"):
        _loss_and_grads(cfg.scaled(remat="some"))
    with pytest.raises(ValueError, match="loss chunk"):
        _loss_and_grads(cfg.scaled(loss_chunk=20))


def test_mamba_scan_steps_alike_with_and_without_autograd():
    """The in-place Hillis-Steele steps (no autograd) and the out-of-place
    ones (under autograd) give the same values bit for bit."""
    g = torch.Generator().manual_seed(0)
    a = torch.rand((2, 37, 5, 3), generator=g)
    b = torch.randn((2, 37, 5, 3), generator=g)
    with torch.inference_mode():
        A1, B1 = tmamba._scan_chunk(a.clone(), b.clone())
    a2, b2 = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    A2, B2 = tmamba._scan_chunk(a2, b2)
    assert torch.equal(A1, A2.detach()) and torch.equal(B1, B2.detach())
    assert torch.equal(a2, a) and torch.equal(b2, b)   # inputs left as given
    torch.autograd.grad(B2.sum(), (a2, b2))


def _kernel_calls(grad: bool):
    """Each kernel wrapper asked for its kernel (use_kernel=True) on CPU
    operands, the first requiring grad if ``grad``."""
    g = torch.Generator().manual_seed(1)
    t = lambda *s: torch.randn(s, generator=g)
    q, k = t(1, 8, 2, 16).requires_grad_(grad), t(1, 8, 2, 16)
    dq, cache = t(1, 1, 2, 16).requires_grad_(grad), t(1, 2, 8, 16)
    r = t(1, 4, 2, 8).requires_grad_(grad)
    w = torch.rand((1, 4, 2, 8), generator=g)
    prob = make_toy_problem(0, device="cpu")
    X = torch.rand((1, 3, prob.n), generator=g).requires_grad_(grad)
    scal = torch.zeros((1, 8))
    return {
        "flash_attention": lambda: fops.flash_attention(q, k, k,
                                                        use_kernel=True),
        "decode_attention": lambda: dops.decode_attention(
            dq, cache, cache, torch.ones(8, dtype=torch.bool),
            use_kernel=True),
        "rwkv6_scan": lambda: sops.rwkv6_scan(r, r.detach(), r.detach(), w,
                                              t(2, 8), t(1, 2, 8, 8),
                                              use_kernel=True),
        "alloc_objective": lambda: aops._launch(
            "alloc_objective", X, prob.K[None], prob.E[None], prob.c[None],
            prob.d[None], scal, True),
    }


@pytest.mark.parametrize("kernel", ["flash_attention", "decode_attention",
                                    "rwkv6_scan", "alloc_objective"])
def test_kernels_refuse_autograd_before_the_device_check(kernel):
    """An operand that requires grad, grad mode on: the autograd error comes
    first (on the card it is the only one); without grad, or under
    inference_mode, the wrapper gets as far as the device check."""
    with pytest.raises(RuntimeError, match=NO_BACKWARD):
        _kernel_calls(True)[kernel]()
    for ctx in (torch.no_grad, torch.inference_mode):
        with ctx(), pytest.raises(ValueError, match="CUDA"):
            _kernel_calls(True)[kernel]()
    with pytest.raises(ValueError, match="CUDA"):
        _kernel_calls(False)[kernel]()


def test_plain_routes_differentiate_and_default_switch_serves():
    """use_kernel=None on CPU tensors runs the plain versions, which
    autograd differentiates; the launch counters stay at zero."""
    for ops_ in (fops, dops, sops):
        ops_.reset_launches()
    q = torch.randn((1, 8, 2, 16), requires_grad=True)
    out = fops.flash_attention(q, q.detach(), q.detach())
    (dq,) = torch.autograd.grad(out.sum(), q)
    assert torch.isfinite(dq).all()
    assert not any({**fops.LAUNCHES, **dops.LAUNCHES,
                    **sops.LAUNCHES}.values())
    assert isinstance(make_toy_problem(0, device="cpu"), AllocationProblem)
