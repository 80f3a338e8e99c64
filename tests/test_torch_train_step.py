"""``repro_torch.launch.steps.make_train_step`` against the reference's,
three steps on reduced qwen1.5-4b, mixtral-8x22b and rwkv6-7b on the CPU:
the same weights (``bridge``), the same batches (the data pipeline's
copy), AdamW with the launcher's settings. Each step's loss, xent, aux,
grad norm and lr, and the moments m and v after every step, at 2e-4 (a
leaf at 2e-4 of its largest element). The parameters are compared where
the update's direction is settled: at AdamW's first step an element moves
by lr times the sign of its gradient, so an element whose gradient is
within float32 rounding of zero may move 2 lr apart on the two sides. The
parameters are held where every step's gradient (recovered from each
side's m) is settled: the reference's at least 1e4 times the two sides'
difference, or zero on both (an embedding row of a token absent from the
step's batch, an expert nobody routed to: decay alone moves it). That is
at least 95% of every model's parameters."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models as jm  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro.launch.steps import make_train_step as j_make_train_step  # noqa: E402,E501
from repro.optim import adamw as jadamw  # noqa: E402

from repro_torch.bridge import (adamw_state_from_reference,  # noqa: E402
                                model_params_from_reference)
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

TOL = 2e-4
B, S, STEPS, LR = 2, 32, 3, 1e-3
SETTLED = 1e4


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "mixtral-8x22b", "rwkv6-7b"])
def test_three_train_steps_match_reference(arch):
    cfg_j = jget(arch).reduced().scaled(loss_chunk=16)
    cfg_t = tget(arch).reduced().scaled(loss_chunk=16)
    values, _ = jm.split(jm.init_model(cfg_j, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    values = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(0, 0.05, a.shape)
                   ).astype(np.float32), values)
    opt_j = jadamw.AdamWConfig(lr=LR, warmup_steps=2, total_steps=STEPS)
    opt_t = adamw.AdamWConfig(**opt_j._asdict())
    step_j = jax.jit(j_make_train_step(cfg_j, opt_j))
    step_t = make_train_step(cfg_t, opt_t)
    data = SyntheticLM(DataConfig(vocab_size=cfg_j.vocab_size, seq_len=S,
                                  global_batch=B, seed=0))
    params_j, state_j = values, jadamw.init(values)
    params_t = model_params_from_reference(values, cfg_t, "cpu")
    state_t = adamw.init(params_t)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    settled = None
    m_prev = [[torch.zeros_like(m) for m in adamw.tree_leaves(state_t.m)]
              ] * 2
    for step in range(STEPS):
        b = data.global_batch(step)
        params_j, state_j, met_j = step_j(
            params_j, state_j, {k: jnp.asarray(v) for k, v in b.items()})
        params_t, state_t, met_t = step_t(
            params_t, state_t, {k: torch.tensor(v) for k, v in b.items()})
        for k in ("loss", "xent", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(float(met_t[k]), float(met_j[k]),
                                       rtol=TOL, atol=TOL, err_msg=k)
        want = adamw_state_from_reference(to_np(state_j), cfg_t, "cpu")
        assert int(state_t.step) == int(want.step) == step + 1
        for got_tree, want_tree in ((state_t.m, want.m),
                                    (state_t.v, want.v)):
            for i, (a, w) in enumerate(zip(adamw.tree_leaves(got_tree),
                                           adamw.tree_leaves(want_tree))):
                np.testing.assert_allclose(
                    a.numpy(), w.numpy(), rtol=TOL,
                    atol=TOL * float(w.abs().max()),
                    err_msg=f"step {step} leaf {i}")
        # each side's gradient, g = (m - b1 m_prev) / (1 - b1): settled
        # where the reference's exceeds the two sides' difference 1e4-fold
        # (the step's direction then agrees to 1e-4 of lr), or both are 0
        m_now = [adamw.tree_leaves(want.m), adamw.tree_leaves(state_t.m)]
        g_ref, g_port = ([(m - opt_j.beta1 * mp) / (1 - opt_j.beta1)
                          for m, mp in zip(ms, prev)]
                         for ms, prev in zip(m_now, m_prev))
        ok = [(r.abs() >= SETTLED * (p - r).abs()) & ((r != 0) | (p == 0))
              for r, p in zip(g_ref, g_port)]
        settled = ok if settled is None else [a & c for a, c in
                                              zip(settled, ok)]
        m_prev = [[m.clone() for m in ms] for ms in m_now]
    want_p = adamw.tree_leaves(model_params_from_reference(
        to_np(params_j), cfg_t, "cpu"))
    held = 0
    for i, (a, w, keep) in enumerate(zip(adamw.tree_leaves(params_t),
                                         want_p, settled)):
        a = a.detach()
        np.testing.assert_allclose(a[keep].numpy(), w[keep].numpy(),
                                   rtol=TOL, atol=TOL * LR,
                                   err_msg=f"leaf {i}")
        held += int(keep.sum())
    total = sum(p.numel() for p in want_p)
    assert held >= 0.95 * total, (held, total)
