"""The training loss of the dense attention configs (qwen1.5-4b,
nemotron-4-15b, command-r-plus-104b, granite-34b, musicgen-medium) at
reduced() size: ``repro_torch.models.loss_fn``'s loss, xent, aux and the
gradient of every parameter leaf, by autograd on the plain route under the
config's remat, against ``jax.value_and_grad(repro.models.loss_fn)`` on
the CPU, the same weights on both sides (``repro_torch.bridge``) and the
reference's gradients carried across by the same mapping. The MoE and
vision configs are in ``test_torch_loss_moe.py``, the recurrent ones in
``test_torch_loss_recurrent.py``."""
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
from repro_torch.optim.adamw import tree_leaves  # noqa: E402

# tests/models/test_model_parts.py:40 for values; a gradient leaf at 2e-4
# of its own largest element (ROADMAP, tolerances)
TOL = 2e-4
ARCHS = ["qwen1.5-4b", "nemotron-4-15b", "command-r-plus-104b",
         "granite-34b", "musicgen-medium"]
B, S = 2, 32


def _case(arch, seed=0):
    """Reference weights with numpy noise on every leaf, and a batch of
    tokens and next-token labels (+ frontend embeddings), both sides."""
    cfg_j, cfg_t = jget(arch).reduced(), tget(arch).reduced()
    values, _ = jm.split(jm.init_model(cfg_j, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    values = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(0, 0.05, a.shape)
                   ).astype(np.float32), values)
    toks = rng.integers(0, cfg_j.vocab_size, (B, S + 1)).astype(np.int32)
    bj = {"tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:])}
    bt = {"tokens": torch.tensor(toks[:, :-1]),
          "labels": torch.tensor(toks[:, 1:])}
    if cfg_j.frontend == "vision":
        fe = rng.normal(0, 1, (B, cfg_j.n_frontend_tokens, cfg_j.d_frontend)
                        ).astype(np.float32)
        bj["frontend_embeds"], bt["frontend_embeds"] = (jnp.asarray(fe),
                                                        torch.tensor(fe))
    return cfg_j, cfg_t, values, bj, bt


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    cfg_j, cfg_t, values, bj, bt = _case(arch)
    (lj, mj), gj = jax.value_and_grad(
        lambda p: jm.loss_fn(cfg_j, p, bj), has_aux=True)(values)
    params = model_params_from_reference(values, cfg_t, "cpu")
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    lt, mt = tm.loss_fn(cfg_t, params, bt)
    grads = torch.autograd.grad(lt, leaves, materialize_grads=True)
    for got, want in ((lt, lj), (mt["xent"], mj["xent"]),
                      (mt["aux"], mj["aux"])):
        np.testing.assert_allclose(float(got), float(want), rtol=TOL,
                                   atol=TOL)
    want = tree_leaves(model_params_from_reference(
        jax.tree_util.tree_map(np.asarray, gj), cfg_t, "cpu"))
    assert len(grads) == len(want)
    for i, (g, w) in enumerate(zip(grads, want)):
        scale = float(w.abs().max())
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=TOL,
                                   atol=TOL * scale, err_msg=f"leaf {i}")
