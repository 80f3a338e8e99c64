"""``repro_torch.optim.adamw`` against ``repro.optim.adamw`` on the CPU:
the schedule over warmup and cosine, and five ``update`` steps on a
reduced model's parameter tree fed the same gradients on both sides,
clipping on and off, the state carried across by
``bridge.adamw_state_from_reference``; and the in-place update's own
promises (the same tree back, gradients released)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models as jm  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402

from repro_torch.bridge import (adamw_state_from_reference,  # noqa: E402
                                model_params_from_reference)
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

TOL = 2e-4


def test_schedule_matches_reference():
    cfg_j = jadamw.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=40)
    cfg_t = adamw.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=40)
    for step in range(0, 46):
        np.testing.assert_allclose(
            float(adamw.schedule(cfg_t, torch.tensor(step, dtype=torch.int32))),
            float(jadamw.schedule(cfg_j, jnp.int32(step))), rtol=1e-6)


def _tree(arch="mixtral-8x22b"):
    cfg_j, cfg_t = jget(arch).reduced(), tget(arch).reduced()
    values, _ = jm.split(jm.init_model(cfg_j, jax.random.PRNGKey(0)))
    values = jax.tree_util.tree_map(np.asarray, values)
    return cfg_j, cfg_t, values


@pytest.mark.parametrize("clip_norm", [1e9, 0.5])
def test_five_updates_match_reference(clip_norm):
    """Steps 1-5 over a warmup of 2 and a cosine to step 5, the same random
    gradients on both sides (gradient norm about 5: clip_norm 0.5 scales
    every step by about 0.1, 1e9 never). Parameters, m, v, the step, the
    grad norm and lr agree at 2e-4 (of each leaf's largest element)."""
    cfg_j, cfg_t, values = _tree()
    opt_j = jadamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5,
                               clip_norm=clip_norm)
    opt_t = adamw.AdamWConfig(**opt_j._asdict())
    rng = np.random.default_rng(4)
    params_j, state_j = values, jadamw.init(values)
    params_t = model_params_from_reference(values, cfg_t, "cpu")
    state_t = adamw_state_from_reference(
        jax.tree_util.tree_map(np.asarray, state_j), cfg_t, "cpu")
    for _ in range(5):
        grads = jax.tree_util.tree_map(
            lambda a: rng.normal(0, 0.02, a.shape).astype(np.float32),
            values)
        params_j, state_j, om_j = jadamw.update(opt_j, grads, state_j,
                                                params_j)
        params_t, state_t, om_t = adamw.update(
            opt_t, model_params_from_reference(grads, cfg_t, "cpu"),
            state_t, params_t)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(om_t[k]), float(om_j[k]),
                                       rtol=1e-5)
    assert int(state_t.step) == int(state_j.step) == 5
    for got, want in ((params_t, model_params_from_reference(
            jax.tree_util.tree_map(np.asarray, params_j), cfg_t, "cpu")),
                      (state_t, adamw_state_from_reference(
            jax.tree_util.tree_map(np.asarray, state_j), cfg_t, "cpu"))):
        tree_got = [got] if isinstance(got, dict) else [got.m, got.v]
        tree_want = [want] if isinstance(want, dict) else [want.m, want.v]
        for tg, tw in zip(tree_got, tree_want):
            for a, b in zip(adamw.tree_leaves(tg), adamw.tree_leaves(tw)):
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL,
                                           atol=TOL * float(b.abs().max()))


def test_update_is_in_place_and_releases_gradients():
    _, cfg_t, values = _tree("qwen1.5-4b")
    params = model_params_from_reference(values, cfg_t, "cpu")
    state = adamw.init(params)
    grads = adamw.tree_map(torch.ones_like, params)
    ids = [id(p) for p in adamw.tree_leaves(params)]
    moments = [id(m) for m in adamw.tree_leaves(state.m)]
    out, new_state, metrics = adamw.update(adamw.AdamWConfig(), grads, state,
                                           params)
    assert out is params and [id(p) for p in adamw.tree_leaves(out)] == ids
    assert [id(m) for m in adamw.tree_leaves(new_state.m)] == moments
    assert all(g is None for g in adamw.tree_leaves(grads))
    assert int(new_state.step) == 1 and int(state.step) == 0
    assert float(metrics["grad_norm"]) > 0
