"""The port's MoE FFN (``repro_torch.models.moe``) held to the JAX reference
on the CPU at mixtral-8x22b's and llama4-maverick's reduced() sizes: the
same weights on both sides through
``repro_torch.bridge.model_params_from_reference``, the same inputs from a
numpy seed. Dropless and capacity-bound dispatch, the kept assignments,
the auxiliary loss and the leaves' types."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models as jm  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402

from repro_torch.bridge import model_params_from_reference  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

MOE_TOL = dict(rtol=2e-3, atol=2e-3)   # tests/models/test_model_parts.py:148
ARCHS = ["mixtral-8x22b", "llama4-maverick-400b-a17b"]


def _weights(cfg_j, seed=0):
    """Reference init, then numpy noise on every leaf (the router's 0.02
    scale kept, so that routing is not one-sided)."""
    values, _ = jm.split(jm.init_model(cfg_j, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(0, 0.02, a.shape)
                   ).astype(np.float32), values)


def _moe_layer(cfg):
    return next(i for i, (_, fk) in enumerate(cfg.blocks_in_group)
                if fk == "moe")


@pytest.fixture(scope="module", params=ARCHS)
def moe(request):
    cfg_j = jget(request.param).reduced()
    cfg_t = tget(request.param).reduced()
    values = _weights(cfg_j)
    params = model_params_from_reference(values, cfg_t, "cpu")
    i = _moe_layer(cfg_t)
    p_j = jax.tree_util.tree_map(lambda a: a[0], values["groups"][i]["ffn"])
    return cfg_j, cfg_t, p_j, params["layers"][i]["ffn"]


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).normal(
        0, 1, (B, S, cfg.d_model)).astype(np.float32)


def _reference_routing(p, cfg, x, no_drop):
    """The reference's routing lines (src/repro/models/moe.py:55-83), which
    its moe_ffn does not return: (expert_idx (B, S, K), slot, keep (B, A))."""
    B, S, _ = x.shape
    E, K = cfg.n_experts, cfg.top_k
    logits = jnp.einsum("bsd,de->bse", x, p["router"]).astype(jnp.float32)
    _, expert_idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), K)
    A = S * K
    C = A if no_drop else max(1, int(A * cfg.capacity_factor / E))
    flat_e = expert_idx.reshape(B, A)
    oh = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    nseg = 16 if A % 16 == 0 else 1
    oh = oh.reshape(B, nseg, A // nseg, E)
    within = jnp.cumsum(oh, axis=2)
    seg_tot = within[:, :, -1, :]
    offs = jnp.cumsum(seg_tot, axis=1) - seg_tot
    pos = (within + offs[:, :, None, :]).reshape(B, A, E) - 1
    slot = jnp.take_along_axis(pos, flat_e[..., None], axis=2)[..., 0]
    keep = slot < C
    return (np.asarray(expert_idx), np.asarray(jnp.where(keep, slot, 0)),
            np.asarray(keep))


# (no_drop, capacity_factor, B, S): dropless; capacity-bound with a factor
# of 0.5 (drops certain); the default switch past B S K = 4096 (mixtral:
# capacity mode at the default factor; llama4's top-1: dropless)
CASES = {"no_drop": (True, None, 2, 32), "capacity": (False, 0.5, 2, 32),
         "default": (None, None, 2, 1040)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_ffn_and_aux_match_reference(moe, case):
    cfg_j, cfg_t, p_j, p_t = moe
    no_drop, factor, B, S = CASES[case]
    if factor is not None:
        cfg_j, cfg_t = (c.scaled(capacity_factor=factor)
                        for c in (cfg_j, cfg_t))
    x = _x(cfg_t, B, S, seed=1)
    out_j, aux_j = jmoe.moe_ffn(p_j, cfg_j, jnp.asarray(x), no_drop=no_drop)
    out_t, aux_t = tmoe.moe_ffn(p_t, cfg_t, torch.tensor(x), no_drop=no_drop)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **MOE_TOL)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)
    assert aux_t.dtype == torch.float32 and aux_t.shape == ()


@pytest.mark.parametrize("factor", [0.5, 1.25])
def test_capacity_keeps_the_reference_assignments(moe, factor):
    """Row-grouped, token-major capacity: the same assignments kept, in the
    same slots, as the reference's segmented cumsum gives; at factor 0.5
    some are dropped in every row."""
    cfg_j, cfg_t, p_j, p_t = moe
    cfg_j, cfg_t = (c.scaled(capacity_factor=factor) for c in (cfg_j, cfg_t))
    x = _x(cfg_t, 3, 64, seed=2)
    idx_j, slot_j, keep_j = _reference_routing(p_j, cfg_j, jnp.asarray(x),
                                               no_drop=False)
    r = tmoe.route(p_t, cfg_t, torch.tensor(x), no_drop=False)
    np.testing.assert_array_equal(r.expert_idx.numpy(), idx_j)
    np.testing.assert_array_equal(r.keep.numpy(), keep_j)
    np.testing.assert_array_equal(r.slot.numpy(), slot_j)
    assert r.capacity == max(1, int(64 * cfg_t.top_k * factor
                                    / cfg_t.n_experts))
    assert (r.gate.numpy()[~keep_j] == 0).all()
    if factor == 0.5:
        assert (~keep_j).any(axis=1).all()


def test_dropless_equals_a_per_token_mixture(moe):
    """Under no_drop every token gets its K experts: the port's dispatch
    against the per-token sum of gate x expert FFN, in float64."""
    _, cfg_t, _, p_t = moe
    x = torch.tensor(_x(cfg_t, 2, 8, seed=3))
    out, _ = tmoe.moe_ffn(p_t, cfg_t, x, no_drop=True)
    p64 = {k: v.double() for k, v in p_t.items() if torch.is_tensor(v)}
    x64 = x.double().reshape(-1, cfg_t.d_model)
    probs = torch.softmax(x64 @ p64["router"], -1)
    gv, ei = torch.topk(probs, cfg_t.top_k, -1)
    gv = gv / gv.sum(-1, keepdim=True)
    want = torch.zeros_like(x64)
    for t in range(x64.shape[0]):
        for j in range(cfg_t.top_k):
            e = ei[t, j]
            h = (torch.nn.functional.silu(x64[t] @ p64["w_gate"][e])
                 * (x64[t] @ p64["w_up"][e]))
            want[t] += gv[t, j] * (h @ p64["w_down"][e])
    if "shared" in p_t:
        sh = {k: v.double() for k, v in p_t["shared"].items()}
        want += (torch.nn.functional.silu(x64 @ sh["w_gate"])
                 * (x64 @ sh["w_up"])) @ sh["w_down"]
    np.testing.assert_allclose(out.reshape(-1, cfg_t.d_model).numpy(),
                               want.numpy(), rtol=1e-5, atol=1e-4)


def test_dispatch_is_deterministic(moe):
    """Kept assignments own distinct slots and dropped ones add zeros, so
    two calls give the same bits."""
    _, cfg_t, _, p_t = moe
    x = torch.tensor(_x(cfg_t, 2, 64, seed=4))
    cfg_t = cfg_t.scaled(capacity_factor=0.5)
    a, _ = tmoe.moe_ffn(p_t, cfg_t, x, no_drop=False)
    b, _ = tmoe.moe_ffn(p_t, cfg_t, x, no_drop=False)
    assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_leaves_follow_the_reference_tree_and_types(arch):
    """The bridge carries router, w_up, w_gate, w_down (and llama4's shared
    expert) with the reference's shapes, in cfg.param_dtype."""
    cfg_j = jget(arch).reduced().scaled(param_dtype="bfloat16")
    cfg_t = tget(arch).reduced().scaled(param_dtype="bfloat16")
    values, _ = jm.split(jm.init_model(cfg_j, jax.random.PRNGKey(0)))
    params = model_params_from_reference(
        jax.tree_util.tree_map(np.asarray, values), cfg_t, "cpu")
    i = _moe_layer(cfg_t)
    got = params["layers"][i]["ffn"]
    want = values["groups"][i]["ffn"]
    assert sorted(got) == sorted(want)
    assert ("shared" in got) == bool(cfg_t.n_shared_experts)
    for name in ("router", "w_up", "w_gate", "w_down"):
        assert tuple(got[name].shape) == tuple(want[name].shape[1:])
        assert got[name].dtype == torch.bfloat16
    own = tmoe.init_moe(torch.Generator().manual_seed(0), cfg_t,
                        torch.bfloat16, "cpu")
    assert {k: tuple(v.shape) for k, v in own.items() if torch.is_tensor(v)
            } == {k: tuple(v.shape) for k, v in got.items()
                  if torch.is_tensor(v)}


@pytest.mark.parametrize("no_drop", [True, False])
def test_routing_from_choice_rebuilds_route(moe, no_drop):
    """``routing_from_choice`` on ``route``'s own expert choice and capacity
    gives ``route``'s gates, slots and kept assignments exactly; on another
    choice (each token's experts reversed), the gates follow that choice's
    probabilities and the slots its order."""
    _, cfg_t, _, p_t = moe
    x = torch.tensor(_x(cfg_t, 3, 64, seed=4))
    r = tmoe.route(p_t, cfg_t, x, no_drop=no_drop)
    again = tmoe.routing_from_choice(r.probs, r.expert_idx, r.capacity)
    for name in ("gate", "slot", "keep"):
        assert torch.equal(getattr(again, name), getattr(r, name)), name
    flipped = tmoe.routing_from_choice(r.probs, r.expert_idx.flip(-1),
                                       r.capacity)
    want, _, _ = tmoe.assign_slots(
        r.expert_idx.flip(-1), r.probs.gather(-1, r.expert_idx.flip(-1))
        / r.probs.gather(-1, r.expert_idx).sum(-1, keepdim=True),
        cfg_t.n_experts, r.capacity)
    torch.testing.assert_close(flipped.gate, want, rtol=1e-6, atol=0)
