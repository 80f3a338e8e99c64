"""The port's Mamba block (``repro_torch.models.mamba``) held to the JAX
reference on the CPU at jamba-1.5-large's reduced() size: the same weights
on both sides through ``repro_torch.bridge.model_params_from_reference``
(jamba's period of 8, layer 0 a Mamba block), the same inputs from a numpy
seed. The chunked scan at several chunks and a ragged S, a nonzero
MambaCache, prefill then decode against the whole sequence, the bf16 scan
lever and the leaves' types."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models as jm  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402

from repro_torch.bridge import model_params_from_reference  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import MambaCache  # noqa: E402
from repro_torch.models import mamba as tmamba  # noqa: E402

FULL = dict(rtol=2e-4, atol=2e-4)     # tests/models/test_model_parts.py:89
DECODE = dict(rtol=2e-3, atol=2e-3)   # tests/models/test_model_parts.py:40
BF16_LEVER = dict(rtol=5e-2, atol=5e-2)   # test_model_parts.py:175-176
ARCH = "jamba-1.5-large-398b"


def _weights(cfg_j, seed=0):
    """Reference init, then numpy noise on every leaf (A_log, D and dt_bias
    included, so that each channel decays at its own rate)."""
    values, _ = jm.split(jm.init_model(cfg_j, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(0, 0.1, a.shape)
                   ).astype(np.float32), values)


@pytest.fixture(scope="module")
def mamba():
    cfg_j, cfg_t = jget(ARCH).reduced(), tget(ARCH).reduced()
    assert cfg_t.blocks_in_group[0][0] == "mamba"
    values = _weights(cfg_j)
    params = model_params_from_reference(values, cfg_t, "cpu")
    p_j = jax.tree_util.tree_map(lambda a: a[1], values["groups"][0]["mix"])
    # layer 8 is group 1 of block 0
    return cfg_j, cfg_t, p_j, params["layers"][8]["mix"]


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).normal(
        0, 1, (B, S, cfg.d_model)).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _cache_pair(cfg, B, seed):
    rng = np.random.default_rng(seed)
    conv = rng.normal(0, 1, (B, cfg.mamba_d_conv - 1, cfg.mamba_d_inner))
    ssm = rng.normal(0, 0.5, (B, cfg.mamba_d_inner, cfg.mamba_d_state))
    conv, ssm = conv.astype(np.float32), ssm.astype(np.float32)
    return (jmamba.MambaCache(jnp.asarray(conv), jnp.asarray(ssm)),
            MambaCache(torch.tensor(conv), torch.tensor(ssm)))


@pytest.mark.parametrize("S,chunk", [(64, 0), (64, 8), (64, 64), (50, 16),
                                     (7, 0), (1, 0)])
def test_mamba_block_matches_reference(mamba, S, chunk):
    """Output and both new states at 2e-4; chunk 0 is the default
    min(256, S); S = 50 at chunk 16 pads a ragged last chunk."""
    cfg_j, cfg_t, p_j, p_t = mamba
    cfg_j, cfg_t = (c.scaled(scan_chunk=chunk) for c in (cfg_j, cfg_t))
    x = _x(cfg_t, 2, S, seed=S + chunk)
    y_j, c_j = jmamba.mamba_block(p_j, cfg_j, jnp.asarray(x))
    y_t, c_t = tmamba.mamba_block(p_t, cfg_t, torch.tensor(x))
    _close(y_t, y_j, FULL)
    _close(c_t.conv, c_j.conv, FULL)
    _close(c_t.ssm, c_j.ssm, FULL)
    assert c_t.ssm.dtype == torch.float32


def test_chunk_invariance(mamba):
    """Chunks of 8 and of 64 give the same block (test_model_parts.py:81)."""
    _, cfg_t, _, p_t = mamba
    x = torch.tensor(_x(cfg_t, 2, 64, seed=4))
    y8, c8 = tmamba.mamba_block(p_t, cfg_t.scaled(scan_chunk=8), x)
    y64, c64 = tmamba.mamba_block(p_t, cfg_t.scaled(scan_chunk=64), x)
    _close(y8, y64.numpy(), FULL)
    _close(c8.ssm, c64.ssm.numpy(), FULL)


def test_a_nonzero_cache_matches_reference(mamba):
    cfg_j, cfg_t, p_j, p_t = mamba
    cache_j, cache_t = _cache_pair(cfg_t, 2, seed=5)
    x = _x(cfg_t, 2, 20, seed=6)
    y_j, c_j = jmamba.mamba_block(p_j, cfg_j, jnp.asarray(x), cache_j)
    y_t, c_t = tmamba.mamba_block(p_t, cfg_t, torch.tensor(x), cache_t)
    _close(y_t, y_j, FULL)
    _close(c_t.conv, c_j.conv, FULL)
    _close(c_t.ssm, c_j.ssm, FULL)
    # one decode step from it, in both
    x1 = _x(cfg_t, 2, 1, seed=7)
    d_j, _ = jmamba.mamba_decode_step(p_j, cfg_j, jnp.asarray(x1), c_j)
    d_t, _ = tmamba.mamba_decode_step(p_t, cfg_t, torch.tensor(x1), c_t)
    _close(d_t, d_j, DECODE)


def test_prefill_then_decode_matches_the_whole_sequence(mamba):
    """A 24-token prefill from zeros, then 8 one-token steps, each carrying
    the MambaCache on, against the block over all 32 tokens at once."""
    _, cfg_t, _, p_t = mamba
    x = torch.tensor(_x(cfg_t, 2, 32, seed=8))
    whole, final = tmamba.mamba_block(p_t, cfg_t, x)
    y, cache = tmamba.mamba_block(p_t, cfg_t, x[:, :24],
                                  MambaCache.zeros(2, cfg_t, torch.float32,
                                                   "cpu"))
    _close(y, whole[:, :24].numpy(), DECODE)
    for t in range(24, 32):
        y, cache = tmamba.mamba_decode_step(p_t, cfg_t, x[:, t:t + 1], cache)
        _close(y, whole[:, t:t + 1].numpy(), DECODE)
    _close(cache.ssm, final.ssm.numpy(), DECODE)
    _close(cache.conv, final.conv.numpy(), DECODE)


def test_scan_equals_the_sequential_recurrence():
    """The chunk's Hillis-Steele scan: h_t = A_t h_0 + B_t of the
    recurrence h_t = a_t h_{t-1} + b_t, in float64, at a length that is
    no power of two."""
    rng = np.random.default_rng(9)
    a = torch.tensor(rng.uniform(0.1, 1.0, (2, 13, 3, 4)))
    b = torch.tensor(rng.normal(0, 1, (2, 13, 3, 4)))
    h0 = torch.tensor(rng.normal(0, 1, (2, 3, 4)))
    At, Bt = tmamba._scan_chunk(a.clone(), b.clone())
    h = h0
    for t in range(13):
        h = a[:, t] * h + b[:, t]
        torch.testing.assert_close(At[:, t] * h0 + Bt[:, t], h,
                                   rtol=1e-12, atol=1e-12)


def test_ssm_scan_bf16_lever_matches_reference(mamba):
    """ssm_scan_bf16: dA and dBu scanned in bfloat16, the state in float32,
    as the reference honours it; held to the reference's lever at the
    lever's own tolerance against float32 (test_model_parts.py:175)."""
    cfg_j, cfg_t, p_j, p_t = mamba
    cfg_j, cfg_t = (c.scaled(ssm_scan_bf16=True) for c in (cfg_j, cfg_t))
    x = _x(cfg_t, 2, 64, seed=10)
    y_j, _ = jmamba.mamba_block(p_j, cfg_j, jnp.asarray(x))
    y_t, c_t = tmamba.mamba_block(p_t, cfg_t, torch.tensor(x))
    _close(y_t, y_j, BF16_LEVER)
    y32, _ = tmamba.mamba_block(p_t, cfg_t.scaled(ssm_scan_bf16=False),
                                torch.tensor(x))
    _close(y_t, y32.numpy(), BF16_LEVER)
    assert c_t.ssm.dtype == torch.float32


def test_mamba_leaves_and_cache_types():
    """Under param_dtype bfloat16 the bridge gives the projections and the
    conv in bfloat16, A_log, D and dt_bias in float32, as the reference's
    init does; the port's own init agrees, and MambaCache.zeros holds the
    conv state in the activation type and the SSM state in float32."""
    cfg_j = jget(ARCH).reduced().scaled(param_dtype="bfloat16")
    cfg_t = tget(ARCH).reduced().scaled(param_dtype="bfloat16")
    values, _ = jm.split(jm.init_model(cfg_j, jax.random.PRNGKey(0)))
    ref_mix = values["groups"][0]["mix"]
    params = model_params_from_reference(
        jax.tree_util.tree_map(np.asarray, values), cfg_t, "cpu")
    own = tmamba.init_mamba(torch.Generator().manual_seed(0), cfg_t,
                            torch.bfloat16, "cpu")
    for tree in (params["layers"][0]["mix"], own):
        assert sorted(tree) == sorted(ref_mix)
        for name, leaf in tree.items():
            want = ("float32" if name in ("A_log", "D", "dt_bias")
                    else "bfloat16")
            assert str(ref_mix[name].dtype) == want, name
            assert leaf.dtype == getattr(torch, want), name
            assert tuple(leaf.shape) == tuple(ref_mix[name].shape[1:]), name
    np.testing.assert_array_equal(params["layers"][0]["mix"]["A_log"].numpy(),
                                  np.asarray(ref_mix["A_log"][0]))
    np.testing.assert_allclose(own["A_log"].numpy(),
                               np.asarray(ref_mix["A_log"][0]))
    dt = torch.nn.functional.softplus(own["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 1e-1 * (1 + 1e-5)
    cache = MambaCache.zeros(3, cfg_t, torch.bfloat16, "cpu")
    jcache = jmamba.MambaCache.zeros(3, cfg_j, jnp.bfloat16)
    assert cache.conv.dtype == torch.bfloat16
    assert cache.ssm.dtype == torch.float32
    assert tuple(cache.conv.shape) == jcache.conv.shape
    assert tuple(cache.ssm.shape) == jcache.ssm.shape
