"""Why the rwkv6_scan kernel's prefill form multiplies in 3xTF32: on the
CPU, the chunked WKV form with each of its four products rounded as the
kernel's tensor-core route rounds it, against the chunked form in float64.

The kernel forms att = r_dec k_dec^T, y = att v + r_dec S_0 and
S' = diag(W_c) S_0 + k_tail^T v on mma.sync TF32 as 3xTF32, every operand
split once into big and small TF32 halves, att split again where it is
the A operand of att v, and the bonus r.u.k put on att's diagonal so that
att v adds it (``repro_torch.kernels.tf32`` emulates the rounding). The
reference's tolerance for the scan is 1e-3 (tests/kernels/test_kernels.py:
138-139); plain 1xTF32 is reported beside it, and the emulation with
subnormal operands flushed to zero shows the clamp case does not depend on
what the tensor cores do with them:

    PYTHONPATH=src python tests/test_torch_rwkv_tf32.py
"""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from repro_torch.kernels.rwkv6_scan import ref  # noqa: E402
from repro_torch.kernels.tf32 import mm_1xtf32, mm_3xtf32  # noqa: E402

TOL = 1e-3   # tests/kernels/test_kernels.py:138-139
# (B, S, H, hs, chunk, (w_lo, w_hi)): the prefill shape's head size and
# chunk, decays strong enough that the clamp at e^-60 bites, head size 16
# at chunk 16, and a chunk of 7 (padded inside the kernel's tile) at an S
# that is not a multiple of it
CASES = {
    "hs64-chunk64": (1, 128, 2, 64, 64, (0.7, 0.999)),
    "clamp": (1, 128, 2, 64, 64, (0.02, 0.5)),
    "hs16-chunk16": (2, 64, 3, 16, 16, (0.7, 0.999)),
    "chunk7": (2, 45, 2, 32, 7, (0.6, 0.999)),
}


def scan(r, k, v, w, u, s0, chunk, mm):
    """The chunked form (``ref.rwkv6_scan_chunked``) with its products
    formed by ``mm`` on (B, H, ., .) matrices as the kernel orders them;
    float32 elsewhere. ``mm=None``: float64 throughout."""
    if mm is None:
        r, k, v, w, u, s0 = (a.double() for a in (r, k, v, w, u, s0))
        mm = torch.matmul
    B, S, H, hs = r.shape
    pad = (-S) % chunk
    if pad:
        z = lambda a, fill=0.0: torch.cat(
            [a, a.new_full((B, pad, H, hs), fill)], dim=1)
        r, k, v, w = z(r), z(k), z(v), z(w, 1.0)
    heads = lambda a: a.permute(0, 2, 1, 3)            # (B, H, c, hs)
    lower = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool), -1)
    eye = torch.eye(chunk, dtype=torch.bool)
    state = s0.to(r.dtype)
    ys = []
    for c0 in range(0, S + pad, chunk):
        rr, kk, vv, ww = (heads(a[:, c0:c0 + chunk]) for a in (r, k, v, w))
        logw = torch.log(ww)
        cum = torch.cumsum(logw, dim=2)
        r_dec = rr * torch.exp(cum - logw)
        k_dec = kk * torch.exp(-torch.clamp(cum, -ref.CLAMP, 0.0))
        bonus = (rr * u[None, :, None] * kk).sum(-1)        # (B, H, c)
        att = mm(r_dec, k_dec.transpose(-1, -2))
        att = torch.where(lower, att, torch.where(
            eye, torch.diag_embed(bonus), torch.zeros_like(att)))
        ys.append(mm(r_dec, state) + mm(att, vv))
        end = cum[:, :, -1:]
        k_tail = kk * torch.exp(end - cum)
        state = (torch.exp(end[:, :, 0])[..., None] * state
                 + mm(k_tail.transpose(-1, -2), vv))
    y = torch.cat(ys, dim=2).permute(0, 2, 1, 3)[:, :S]
    return y, state


def inputs(case, seed):
    B, S, H, hs, chunk, (lo, hi) = CASES[case]
    rng = np.random.default_rng(seed)
    r, k, v = (torch.tensor(rng.normal(0, 1, (B, S, H, hs)),
                            dtype=torch.float32) for _ in range(3))
    w = torch.tensor(rng.uniform(lo, hi, (B, S, H, hs)), dtype=torch.float32)
    u = torch.tensor(rng.normal(0, 0.5, (H, hs)), dtype=torch.float32)
    s0 = torch.tensor(rng.normal(0, 0.5, (B, H, hs, hs)), dtype=torch.float32)
    return (r, k, v, w, u, s0), chunk


def errors(case, seed, flush=False):
    """Largest |error| against the chunked form in float64, and that over
    atol + rtol |want|, of y and the final state with the products in
    3xTF32 and in 1xTF32."""
    args, chunk = inputs(case, seed)
    want = torch.cat([t.flatten() for t in scan(*args, chunk, None)])
    out = {}
    for name, mm in (("3xtf32", mm_3xtf32), ("1xtf32", mm_1xtf32)):
        got = torch.cat([t.flatten() for t in scan(
            *args, chunk, lambda a, b: mm(a, b, flush=flush))]).double()
        err = (got - want).abs()
        out[name] = (err.max().item(),
                     (err / (TOL + TOL * want.abs())).max().item())
    return out


def test_the_emulation_in_float64_is_the_plain_version():
    """With float64 products the emulated order is the chunked form."""
    args, chunk = inputs("chunk7", 0)
    y, s = scan(*args, chunk, None)
    yr, sr = ref.rwkv6_scan_chunked(*(a.double() for a in args), chunk,
                                    compute_dtype=torch.float64)
    assert torch.allclose(y, yr, rtol=1e-12, atol=1e-12)
    assert torch.allclose(s, sr, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("flush", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_3xtf32_scan_is_within_the_reference_tolerance(case, flush):
    err, over = errors(case, 0, flush)["3xtf32"]
    assert over <= 1.0, (err, over)


@settings(max_examples=8, deadline=None, database=None)
@given(seed=st.integers(0, 2 ** 32 - 1), case=st.sampled_from(list(CASES)))
def test_3xtf32_scan_holds_for_any_seed(seed, case):
    err, over = errors(case, seed)["3xtf32"]
    assert over <= 1.0, (err, over)


@pytest.mark.parametrize("case", list(CASES))
def test_1xtf32_lands_farther_than_3xtf32(case):
    """The figure PERF.md reports for 1xTF32 (not held to a limit): only
    its order against 3xTF32's is asserted."""
    e = errors(case, 0)
    print(f"{case}: |err| 3xTF32 {e['3xtf32'][0]:.3g}, "
          f"1xTF32 {e['1xtf32'][0]:.3g} ({e['1xtf32'][1]:.3g} x tol)")
    assert e["3xtf32"][0] < e["1xtf32"][0]


if __name__ == "__main__":
    for case in CASES:
        for seed in range(4):
            e = errors(case, seed)
            print(f"{case} seed {seed}: " + ", ".join(
                f"{k} max |err| {a:.3e} ({b:.3g} x tol)"
                for k, (a, b) in e.items()))
