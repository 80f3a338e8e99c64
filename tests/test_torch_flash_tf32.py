"""Why the float32 flash_attention kernel multiplies in 3xTF32, and why it
starts every chain of tensor-core products from zero: on the CPU, causal
attention with every product rounded as the kernel's tensor-core route
rounds it (and, below, summed as mma.sync sums it), against float64.

The kernel splits each float32 operand x into big = cvt.rna.tf32.f32(x) and
small = cvt.rna.tf32.f32(x - big) and forms each product as small.big +
big.small + big.big in float32 (three mma.sync TF32 products, the small
terms first). ``repro_torch.kernels.tf32`` does that rounding in torch (10
mantissa bits, to nearest, ties away from zero), and the products of TF32
values, exact in float32, are summed by torch's float32 matmul. The reference's
tolerance for float32 attention is 2e-4 (tests/kernels/test_kernels.py:10);
plain 1xTF32 (one product of the two bigs) is reported beside it:

    PYTHONPATH=src python tests/test_torch_flash_tf32.py
"""
import math

import numpy as np
import pytest
from hypothesis import example, given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from repro_torch.kernels.tf32 import (mm_1xtf32, mm_3xtf32, split,  # noqa: E402
                                      tf32_rna)

TOL = 2e-4          # tests/kernels/test_kernels.py:10-11
S, DH = 128, 128    # the reduced attention: one head, causal


def attention(q, k, v, mm):
    """Causal attention as the kernel orders it: scores, the unnormalised
    probabilities exp(s - max) in the working type, p.v, then / sum."""
    s = mm(q, k.T) / math.sqrt(q.shape[1])
    live = torch.ones(S, S, dtype=torch.bool).tril()
    s = torch.where(live, s, torch.tensor(-1e30, dtype=s.dtype))
    p = torch.exp(s - s.max(dim=1, keepdim=True).values)
    return mm(p, v) / p.sum(dim=1, keepdim=True)


def inputs(seed: int, q_scale: float):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.tensor(rng.normal(0, 1, (S, DH)), dtype=torch.float32)
               for _ in range(3))
    return q_scale * q, k, v


def errors(seed: int, q_scale: float):
    """Largest |error| against float64, and over atol + rtol |want| (the
    reference's test), of attention in 3xTF32 and in 1xTF32."""
    q, k, v = inputs(seed, q_scale)
    want = attention(q.double(), k.double(), v.double(),
                     lambda a, b: a @ b)
    out = {}
    for name, mm in (("3xtf32", mm_3xtf32), ("1xtf32", mm_1xtf32)):
        err = (attention(q, k, v, mm).double() - want).abs()
        out[name] = (err.max().item(),
                     (err / (TOL + TOL * want.abs())).max().item())
    return out


def test_tf32_rna_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                     # TF32's ulp at 1
    x = torch.tensor([one + ulp / 2,     # a tie: away from zero
                      -(one + ulp / 2),
                      one + ulp / 2 - 2.0 ** -23,   # just below: down
                      one + 3 * ulp / 2,            # a tie above an odd
                      one + ulp,                    # already TF32
                      2.0 ** -136,                  # subnormal, kept
                      2.0 ** -140],                 # below half its ulp
                     dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp,
                         one + ulp, 2.0 ** -136, 0.0], dtype=torch.float32)
    assert torch.equal(tf32_rna(x), want)
    assert not (tf32_rna(x).view(torch.int32) & 0x1FFF).any()


@settings(max_examples=200, deadline=None, database=None)
@given(st.floats(min_value=-2.0 ** 100, max_value=2.0 ** 100, allow_nan=False,
                 allow_subnormal=False, width=32))
@example(x=7.2339901005025365e-37)   # about 2^-121: x - big is subnormal
@example(x=1.0 + 2.0 ** -11 + 2.0 ** -22)
def test_big_plus_small_keeps_22_bits(x):
    t = torch.tensor([x], dtype=torch.float32)
    big, small = split(t)
    assert not (big.view(torch.int32) & 0x1FFF).any()
    assert not (small.view(torch.int32) & 0x1FFF).any()
    # x - big is exact (Sterbenz), and small rounds it to nearest at half
    # its own TF32 ulp: at most 2^-11 of x - big, so 2^-22 of x. Where
    # x - big is subnormal (|x| below about 2^-115), small keeps only
    # multiples of 2^-136 (the 13 low bits of a subnormal cleared), so the
    # error is at most 2^-137 instead.
    assert abs((big.double() + small.double() - x).item()) <= \
        max(abs(x) * 2.0 ** -22, 2.0 ** -137)


@settings(max_examples=12, deadline=None, database=None)
@given(seed=st.integers(0, 2 ** 32 - 1), q_scale=st.sampled_from([1.0, 8.0]))
def test_3xtf32_attention_is_within_the_reference_tolerance(seed, q_scale):
    err, over = errors(seed, q_scale)["3xtf32"]
    assert over <= 1.0, (err, over)


@pytest.mark.parametrize("q_scale", [1.0, 8.0])
def test_1xtf32_lands_farther_than_3xtf32(q_scale):
    """The figure PERF.md reports for 1xTF32 (not held to a limit): only
    its order against 3xTF32's is asserted."""
    e = errors(0, q_scale)
    print(f"q x {q_scale:g}: |err| 3xTF32 {e['3xtf32'][0]:.3g}, "
          f"1xTF32 {e['1xtf32'][0]:.3g} ({e['1xtf32'][1]:.3g} x tol)")
    assert e["3xtf32"][0] < e["1xtf32"][0]


# ---- the tensor cores' float32 sums ---------------------------------------
# mma.sync TF32 sums d = c + the 8 products of a k step thus (mma_probe.py,
# fact 4, on an H100): every term aligned to the largest with GUARD bits
# below its last place, each cut toward zero, and the sum cut toward zero
# to float32. ``truncating_mma`` does that; ``kernel_attention`` runs one
# head through flash_attention.cu's float32 loop (key tiles of 32, q.k in
# k steps of 8 columns, p.v in k steps of 8 keys, three products a step)
# with its sums kept in the accumulators over all of dh and every key
# (``fresh=False``) or started from zero for each CHAIN columns of dh and
# each key tile and added in float32 (``fresh=True``, the kernel's order).
# chip_smoke.py holds the kernel on the card to F64_RATIO times plain
# float32's error against float64; the emulation is held to the same.
GUARD = 2
BK = 32
CHAIN = 32
F64_RATIO = 2.0


def truncating_mma(c: torch.Tensor, prods: torch.Tensor) -> torch.Tensor:
    """c (...) float32 plus prods (..., k), exact float64 products."""
    terms = torch.cat([c.double()[..., None], prods], -1)
    big = terms.abs().amax(-1, keepdim=True)
    _, e = torch.frexp(big)
    step = torch.ldexp(torch.ones_like(big), e - 24 - GUARD)
    terms = torch.where(big > 0, torch.trunc(terms / step) * step, terms)
    total = terms.sum(-1)
    out = total.float()
    return torch.where(out.double().abs() > total.abs(),
                       torch.nextafter(out, torch.zeros_like(out)), out)


def _mma3(c, a_big, a_small, b_big, b_small):
    """c + a.b as three truncating products, the small terms first; a
    (M, 8), b (8, N)."""
    for x, y in ((a_small, b_big), (a_big, b_small), (a_big, b_big)):
        c = truncating_mma(c, x.double()[:, None, :] * y.double().T[None])
    return c


def kernel_attention(q, k, v, fresh: bool) -> torch.Tensor:
    """One causal head, q/k/v (n, dh) float32, as the kernel sums it."""
    n, dh = q.shape
    qb, qs = split(q)
    kb, ks = split(k)
    vb, vs = split(v)
    scale_log2 = torch.tensor(math.log2(math.e) / math.sqrt(dh),
                              dtype=torch.float32)
    acc = torch.zeros(n, dh)
    m = torch.full((n,), -1e30)
    denom = torch.zeros(n)
    for k0 in range(0, n, BK):
        keys = slice(k0, k0 + BK)
        s = torch.zeros(n, BK)
        for c in range(0, dh, CHAIN):
            part = torch.zeros(n, BK) if fresh else s
            for c8 in range(c, c + CHAIN, 8):
                col = slice(c8, c8 + 8)
                part = _mma3(part, qb[:, col], qs[:, col], kb[keys, col].T,
                             ks[keys, col].T)
            s = s + part if fresh else part
        x = s * scale_log2
        dead = torch.arange(k0, k0 + BK)[None, :] > torch.arange(n)[:, None]
        x = torch.where(dead, torch.tensor(-1e30), x)
        new_m = torch.maximum(m, x.amax(-1))
        corr = torch.exp2((m - new_m).double()).float()
        p = torch.exp2((x - new_m[:, None]).double()).float()
        m = new_m
        denom = denom * corr + p.sum(-1)
        acc = acc * corr[:, None]
        pb, ps = split(p)
        part = torch.zeros(n, dh) if fresh else acc
        for j in range(0, BK, 8):
            rows = slice(k0 + j, k0 + j + 8)
            part = _mma3(part, pb[:, j:j + 8], ps[:, j:j + 8], vb[rows],
                         vs[rows])
        acc = acc + part if fresh else part
    return acc / denom[:, None]


def sum_errors(n: int, seed: int = 0) -> dict:
    """rms error against float64 over the float64 output's rms: plain
    float32, the kernel's loop with long sums, and with fresh chains."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.tensor(rng.normal(0, 1, (n, DH)), dtype=torch.float32)
               for _ in range(3))
    live = torch.ones(n, n, dtype=torch.bool).tril()

    def plain(q, k, v):
        s = torch.where(live, q @ k.T / math.sqrt(DH),
                        torch.tensor(-1e30, dtype=q.dtype))
        return torch.softmax(s, -1) @ v

    want = plain(q.double(), k.double(), v.double())
    rms = lambda t: float(t.pow(2).mean().sqrt())
    rel = lambda t: rms(t.double() - want) / rms(want)
    return {"plain_float32": rel(plain(q, k, v)),
            "long_sums": rel(kernel_attention(q, k, v, fresh=False)),
            "fresh_chains": rel(kernel_attention(q, k, v, fresh=True))}


@pytest.mark.parametrize("c,prods,want", [
    (1.0, (0.75,), 0.0), (1.0, (1.5,), 1.0), (1.0, (-0.1875,), 0.0),
    (1.0, (0.25,) * 8, 2.0), (1.0, (0.125,) * 8, 0.0)])
def test_truncating_mma_gives_the_probe_readings(c, prods, want):
    """mma_probe.py's cases (products in units of c's ulp, 2^-23), each
    read on an H100 as ``want`` ulps above c."""
    ulp = 2.0 ** -23
    d = truncating_mma(torch.tensor([c]),
                       torch.tensor([[x * ulp for x in prods]],
                                    dtype=torch.float64))
    assert (d.item() - c) / ulp == want


def test_fresh_chains_round_as_float32_does():
    """The kernel's loop with truncating sums: kept over all of dh and
    every key, it drifts past F64_RATIO times plain float32's error
    against float64; started from zero for each CHAIN columns and each key
    tile and added in float32, it stays within that."""
    e = sum_errors(256)
    assert e["long_sums"] > F64_RATIO * e["plain_float32"], e
    assert e["fresh_chains"] <= F64_RATIO * e["plain_float32"], e


if __name__ == "__main__":
    for q_scale in (1.0, 8.0):
        for seed in range(4):
            e = errors(seed, q_scale)
            print(f"S={S} dh={DH} q x {q_scale:g} seed {seed}: "
                  + ", ".join(f"{k} max |err| {a:.3e} ({b:.3g} x tol)"
                              for k, (a, b) in e.items()))
    for n in (256, 512, 1024):
        e = sum_errors(n)
        print(f"truncating sums, one causal head, S={n} dh={DH}, rms error "
              f"against float64 over its rms: " + ", ".join(
                  f"{k} {x:.3e} ({x / e['plain_float32']:.2f} x plain)"
                  for k, x in e.items()), flush=True)
