"""One config served twice through the step functions, the kernel route
(``use_kernel=None``) against the plain route (``use_kernel=False``), with
the kernels' launches counted: the check that puts each model family's
wiring (attention, RWKV, MoE, Mamba, the hybrid, the vision frontend)
through both attention kernels and the RWKV scan on the card.

    from repro_torch.launch.routes import check_routes
    rec = check_routes("jamba-1.5-large-398b", device="cuda")

On CUDA tensors the kernel route launches flash_attention once per
attention layer in the prefill, decode_attention once per attention layer
in each decode step and rwkv6_scan once per RWKV layer in both; on CPU
tensors it runs the kernels' plain versions and launches nothing. The plain
route launches nothing and decodes the kernel route's own greedy tokens,
so both see the same inputs. Tolerances are those of
tests/models/test_model_parts.py: 2e-4 for the prefill logits (:25), 2e-3
for each decode step (:40), 3e-3 once a sliding window wraps its ring
buffer (:61).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs import get_config
from ..kernels.decode_attention import ops as dops
from ..kernels.flash_attention import ops as fops
from ..kernels.rwkv6_scan import ops as sops
from ..models import init_model
from ..models.transformer import layer_kinds
from .steps import make_decode_step, make_prefill_step

TOL = {"prefill": 2e-4, "decode": 2e-3, "ring": 3e-3}
BATCH, PROMPT, STEPS = 2, 40, 8     # rows, prompt tokens, decode steps
KERNEL_OPS = (fops, dops, sops)
# mixtral's 4096-token window cut so that a short run wraps its ring buffer
RING_WINDOW = 32


def _launches() -> dict:
    return {k: n for ops in KERNEL_OPS for k, n in ops.LAUNCHES.items()}


def _serve(cfg, params, batch, use_kernel: Optional[bool], feed=None):
    """A prefill of ``batch`` and STEPS greedy decode steps (or steps fed
    the tokens ``feed`` lists). Launch counts are zeroed first. Returns
    (logits (STEPS + 1, B, V), launches of the prefill, launches in all)."""
    for ops in KERNEL_OPS:
        ops.reset_launches()
    S = batch["tokens"].shape[1]
    logits, caches = make_prefill_step(cfg, S + STEPS, use_kernel)(
        params, batch)
    prefill_launches = _launches()
    decode = make_decode_step(cfg, use_kernel)
    out = [logits]
    for i in range(STEPS):
        tok = (feed[i] if feed is not None
               else out[-1].argmax(-1, keepdim=True))
        logits, caches = decode(params, caches, tok, S + i)
        out.append(logits)
    return torch.stack(out), prefill_launches, _launches()


def _agreement(got: torch.Tensor, want: torch.Tensor, tol: float) -> dict:
    """numpy's allclose at rtol = atol = tol, with its margin: the largest
    |got - want| / (tol + tol |want|) must be at most 1."""
    got, want = got.double(), want.double()
    err = (got - want).abs()
    return {"max_abs_err": float(err.max()),
            "max_err_over_tol": float((err / (tol + tol * want.abs())).max()),
            "finite": bool(torch.isfinite(got).all()), "tol": tol}


def check_routes(arch: str, seed: int = 0, device="cuda") -> dict:
    """``arch`` at reduced() size (its window cut to RING_WINDOW if it has
    one, so that the ring buffer wraps), random weights and BATCH prompts
    of PROMPT tokens from ``seed``, STEPS decode steps: the kernel route
    against the plain route. Raises AssertionError on a launch count other
    than the one expected, a launch on the plain route, or logits that are
    not finite or part beyond TOL; returns the record."""
    device = torch.device(device)
    cfg = get_config(arch).reduced()
    if cfg.window:
        cfg = cfg.scaled(window=RING_WINDOW)
    ring = bool(cfg.window) and cfg.window < PROMPT + STEPS
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_model(cfg, gen, device=device)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                                     generator=gen, device=device)}
    if cfg.frontend == "vision":
        batch["frontend_embeds"] = torch.randn(
            (BATCH, cfg.n_frontend_tokens, cfg.d_frontend), generator=gen,
            device=device)
    kern, pre, total = _serve(cfg, params, batch, None)
    kinds = [blk for blk, _ in layer_kinds(cfg)]
    n_attn, n_rwkv = kinds.count("attn"), kinds.count("rwkv")
    on_card = device.type == "cuda"
    want_pre = {"flash_attention": n_attn * on_card, "decode_attention": 0,
                "rwkv6_scan": n_rwkv * on_card}
    want = {"flash_attention": n_attn * on_card,
            "decode_attention": n_attn * STEPS * on_card,
            "rwkv6_scan": n_rwkv * (1 + STEPS) * on_card}
    if pre != want_pre or total != want:
        raise AssertionError(f"{arch}: launches {pre} in the prefill, "
                             f"{total} in all; expected {want_pre}, {want}")
    feed = [k.argmax(-1, keepdim=True) for k in kern[:-1]]
    plain, _, plain_total = _serve(cfg, params, batch, False, feed)
    if any(plain_total.values()):
        raise AssertionError(f"{arch}: the plain route launched "
                             f"{plain_total}")
    rec = {"arch": arch, "n_layers": cfg.n_layers, "window": cfg.window,
           "frontend": cfg.frontend,
           "kinds": sorted({f"{b}+{f}" for b, f in layer_kinds(cfg)}),
           "launches": total,
           "prefill": _agreement(kern[0], plain[0], TOL["prefill"]),
           "decode": _agreement(kern[1:], plain[1:],
                                TOL["ring" if ring else "decode"])}
    for part in ("prefill", "decode"):
        if not (rec[part]["finite"] and rec[part]["max_err_over_tol"] <= 1):
            raise AssertionError(f"{arch}: the kernel route's {part} logits "
                                 f"part from the plain route's: {rec[part]}")
    return rec
