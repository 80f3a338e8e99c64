#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--tenants 64] [--ticks 4]

Phases, one JSON object per line:

1. setup   — torch and CUDA versions, the card's name and power limit.
2. build   — compiles the three CUDA kernel sources of the checkout
             (alloc_objective, flash_attention, decode_attention) with nvcc
             into build/repro_torch_kernels/, one nvcc each, all started
             together, and times it.
3. kernels — every alloc_objective entry (fleet value+gradient, fleet
             value-only, single-problem) on the card at the shapes the
             replay gives it, against its plain PyTorch version on the same
             inputs (rtol = atol = 1e-4); the kernel's and the plain
             version's device time per call (calls back to back in a CUDA
             graph, between CUDA events; the kernel's launch alone, its
             wrapper's (B, 8) scalar row built beforehand) and wall time per
             call of the wrappers (CUDA events around calls from the host);
             the least time the card could take (bytes at 3.35 TB/s or
             float32 operations at 67 TFLOP/s, whichever is larger).
4. replay  — the port's main path through its entry point:
             ``replay_fleet(make_cloud_catalog(), tenants,
             replay_mode="batched", run_ca_baseline=False)`` with 64 tenants
             over the full 1880-type catalog, 4 ticks (1 cold solve_fleet,
             3 warm solve_fleet_step), launch counts zeroed just before and
             read just after; then the same replay with hot_loop="ref" (the
             plain PyTorch eq. (1)) on the card, which the kernel replay
             must match to the solver's tolerance (per tenant rtol 0.05,
             fleet aggregate 2e-2, identical per-tick satisfaction flags).
5. profile — torch.profiler over one warm tick of the same fleet: device
             busy share and the kernels that take the time.
6. attention — the flash_attention and decode_attention kernels on the card
             against their plain PyTorch versions (on the float32 values of
             the same inputs; rtol = atol = 2e-4 in float32, 2e-2 in
             bfloat16), at qwen1.5-4b's serving shapes and at shapes that
             cover GQA, the sliding window, a ragged S, part-filled and
             ring-buffer validity and bfloat16; for each: device and wall ms
             of the kernel, of its plain version and of
             torch.nn.functional.scaled_dot_product_attention on the same
             inputs (timed only, on no path of the port), each timed over
             rotating copies of its inputs so that every call finds the L2
             cache cold, as a layer of the served model does; the least time
             the card could take (bytes at 3.35 TB/s or operations at the
             input type's peak rate, whichever is larger).
7. serve   — the second main path: qwen1.5-4b at full width and depth
             (40 layers, d_model 2560, float32, random weights from --seed)
             through ``init_model``, ``make_prefill_step`` and
             ``make_decode_step``: 8 prompts of 1024 tokens, then 32
             greedy decode steps; launch counts zeroed just before
             and read just after (one flash launch per layer per prefill,
             one decode launch per layer per step). Then (a) the same tokens
             through the plain path (use_kernel=False) on the card,
             teacher-forced with the kernel run's tokens, and (b) forward
             over prompt + generated tokens: every step's logits must agree
             at rtol = atol = 2e-3. Prefill ms, decode ms per token,
             tokens/s, peak memory, and the device busy share and top
             kernels of one decode step and of one prefill (torch.profiler,
             each window opened by a primer of spin kernels that the sums
             leave out).

Then the ``{"kernels": [...]}`` line, the nvidia-smi line, and the last line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
without a CUDA device the script exits 2 and prints no result.
"""
from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
F32_FLOPS_PER_S = 67e12       # H100 SXM float32 rate outside tensor cores
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core rate
L2_BYTES = 50e6               # H100 L2 cache
PRIMER = 32                   # spin kernels that open a profiler window
RTOL = ATOL = 1e-4            # kernel vs plain (tests/kernels/test_kernels.py:32)
TENANT_RTOL, FLEET_RTOL = 0.05, 2e-2   # tests/fleet/test_solve_fleet.py:113-117
# attention kernel vs plain (tests/kernels/test_kernels.py:10-11)
ATTN_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
# served logits vs plain path and forward (tests/models/test_model_parts.py:40)
SERVE_TOL = 2e-3
SERVE_ARCH = "qwen1.5-4b"
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 8, 1024, 32
REPLACES = {
    "alloc_objective_fleet": "src/repro/kernels/alloc_objective/kernel.py:136",
    "alloc_objective_fleet_value":
        "src/repro/kernels/alloc_objective/kernel.py:136",
    "alloc_objective": "src/repro/kernels/alloc_objective/kernel.py:102",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:82",
    "decode_attention": "src/repro/kernels/decode_attention/kernel.py:56",
}
# (B, S, H, G, dh, window, dtype): qwen1.5-4b's prefill shape first (timed
# for the kernels line), then GQA with nemotron-4-15b's heads, a sliding
# window, a ragged S and bfloat16
FLASH_CASES = {
    "qwen-prefill": (8, 1024, 20, 20, 128, 0, "float32"),
    "gqa-48/8": (2, 1024, 48, 8, 128, 0, "float32"),
    "window-256": (2, 1024, 20, 20, 128, 256, "float32"),
    "odd-S-1000": (2, 1000, 20, 20, 128, 0, "float32"),
    "bf16": (8, 1024, 20, 20, 128, 0, "bfloat16"),
}
# (B, S_max, H, G, dh, valid, dtype); valid is "last" (every slot, the
# serving run's last step), "prefix:n" (slots < n: a part-filled cache or a
# ring buffer before its wrap) or "band:n" (the n slots before S_max: a
# sliding window)
DECODE_CASES = {
    "qwen-decode": (8, 1056, 20, 20, 128, "last", "float32"),
    "part-filled": (8, 1056, 20, 20, 128, "prefix:700", "float32"),
    "ring-250": (8, 250, 20, 20, 128, "prefix:181", "float32"),
    "window-256": (8, 1056, 20, 20, 128, "band:256", "float32"),
    "gqa-48/8": (8, 1056, 48, 8, 128, "last", "float32"),
    "bf16": (8, 1056, 20, 20, 128, "last", "bfloat16"),
}
# base demands of examples/fleet_replay.py's four tenants, by trace kind
BASES = {"diurnal": [8, 16, 4, 100.0], "flash_crowd": [4, 8, 2, 50.0],
         "ramp": [6, 24, 3, 150.0], "weekly": [16, 64, 6, 300.0]}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, reps: int = 10, replays: int = 5) -> float:
    """Device time per call of ``fn()``, back to back: ``reps`` calls
    captured into one CUDA graph and the graph replayed between CUDA events,
    so no host time lies between the launches. (Not torch.profiler's
    per-kernel sums: the profiler misses the first launches of a window.)"""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * reps)


def call_ms(fn, reps: int = 50) -> float:
    """Mean wall time per call of ``fn()`` between CUDA events: the device
    time plus whatever host time the launches leave the device idle."""
    import torch
    for _ in range(5):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timings(kern, plain, launch=None) -> dict:
    """The kernel and its plain version, each by device time (back to back
    in a CUDA graph) and by wall time per call (host included). ``launch``,
    where given, launches the kernel alone (no operand set-up on the card)
    and is what the device time is taken of."""
    return {"ms": device_ms(launch or kern), "plain_ms": device_ms(plain),
            "call_ms": call_ms(kern), "plain_call_ms": call_ms(plain)}


def profile_once(fn, top_n: int = 6) -> dict:
    """Run ``fn()`` once under torch.profiler: wall ms (host clock to a
    synchronize), the summed device time of the CUDA kernels, the busy
    share, the launch count and the kernels that take the most time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # a primer of PRIMER short spin kernels, left out of the sums: the
        # profiler has been seen to miss the first launches of a window
        for _ in range(PRIMER):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - s0) * 1e3
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")]
    primer_seen = sum(e.count for e in events if "spin_kernel" in e.key)
    events = [e for e in events if "spin_kernel" not in e.key]
    busy_ms = sum(e.device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.device_time_total)[:top_n]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "primer_launches_seen": [primer_seen, PRIMER],
            "device_busy_share": busy_ms / wall_ms if wall_ms else None,
            "device_launches": sum(e.count for e in events),
            "top": [{"name": e.key[:90], "ms": e.device_time_total / 1e3,
                     "count": e.count} for e in top]}


def bound(nbytes, flops, flops_per_s) -> dict:
    """The least time the card could take: bytes at the memory rate or
    operations at the peak rate, whichever is longer."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def make_tenants(TenantSpec, make_trace, n: int, ticks: int, seed: int):
    """``n`` tenants cycling over the four trace kinds of
    examples/fleet_replay.py, base demands drawn around that example's."""
    import numpy as np
    rng = np.random.default_rng(seed)
    kinds = list(BASES)
    out = []
    for i in range(n):
        kind = kinds[i % len(kinds)]
        base = np.asarray(BASES[kind]) * rng.uniform(0.5, 2.0, size=4)
        out.append(TenantSpec(
            name=f"{kind}-{i}",
            trace=make_trace(kind, base, ticks, seed=seed * 1000 + i),
            delta_max=16.0 if kind == "flash_crowd" else 8.0))
    return out


def kernel_bound(B, T, n, m, p, with_grad):
    """(bound_ms, bound_by, bytes, flops): each input read once, each output
    written once; flops of the two passes over n."""
    elems = (B * T * n + B * m * n + B * p * n + B * n + B * m + B * 8
             + B * T + (B * T * n if with_grad else 0))
    flops = B * T * (2 * (m + p + 1) * n
                     + (2 * (m + p) * n if with_grad else 0))
    t_bytes = 4 * elems / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", 4 * elems, flops)


def compare(name, got, want, rtol=RTOL, atol=ATOL):
    import torch
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)}, expected "
                             f"{tuple(want.shape)}")
    err = (got - want).abs()
    over = (err / (atol + rtol * want.abs())).max().item()
    rec = {"max_abs_err": err.max().item(), "max_err_over_tol": over}
    if not over <= 1.0:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version: {rec}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    return rec


def flash_bound(B, S, H, G, dh, window, itemsize, flops_per_s) -> dict:
    """q, k, v read once and o written once; 4 dh operations (q.k and p.v)
    per live (query, key) pair, the pairs this causal (and windowed) mask
    keeps."""
    if window > 0:
        w = min(window, S)
        live = w * (w + 1) // 2 + (S - w) * w
    else:
        live = S * (S + 1) // 2
    nbytes = itemsize * (2 * B * S * H * dh + 2 * B * S * G * dh)
    return bound(nbytes, 4 * dh * live * B * H, flops_per_s)


def decode_bound(B, H, G, dh, n_valid, S, itemsize, flops_per_s) -> dict:
    """The valid cache rows of k and v, q and o once, the int32 validity;
    4 dh operations per (head, valid position)."""
    nbytes = (itemsize * (2 * B * G * n_valid * dh + 2 * B * H * dh)
              + 4 * S)
    return bound(nbytes, 4 * dh * n_valid * B * H, flops_per_s)


def rotation(sets):
    """A function that returns the next of ``sets`` on every call: timed
    calls cycle through enough copies of their inputs that each finds the
    50 MB L2 cold, as a layer of the served model finds its own weights and
    cache."""
    it = itertools.cycle(sets)
    return lambda: next(it)


def copies_for(nbytes: int) -> int:
    """Input copies so that the other copies, read in between, exceed twice
    the 50 MB L2."""
    return min(8, 2 + int(2 * L2_BYTES // max(nbytes, 1)))


def attention_checks(seed: int, dev):
    """Each attention kernel against its plain version at FLASH_CASES and
    DECODE_CASES, timed beside the plain version and SDPA over rotating
    input copies. Returns (checks, {kernel name: the record of its serving
    shape})."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.decode_attention import ref as dref
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref

    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    rand = lambda shape, dt: torch.randn(shape, generator=gen, device=dev,
                                         dtype=torch.float32).to(dt)
    rate = {"float32": F32_FLOPS_PER_S, "bfloat16": BF16_FLOPS_PER_S}
    checks, measured = [], {}
    for case, (B, S, H, G, dh, window, dtype) in FLASH_CASES.items():
        dt = getattr(torch, dtype)
        est = flash_bound(B, S, H, G, dh, window, dt.itemsize, rate[dtype])
        sets = [(rand((B, S, H, dh), dt), rand((B, S, G, dh), dt),
                 rand((B, S, G, dh), dt))
                for _ in range(copies_for(est["bytes"]))]
        q, k, v = sets[0]
        rec = compare(f"flash_attention {case}",
                      fops.flash_attention(q, k, v, window).float(),
                      fref.flash_attention_ref(q.float(), k.float(),
                                               v.float(), window),
                      ATTN_TOL[dtype], ATTN_TOL[dtype])
        mask = None
        if window > 0:
            pos = torch.arange(S, device=dev)
            mask = ((pos[None, :] <= pos[:, None])
                    & (pos[None, :] > pos[:, None] - window))
        kern_in, plain_in = rotation(sets), rotation(sets)
        lib_in = rotation([tuple(t.transpose(1, 2).contiguous() for t in st)
                           for st in sets])
        kern = lambda: fops.flash_attention(*kern_in(), window)
        plain = lambda: fref.flash_attention_ref(
            *(t.float() for t in plain_in()), window)
        library = lambda: F.scaled_dot_product_attention(
            *lib_in(), attn_mask=mask, is_causal=mask is None,
            enable_gqa=H != G)
        rec.update(name="flash_attention", case=case, dtype=dtype,
                   shape={"B": B, "S": S, "H": H, "G": G, "dh": dh,
                          "window": window}, input_copies=len(sets),
                   **timings(kern, plain), library_ms=device_ms(library),
                   library_call_ms=call_ms(library), **est)
        checks.append(rec)
        measured.setdefault("flash_attention", rec)
        del sets, q, k, v, kern_in, plain_in, lib_in
    for case, (B, S, H, G, dh, valid, dtype) in DECODE_CASES.items():
        dt = getattr(torch, dtype)
        kind, _, n = valid.partition(":")
        pos = torch.arange(S, device=dev)
        ok = (pos >= 0 if kind == "last" else pos < int(n) if kind == "prefix"
              else pos >= S - int(n))
        valid_i = ok.to(torch.int32)
        est = decode_bound(B, H, G, dh, int(ok.sum()), S, dt.itemsize,
                           rate[dtype])
        sets = [(rand((B, 1, H, dh), dt), rand((B, G, S, dh), dt),
                 rand((B, G, S, dh), dt))
                for _ in range(copies_for(est["bytes"]))]
        q, kc, vc = sets[0]
        rec = compare(f"decode_attention {case}",
                      dops.decode_attention(q, kc, vc, valid_i).float(),
                      dref.decode_attention_ref(q.float(), kc.float(),
                                                vc.float(), ok),
                      ATTN_TOL[dtype], ATTN_TOL[dtype])
        kern_in, plain_in = rotation(sets), rotation(sets)
        lib_in = rotation([(st[0].transpose(1, 2).contiguous(), st[1], st[2])
                           for st in sets])
        kern = lambda: dops.decode_attention(*kern_in(), valid_i)
        plain = lambda: dref.decode_attention_ref(
            *(t.float() for t in plain_in()), ok)
        library = lambda: F.scaled_dot_product_attention(
            *lib_in(), attn_mask=ok[None, None, None, :], enable_gqa=H != G)
        rec.update(name="decode_attention", case=case, dtype=dtype,
                   shape={"B": B, "S_max": S, "H": H, "G": G, "dh": dh,
                          "valid": valid, "n_valid": int(ok.sum())},
                   input_copies=len(sets),
                   **timings(kern, plain), library_ms=device_ms(library),
                   library_call_ms=call_ms(library), **est)
        checks.append(rec)
        measured.setdefault("decode_attention", rec)
        del sets, q, kc, vc, kern_in, plain_in, lib_in
    # a batch row's output does not depend on the other rows
    B, S, H, G, dh, _, _ = FLASH_CASES["gqa-48/8"]
    q, k, v = rand((B, S, H, dh), torch.float32), \
        rand((B, S, G, dh), torch.float32), rand((B, S, G, dh), torch.float32)
    rows_alone = torch.cat([fops.flash_attention(q[i:i + 1].contiguous(),
                                                 k[i:i + 1].contiguous(),
                                                 v[i:i + 1].contiguous())
                            for i in range(B)])
    if not torch.equal(rows_alone, fops.flash_attention(q, k, v)):
        raise AssertionError("flash_attention: a row depends on its batch")
    return checks, measured


def serve(seed: int, dev):
    """The second main path: qwen1.5-4b at full width and depth, prefill and
    greedy decode through the step functions, then the plain-path and
    teacher-forcing checks. Returns (record, launches of the main path)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.alloc_objective import ops as aops
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import forward, init_model

    def counts():
        return {**aops.LAUNCHES, **fops.LAUNCHES, **dops.LAUNCHES}

    def reset():
        for ops in (aops, fops, dops):
            ops.reset_launches()

    cfg = get_config(SERVE_ARCH)
    B, S, steps = SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS
    s_max = S + steps
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    params = init_model(cfg, gen, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            device=dev)
    prefill = make_prefill_step(cfg, s_max=s_max)
    decode = make_decode_step(cfg)
    # warm-up on a short prompt: cuBLAS handles and the kernels' libraries
    lg, caches = prefill(params, {"tokens": prompts[:, :64]})
    decode(params, caches, lg.argmax(-1, keepdim=True), 64)
    del lg, caches
    torch.cuda.synchronize()

    reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, caches = prefill(params, {"tokens": prompts})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    step_logits = [logits]
    toks = [logits.argmax(-1, keepdim=True)]
    t0 = time.perf_counter()
    for i in range(steps):
        logits, caches = decode(params, caches, toks[i], S + i)
        step_logits.append(logits)
        toks.append(logits.argmax(-1, keepdim=True))
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    want = {"flash_attention": cfg.n_layers,
            "decode_attention": cfg.n_layers * steps}
    if any(launches[k] != n for k, n in want.items()) or any(
            launches[k] for k in aops.LAUNCHES):
        raise AssertionError(f"serve launches {launches}, expected {want}")
    kern_logits = torch.stack(step_logits)            # (steps + 1, B, V)
    if not (kern_logits.shape == (steps + 1, B, cfg.vocab_size)
            and bool(torch.isfinite(kern_logits).all())):
        raise AssertionError("serve: logits of the wrong shape or not finite")

    # one decode step under the profiler: the last step again (same token,
    # same slot, so the cache is unchanged); then one more prefill
    step_prof = profile_once(
        lambda: decode(params, caches, toks[steps - 1], S + steps - 1))
    # the same device time over a step's time without the profiler (its
    # overhead lengthens the host's share)
    step_prof["device_busy_share_unprofiled"] = (
        step_prof["device_busy_ms"] / (decode_s / steps * 1e3))
    prefill_prof = profile_once(
        lambda: prefill(params, {"tokens": prompts}))
    prefill_prof["device_busy_share_unprofiled"] = (
        prefill_prof["device_busy_ms"] / (prefill_s * 1e3))
    del caches

    # (a) the plain path on the card, teacher-forced with the kernel's tokens
    reset()
    plain_prefill = make_prefill_step(cfg, s_max=s_max, use_kernel=False)
    plain_decode = make_decode_step(cfg, use_kernel=False)
    logits, caches = plain_prefill(params, {"tokens": prompts})
    plain_logits = [logits]
    for i in range(steps):
        logits, caches = plain_decode(params, caches, toks[i], S + i)
        plain_logits.append(logits)
    if any(counts().values()):
        raise AssertionError(f"the plain path launched kernels: {counts()}")
    del caches
    vs_plain = compare("serve vs plain path", kern_logits,
                       torch.stack(plain_logits), SERVE_TOL, SERVE_TOL)
    # (b) teacher forcing: forward over prompt + generated tokens
    seq = torch.cat([prompts] + toks[:steps], dim=1)
    with torch.inference_mode():
        full, _ = forward(cfg, params, {"tokens": seq})
    vs_forward = compare("serve vs forward", kern_logits,
                         full[:, S - 1:].transpose(0, 1), SERVE_TOL,
                         SERVE_TOL)
    del full
    rec = {"phase": "serve", "arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "dtype": cfg.dtype,
           "params": sum(t.numel() for t in _leaves(params)),
           "B": B, "prompt": S, "steps": steps, "s_max": s_max,
           "init_s": init_s, "prefill_ms": prefill_s * 1e3,
           "prefill_tokens_per_s": B * S / prefill_s,
           "decode_ms_per_token": decode_s / steps * 1e3,
           "decode_tokens_per_s": B * steps / decode_s,
           "peak_memory_gib": peak / 2 ** 30, "launches": launches,
           "vs_plain": vs_plain, "vs_forward": vs_forward,
           "tol": SERVE_TOL,
           "argmax_equal_plain": bool(torch.equal(
               kern_logits.argmax(-1), torch.stack(plain_logits).argmax(-1))),
           "decode_step_profile": step_prof,
           "prefill_profile": prefill_prof}
    return rec, launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tenants", type=int, default=64)
    ap.add_argument("--ticks", type=int, default=4)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port on "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np
    import repro_torch  # noqa: F401  (sets the TF32 flags)
    import repro_torch.fleet.replay as replay_mod
    from repro_torch.core.catalog import make_cloud_catalog
    from repro_torch.fleet import TenantSpec, make_trace, replay_fleet
    from repro_torch.fleet.batching import stack_problems, tenant_problem
    from repro_torch.kernels.alloc_objective import ops, ref
    from repro_torch.kernels.build import build_libraries
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    sources = {"alloc_objective": ops.SOURCE, "flash_attention": fops.SOURCE,
               "decode_attention": dops.SOURCE}

    dev = torch.device("cuda")
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "setup", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi,
          "tf32": [torch.backends.cuda.matmul.allow_tf32,
                   torch.backends.cudnn.allow_tf32]})

    # ---- build --------------------------------------------------------
    t0 = time.perf_counter()
    libs = build_libraries(list(sources.values()))
    build_s = time.perf_counter() - t0
    emit({"phase": "build", "seconds": build_s, "libraries": {
        name: {"library": libs[src].name,
               "ptxas": [ln.strip() for ln in
                         libs[src].with_suffix(".log").read_text().splitlines()
                         if "registers" in ln or "spill" in ln
                         or "smem" in ln]}
        for name, src in sources.items()}})

    # ---- inputs: the fleet's tick-0 problems, as the replay stacks them --
    catalog = make_cloud_catalog()
    tenants = make_tenants(TenantSpec, make_trace, args.tenants, args.ticks,
                           args.seed)
    ctls = [replay_mod._make_controller(catalog, s) for s in tenants]
    groups = replay_mod._replay_batch_groups(ctls, tenants)
    if len(groups) != 1:
        raise AssertionError(f"expected one shape bucket, got {list(groups)}")
    (n_pad, m_pad, p_pad, n_starts), = groups
    probs = [c.make_problem(np.asarray(s.trace[0])) for c, s in
             zip(ctls, tenants)]
    batch = stack_problems(probs, n_max=n_pad, m_max=m_pad, p_max=p_pad,
                           device=dev)
    ragged = stack_problems(probs, device=dev)     # unpadded n = 1880

    # ---- kernels ------------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    L = 12   # SolverConfig().n_backtracks: the ladder's rungs per start

    def points(prob, T):
        B, n = prob.c.shape
        return (2.0 * torch.rand((B, T, n), generator=gen, device=dev)
                * prob.mask[:, None, :]).contiguous()

    def plain_args(prob):
        Q = prob.params
        return (prob.K, prob.E, prob.c, prob.d, Q.alpha, Q.beta1, Q.beta2,
                Q.beta3, Q.gamma)

    t0 = time.perf_counter()
    measured = {}
    checks = []
    for name, prob, T in (("alloc_objective_fleet", batch.problem, n_starts),
                          ("alloc_objective_fleet", ragged.problem, n_starts),
                          ("alloc_objective_fleet_value", batch.problem,
                           n_starts * L),
                          ("alloc_objective_fleet_value", ragged.problem,
                           n_starts * L)):
        X = points(prob, T)
        B, n = prob.c.shape
        scal = ops._fleet_scalars(prob)
        launch = lambda: ops._launch(name, X, prob.K, prob.E, prob.c, prob.d,
                                     scal, name == "alloc_objective_fleet")
        if name == "alloc_objective_fleet":
            f, g = ops.fleet_value_and_grad(prob, X)
            fr, gr = ref.alloc_objective_fleet_ref(X, *plain_args(prob))
            rec = compare(name, torch.cat([f.flatten(), g.flatten()]),
                          torch.cat([fr.flatten(), gr.flatten()]))
            kern = lambda: ops.fleet_value_and_grad(prob, X)
            plain = lambda: ref.alloc_objective_fleet_ref(X, *plain_args(prob))
        else:
            f = ops.fleet_value(prob, X)
            fr = ref.alloc_objective_fleet_value(X, *plain_args(prob))
            rec = compare(name, f, fr)
            kern = lambda: ops.fleet_value(prob, X)
            plain = lambda: ref.alloc_objective_fleet_value(
                X, *plain_args(prob))
        torch.cuda.synchronize()
        rec.update(name=name, shape={"B": B, "T": T, "n": n, "m": m_pad,
                                     "p": p_pad})
        if n == n_pad:      # the replay's shape: time it
            bound_ms, bound_by, nbytes, flops = kernel_bound(
                B, T, n, m_pad, p_pad, name == "alloc_objective_fleet")
            rec.update(**timings(kern, plain, launch), bound_ms=bound_ms,
                       bound_by=bound_by, bytes=nbytes, flops=flops)
            measured[name] = rec
        checks.append(rec)
    # the single-problem entry: S = 128 starts of tenant 0 (n = 1880)
    single = tenant_problem(batch, 0)
    S = 128
    Xs = (2.0 * torch.rand((S, single.n), generator=gen, device=dev)
          * single.mask).contiguous()
    f, g = ops.batched_value_and_grad(single, Xs)
    fr, gr = ref.alloc_objective_ref(Xs, *plain_args(single))
    rec = compare("alloc_objective", torch.cat([f, g.flatten()]),
                  torch.cat([fr, gr.flatten()]))
    bound_ms, bound_by, nbytes, flops = kernel_bound(1, S, single.n, m_pad,
                                                     p_pad, True)
    scal = ops._single_scalars(single)
    rec.update(name="alloc_objective",
               shape={"S": S, "n": single.n, "m": m_pad, "p": p_pad},
               **timings(lambda: ops.batched_value_and_grad(single, Xs),
                         lambda: ref.alloc_objective_ref(
                             Xs, *plain_args(single)),
                         lambda: ops._launch(
                             "alloc_objective", Xs[None], single.K[None],
                             single.E[None], single.c[None], single.d[None],
                             scal, True)),
               bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, flops=flops)
    measured["alloc_objective"] = rec
    checks.append(rec)
    emit({"phase": "kernels", "seconds": time.perf_counter() - t0,
          "rtol": RTOL, "atol": ATOL, "checks": checks})

    # ---- replay: the main path, kernel then plain ------------------------
    solve_log = []

    def timed(fn, kind_):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            res = fn(*a, **kw)
            torch.cuda.synchronize()
            solve_log.append({"solve": kind_,
                              "seconds": time.perf_counter() - s0,
                              "iters": int(res.iters.sum())})
            return res
        return wrapper

    replay_mod.solve_fleet = timed(replay_mod.solve_fleet, "cold")
    replay_mod.solve_fleet_step = timed(replay_mod.solve_fleet_step, "warm")

    def run(hot_loop):
        solve_log.clear()
        ops.reset_launches()
        fops.reset_launches()
        dops.reset_launches()
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        out = replay_fleet(catalog, tenants, replay_mode="batched",
                           run_ca_baseline=False, hot_loop=hot_loop)
        torch.cuda.synchronize()
        wall = time.perf_counter() - s0
        if fops.LAUNCHES["flash_attention"] or dops.LAUNCHES[
                "decode_attention"]:
            raise AssertionError("the replay launched attention kernels")
        return out, wall, dict(ops.LAUNCHES), list(solve_log)

    def summary(out, wall, launches, solves):
        sat = np.asarray([[s.metrics.satisfied for s in r.steps]
                          for r in out.tenants])
        counts = np.stack([s.counts for r in out.tenants for s in r.steps])
        if not (np.isfinite(counts).all() and (counts >= 0).all()
                and np.array_equal(counts, np.round(counts))):
            raise AssertionError("replay committed non-integral counts")
        return {"wall_s": wall, "ticks": args.ticks,
                "tick_solves": solves,
                "host_s_per_tick": (wall - sum(s["seconds"] for s in solves))
                / args.ticks,
                "launches": launches,
                "feasible_tenants": int(sat.all(1).sum()),
                "satisfied_ticks": int(sat.sum()),
                "cost_integral": out.metrics.total_cost_integral,
                "total_churn": out.metrics.total_churn,
                "solver_iters": out.metrics.solver_iters_percentiles,
                "summary": out.metrics.summary().splitlines()}, sat

    t0 = time.perf_counter()
    k_out, *k_rest = run("kernel")
    k_sum, k_sat = summary(k_out, *k_rest)
    main_launches = k_rest[1]
    for name in ("alloc_objective_fleet", "alloc_objective_fleet_value"):
        if main_launches[name] == 0:
            raise AssertionError(f"the replay never launched {name}")
    p_out, *p_rest = run("ref")
    p_sum, p_sat = summary(p_out, *p_rest)
    if any(p_rest[1].values()):
        raise AssertionError(f"the plain replay launched kernels: {p_rest[1]}")
    k_cost = np.asarray([r.metrics.cost_integral for r in k_out.tenants])
    p_cost = np.asarray([r.metrics.cost_integral for r in p_out.tenants])
    rel = np.abs(k_cost - p_cost) / np.maximum(np.abs(p_cost), 1e-12)
    agg = abs(k_cost.sum() - p_cost.sum()) / p_cost.sum()
    emit({"phase": "replay", "seconds": time.perf_counter() - t0,
          "B": args.tenants, "n": catalog.n, "bucket": [n_pad, m_pad, p_pad],
          "n_starts": n_starts, "kernel": k_sum, "plain": p_sum,
          "max_tenant_rel_diff": float(rel.max()), "fleet_rel_diff": agg,
          "satisfied_flags_equal": bool(np.array_equal(k_sat, p_sat))})
    if not (rel.max() <= TENANT_RTOL and agg <= FLEET_RTOL
            and np.array_equal(k_sat, p_sat)):
        raise AssertionError("kernel replay disagrees with the plain replay")

    # ---- profile one warm tick -------------------------------------------
    X_cur = torch.as_tensor(np.stack(
        [np.pad(r.steps[0].counts, (0, n_pad - catalog.n))
         for r in k_out.tenants]), dtype=torch.float32, device=dev)
    batch1 = stack_problems(
        [c.make_problem(np.asarray(s.trace[1])) for c, s in zip(ctls, tenants)],
        n_max=n_pad, m_max=m_pad, p_max=p_pad, device=dev)
    delta = torch.as_tensor([s.delta_max for s in tenants], device=dev)
    step = replay_mod.solve_fleet_step
    step(batch1, X_cur, delta)                    # warm-up
    torch.cuda.synchronize()
    res = []
    prof = profile_once(lambda: res.append(step(batch1, X_cur, delta)),
                        top_n=8)
    emit({"phase": "profile", "what": "one warm solve_fleet_step",
          "iters_max": int(res[0].iters.max()), **prof})

    # ---- attention kernels ---------------------------------------------
    t0 = time.perf_counter()
    attn_checks, attn_measured = attention_checks(args.seed, dev)
    emit({"phase": "attention", "seconds": time.perf_counter() - t0,
          "tol": ATTN_TOL, "checks": attn_checks})
    torch.cuda.empty_cache()

    # ---- serve: the second main path -------------------------------------
    t0 = time.perf_counter()
    serve_rec, serve_launches = serve(args.seed, dev)
    serve_rec["seconds"] = time.perf_counter() - t0
    emit(serve_rec)

    # ---- the closing lines ---------------------------------------------
    kernels = []
    for name in ("alloc_objective_fleet", "alloc_objective_fleet_value",
                 "alloc_objective"):
        rec = measured[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/alloc_objective/csrc/"
                      "alloc_objective.cu",
            "replaces": REPLACES[name], "launches": main_launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in checks
                               if c["name"] == name),
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": None})
    for name, rec in attn_measured.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": str(sources[name].relative_to(Path(__file__).resolve()
                                                    .parent)),
            "replaces": REPLACES[name], "launches": serve_launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in attn_checks
                               if c["name"] == name),
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"]})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
