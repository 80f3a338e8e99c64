#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--tenants 64] [--ticks 4]

Phases, one JSON object per line:

1. setup   — torch and CUDA versions, the card's name and power limit.
2. build   — compiles the CUDA kernel sources of the checkout with nvcc into
             build/repro_torch_kernels/ and times it.
3. kernels — every kernel entry (fleet value+gradient, fleet value-only,
             single-problem) on the card at the shapes the replay gives it,
             against its plain PyTorch version on the same inputs
             (rtol = atol = 1e-4); the kernel's and the plain version's
             device time per call (torch.profiler) and wall time per call
             (CUDA events);
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

Then the ``{"kernels": [...]}`` line, the nvidia-smi line, and the last line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
without a CUDA device the script exits 2 and prints no result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
F32_FLOPS_PER_S = 67e12       # H100 SXM float32 rate outside tensor cores
RTOL = ATOL = 1e-4            # kernel vs plain (tests/kernels/test_kernels.py:32)
TENANT_RTOL, FLEET_RTOL = 0.05, 2e-2   # tests/fleet/test_solve_fleet.py:113-117
REPLACES = {
    "alloc_objective_fleet": "src/repro/kernels/alloc_objective/kernel.py:136",
    "alloc_objective_fleet_value":
        "src/repro/kernels/alloc_objective/kernel.py:136",
    "alloc_objective": "src/repro/kernels/alloc_objective/kernel.py:102",
}
KERNEL_SYMBOL = "alloc_objective_kernel"   # the CUDA kernel's name
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


def device_ms(fn, reps: int = 50, only: str = "") -> float:
    """Mean device time per call of ``fn()``: the summed duration of the
    CUDA kernels it launches (those whose name contains ``only``), from
    torch.profiler, so host gaps between launches do not count."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.device_time_total for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA") and only in e.key)
    return total_us / 1e3 / reps


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


def timings(kern, plain) -> dict:
    """The kernel alone and its plain version, each by device time and by
    wall time per call."""
    return {"ms": device_ms(kern, only=KERNEL_SYMBOL),
            "plain_ms": device_ms(plain), "call_ms": call_ms(kern),
            "plain_call_ms": call_ms(plain)}


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


def compare(name, got, want):
    import torch
    err = (got - want).abs()
    over = (err / (ATOL + RTOL * want.abs())).max().item()
    rec = {"max_abs_err": err.max().item(), "max_err_over_tol": over}
    if not over <= 1.0:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version: {rec}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    return rec


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
    libs = build_libraries([ops.SOURCE])
    build_s = time.perf_counter() - t0
    log = libs[ops.SOURCE].with_suffix(".log").read_text()
    emit({"phase": "build", "seconds": build_s,
          "library": str(libs[ops.SOURCE].name),
          "ptxas": [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]})

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
            rec.update(**timings(kern, plain), bound_ms=bound_ms,
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
    rec.update(name="alloc_objective",
               shape={"S": S, "n": single.n, "m": m_pad, "p": p_pad},
               **timings(lambda: ops.batched_value_and_grad(single, Xs),
                         lambda: ref.alloc_objective_ref(
                             Xs, *plain_args(single))),
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
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        out = replay_fleet(catalog, tenants, replay_mode="batched",
                           run_ca_baseline=False, hot_loop=hot_loop)
        torch.cuda.synchronize()
        wall = time.perf_counter() - s0
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
    from torch.profiler import ProfilerActivity, profile
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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        s0 = time.perf_counter()
        res = step(batch1, X_cur, delta)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - s0) * 1e3
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")]
    busy_ms = sum(e.device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.device_time_total)[:8]
    emit({"phase": "profile", "what": "one warm solve_fleet_step",
          "wall_ms": wall_ms, "iters_max": int(res.iters.max()),
          "device_busy_ms": busy_ms,
          "device_busy_share": busy_ms / wall_ms if wall_ms else None,
          "device_launches": sum(e.count for e in events),
          "top": [{"name": e.key[:90], "ms": e.device_time_total / 1e3,
                   "count": e.count} for e in top]})

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
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
