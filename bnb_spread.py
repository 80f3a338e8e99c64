#!/usr/bin/env python3
"""Branch-and-bound's answer on s4_memory under one-ulp changes of the
problem, for the port's kernel and plain paths.

    python3 bnb_spread.py [--device cuda|cpu] [--engines kernel,plain]
                          [--out build/bnb_spread.jsonl]

On the full catalog (n = 1880), as ``optimize(use_bnb=True, n_starts=6,
seed=0)`` runs it: each engine solves the multistart once
(``multistart_solve(prob, 6, seed=0)``), then runs ``branch_and_bound``
(``chip_smoke.BNB_NODES`` nodes, as the smoke's bnb phase) from its best
relaxed start on the problem with ``c`` or ``d``
scaled by 1 +- 2^-23 (each entry moves by at most one float32 ulp) and on
the unchanged problem. Every answer is eq. (1) at the committed counts
(the multistart's where they are better, as ``optimize`` keeps them) on
the unchanged problem, printed beside the reference's on the same
perturbed problem (``chip_smoke.REF_S4_BNB``, which
``tests/test_torch_bnb_spread.py`` reproduces with the JAX package).

The ``kernel`` engine evaluates eq. (1) with the alloc_objective kernel
and needs a CUDA device; on ``--device cpu`` only ``plain`` runs. One JSON
object per line, also written to --out; on a card the last line names it
and its power limit.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
STARTS, SEED = 6, 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--engines", default="kernel,plain")
    ap.add_argument("--out", default="build/bnb_spread.jsonl")
    args = ap.parse_args()
    import numpy as np
    import torch
    engines = args.engines.split(",")
    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        print("bnb_spread: no CUDA device", file=sys.stderr)
        return 2
    if "kernel" in engines and not on_card:
        print("bnb_spread: the kernel engine needs --device cuda",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import BNB_NODES, REF_S4_BNB, nvidia_smi
    from repro_torch.core import objective as obj
    from repro_torch.core.api import problem_from_scenario
    from repro_torch.core.branch_bound import branch_and_bound
    from repro_torch.core.catalog import make_cloud_catalog
    from repro_torch.core.multistart import multistart_solve
    from repro_torch.core.scenarios import build_scenarios
    from repro_torch.kernels.alloc_objective import ops

    out_path = ROOT / args.out
    out_path.parent.mkdir(parents=True, exist_ok=True)
    sink = out_path.open("w")

    def emit(o):
        line = json.dumps(o)
        print(line, flush=True)
        sink.write(line + "\n")

    catalog = make_cloud_catalog()
    scenario = {s.name: s for s in build_scenarios(catalog)}["s4_memory"]
    prob = problem_from_scenario(catalog, scenario, device=args.device)
    up, down = np.float32(1 + 2.0 ** -23), np.float32(1 - 2.0 ** -23)
    perturbed = {"none": prob,
                 "c+": prob._replace(c=prob.c * float(up)),
                 "c-": prob._replace(c=prob.c * float(down)),
                 "d+": prob._replace(d=prob.d * float(up)),
                 "d-": prob._replace(d=prob.d * float(down))}
    answers = {}
    for engine in engines:
        use_kernel = engine == "kernel"
        ms = multistart_solve(prob, n_starts=STARTS, seed=SEED,
                              use_kernel=use_kernel)
        ms_fun = float(ms.fun_int)
        for name, p in perturbed.items():
            ops.reset_launches()
            t0 = time.perf_counter()
            bnb = branch_and_bound(p, ms.best.x.cpu().numpy(),
                                   max_nodes=BNB_NODES,
                                   use_kernel=use_kernel)
            wall = time.perf_counter() - t0
            x = (ms.x_int.cpu().numpy() if ms_fun < bnb.fun else bnb.x)
            fun = float(obj.objective(
                prob, torch.as_tensor(x, dtype=torch.float32,
                                      device=prob.device), use_kernel))
            answers.setdefault(engine, {})[name] = fun
            emit({"engine": engine, "perturbation": name, "fun": fun,
                  "reference_fun": REF_S4_BNB[name],
                  "bnb_fun": bnb.fun, "multistart_fun_int": ms_fun,
                  "kept_multistart": bool(ms_fun < bnb.fun),
                  "incumbent_updates": bnb.incumbent_updates,
                  "nodes_explored": bnb.nodes_explored, "gap": bnb.gap,
                  "wall_s": wall, "launches": dict(ops.LAUNCHES)})
    summary = {"answers": answers, "reference": REF_S4_BNB}
    for engine, got in answers.items():
        summary[f"{engine}_equal_to_reference"] = sum(
            abs(got[k] - REF_S4_BNB[k]) <= 1e-6 * REF_S4_BNB[k] for k in got)
        summary[f"{engine}_distinct"] = sorted(set(round(v, 6)
                                                   for v in got.values()))
    emit({"summary": summary})
    if on_card:
        print(nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
