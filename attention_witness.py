#!/usr/bin/env python3
"""How far the float32 flash_attention kernel and its plain version each lie
from attention in float64, at mixtral-8x22b's full width on one NVIDIA GPU.

    python3 attention_witness.py [--src DIR] [--layers 4] [--seed 0]
                                 [--out build/attention_witness.jsonl]

mixtral-8x22b's first ``--layers`` layers at full width (random weights
from ``--seed``, as chip_smoke.py's serve_moe phase makes them) prefill 8
prompts of 1024 tokens through the kernel route, and each layer's q, k and
v are kept. Then:

1. per layer, the rms of each output's difference from the plain version
   in float64, over the rms of that: the kernel, the plain version in
   float32, and the plain version with every product rounded as the
   kernel's 3xTF32 route rounds it but summed by torch's float32 matmul
   (``repro_torch.kernels.tf32.mm_3xtf32``): what the kernel would give if
   the tensor cores' sums rounded to nearest;
2. end to end, the prefill's logits by the kernel route, the plain route
   and the plain route with its attention in float64, each pair as the
   largest |a - b| / (2e-3 + 2e-3 |b|) per batch row (SERVE_TOL,
   tests/models/test_model_parts.py:40), and the tokens whose top-k
   experts differ between the two runs, per layer;
3. the kernel's time at layer 0's inputs (20 calls between CUDA events,
   after 3 to warm up).

``--src`` imports the port from another checkout's ``src`` (to run the same
measurement on an earlier kernel). One JSON object per line, also written
to --out; the last line names the card and its power limit. Without a
CUDA device it exits 2.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = 2e-3
B, S = 8, 1024


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="build/attention_witness.jsonl")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("attention_witness: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    import repro_torch.models.attention as attn_mod
    import repro_torch.models.moe as moe_mod
    from repro_torch.configs import get_config
    from repro_torch.kernels import tf32
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models import init_model, prefill

    out_path = ROOT / args.out
    out_path.parent.mkdir(parents=True, exist_ok=True)
    sink = out_path.open("w")

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        sink.write(line + "\n")

    def plain64(q, k, v, window):
        """Causal (windowed) GQA attention in float64 for one batch row:
        q (S, H, dh), k/v (S, G, dh) -> (S, H, dh) float64."""
        return attend(q.double(), k.double(), v.double(), window,
                      lambda a, b: a @ b)

    def attend(q, k, v, window, mm):
        n, H, dh = q.shape
        G = k.shape[1]
        qr = q.reshape(n, G, H // G, dh).permute(1, 2, 0, 3).contiguous()
        kt = k.permute(1, 2, 0)[:, None].expand(G, H // G, dh, n).contiguous()
        vv = v.permute(1, 0, 2)[:, None].expand(G, H // G, n, dh).contiguous()
        s = mm(qr, kt) / math.sqrt(dh)
        i = torch.arange(n, device=q.device)
        live = i[None, :] <= i[:, None]
        if window > 0:
            live = live & (i[None, :] > i[:, None] - window)
        s = torch.where(live, s, torch.tensor(-1e30, dtype=s.dtype,
                                              device=s.device))
        o = mm(torch.softmax(s, dim=-1), vv)
        return o.permute(2, 0, 1, 3).reshape(n, H, dh)

    dev = torch.device("cuda")
    cfg = get_config("mixtral-8x22b").scaled(n_layers=args.layers)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_model(cfg, gen, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            device=dev)
    batch = {"tokens": prompts}

    kept_fa, kept_route = attn_mod.flash_attention, moe_mod.route
    inputs, routes = [], {}

    def capture(q, k, v, window=0, use_kernel=None):
        inputs.append((q.clone(), k.clone(), v.clone()))
        return kept_fa(q, k, v, window=window, use_kernel=use_kernel)

    def float64_attend(q, k, v, window=0, use_kernel=None):
        return torch.stack([plain64(q[b], k[b], v[b], window).to(q.dtype)
                            for b in range(q.shape[0])])

    def run(name, fa, use_kernel):
        routes[name] = []

        def route(p, c, x, no_drop):
            r = kept_route(p, c, x, no_drop)
            routes[name].append(r.expert_idx.sort(-1).values)
            return r

        attn_mod.flash_attention, moe_mod.route = fa, route
        try:
            with torch.inference_mode():
                return prefill(cfg, params, batch, S, use_kernel=use_kernel)[0]
        finally:
            attn_mod.flash_attention, moe_mod.route = kept_fa, kept_route

    logits = {"kernel": run("kernel", capture, None),
              "plain": run("plain", kept_fa, False),
              "float64_attention": run("float64_attention", float64_attend,
                                       None)}
    names = list(logits)
    for x, name_x in enumerate(names):
        for name_y in names[x + 1:]:
            a, b = logits[name_x].double(), logits[name_y].double()
            over = ((a - b).abs() / (TOL + TOL * b.abs())).amax(-1)
            emit({"pair": [name_x, name_y],
                  "max_err_over_tol_by_row": over.tolist(),
                  "routing_tokens_parted_by_layer": [
                      int((ra != rb).any(-1).sum()) for ra, rb in
                      zip(routes[name_x], routes[name_y])]})
    del logits

    rms = lambda t: float(t.double().pow(2).mean().sqrt())
    for layer, (q, k, v) in enumerate(inputs):
        kern = fops.flash_attention(q, k, v, window=cfg.window)
        sums = {"kernel": 0.0, "plain_float32": 0.0,
                "plain_3xtf32_rounded_sums": 0.0}
        for b in range(B):
            exact = plain64(q[b], k[b], v[b], cfg.window)
            outs = {"kernel": kern[b],
                    "plain_float32": attend(q[b], k[b], v[b], cfg.window,
                                            lambda a, c: a @ c),
                    "plain_3xtf32_rounded_sums": attend(
                        q[b], k[b], v[b], cfg.window, tf32.mm_3xtf32)}
            for name, o in outs.items():
                sums[name] += rms(o.double() - exact) / rms(exact) / B
        emit({"layer": layer, "rms_rel_vs_float64": sums,
              "kernel_over_plain": sums["kernel"] / sums["plain_float32"]})
    # the kernel alone at layer 0's inputs, between CUDA events
    q, k, v = inputs[0]
    for _ in range(3):
        fops.flash_attention(q, k, v, window=cfg.window)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(20):
        fops.flash_attention(q, k, v, window=cfg.window)
    end.record()
    torch.cuda.synchronize()
    emit({"flash_attention_ms": start.elapsed_time(end) / 20,
          "shape": {"B": B, "S": S, "H": cfg.n_heads, "G": cfg.n_kv_heads,
                    "dh": cfg.d_head, "window": cfg.window}})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    emit({"src": args.src, "layers": args.layers, "seed": args.seed,
          "nvidia_smi": smi.stdout.strip().splitlines()[0],
          "device": torch.cuda.get_device_name(0)})
    sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
