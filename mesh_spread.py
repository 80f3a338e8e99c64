"""Run-to-run spread of ``chip_smoke.py``'s distributed phase (c) on the
card: qwen1.5-4b at full width, MESH_LAYERS layers, MESH_STEPS launcher
steps of TRAIN_BATCH x TRAIN_SEQ, twice on one device and twice on a 1x1
mesh; for each pair, how many leaves are bit-equal and the six leaves
farthest from each other over the smoke's tolerance.

    python3 mesh_spread.py        # on a machine with a card, ~1 min
"""
import sys
import tempfile

sys.path.insert(0, "src")
sys.path.insert(0, ".")
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import repro_torch  # noqa: E402,F401  (sets the TF32 flags)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

PAIRS = (("one_b", "one_a"), ("mesh_b", "mesh_a"), ("mesh_a", "one_a"),
         ("mesh_b", "one_b"))


def leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{path}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def main():
    dev = torch.device("cuda")
    cfg = get_config(cs.TRAIN_ARCH).scaled(n_layers=cs.MESH_LAYERS)
    mesh = make_mesh((1, 1), ("data", "model"), dev)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, m in (("one_a", None), ("one_b", None), ("mesh_a", mesh),
                        ("mesh_b", mesh)):
            params, state, _ = launch.train(
                cfg, steps=cs.MESH_STEPS, batch=cs.TRAIN_BATCH,
                seq=cs.TRAIN_SEQ, lr=cs.TRAIN_LR, device=dev, seed=0,
                mesh=m, ckpt_every=cs.MESH_STEPS + 1, ckpt_dir=tmp,
                log=lambda *_: None)
            if m is not None:
                params, _ = launch.gather_state(params, state)
            runs[name] = adamw.tree_map(lambda t: t.detach().cpu(), params)
            del params, state
            torch.cuda.empty_cache()
    tol = cs.MESH_TOL
    for a, b in PAIRS:
        want = dict(leaves(runs[b]))
        rows = []
        for path, g in leaves(runs[a]):
            w, g = want[path].double(), g.double()
            atol = tol * float(w.abs().max()) * (
                10 if path.split(".")[-1] in cs.NOISE_LEAVES else 1)
            over = float(((g - w).abs() / (atol + tol * w.abs())
                          .clamp_min(1e-300)).max())
            rows.append((over, path, int((g != w).sum()), g.numel()))
        rows.sort(reverse=True)
        print(a, "vs", b, "bitwise equal leaves:",
              sum(r[2] == 0 for r in rows), "of", len(rows), flush=True)
        for over, path, n_diff, n in rows[:6]:
            print(f"   {path}: over_tol {over:.4f}, {n_diff}/{n} elements "
                  f"differ", flush=True)


if __name__ == "__main__":
    main()
