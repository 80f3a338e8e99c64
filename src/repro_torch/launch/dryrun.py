"""Dry run: count every (arch x input-shape) cell's step on the production
mesh without a device, and write one JSON record per cell — port of
``repro.launch.dryrun``.

    python -m repro_torch.launch.dryrun [--arch ARCH] [--shape SHAPE] \\
        [--mesh single|multi|both] [--out-dir DIR]

For each cell the process starts a world of 256 ranks (16x16, ("data",
"model")) or 512 (2x16x16, ("pod", "data", "model")) on torch's "fake"
process-group backend, which moves no data (``fake_world``), builds
``make_production_mesh`` on it and runs rank 0's program of the port's
own step: ``steps.make_train_step`` with AdamW, ``make_prefill_step``, or
``make_decode_step`` at ``pos = seq - 1``, on rank 0's rows of the
batch. Every parameter, moment, input and cache is a meta tensor (shapes
and dtypes, no memory), placed as a DTensor by the cell's rule set
(``sharding.RULESETS[shapes.ruleset_name(shape)]``), so nothing runs on a
device and nothing is allocated. The step runs eagerly under two
dispatch-mode counters (``count_step``):

- ``flops``: ``torch.utils.flop_counter.FlopCounterMode``, per device;
- ``bytes_accessed``: each operation's input and output bytes, added up
  op by op (views move nothing and are skipped). An eager count with no
  fusion: every intermediate is written and read again, where a fused
  program would keep it on chip;
- ``collectives``: the result bytes of every c10d operation, by operation
  under the reference's names and in total (an all-gather's result is the
  gathered tensor, a reduce-scatter's the shard, an all-reduce's the
  tensor), and ``collective_bytes`` their total;
- ``bytes_per_device``: rank 0's peak live bytes over the step, from every
  storage the step's arguments and operations hold (dropped when freed);
  ``memory`` splits it as the reference does: ``argument_bytes`` (the
  state and inputs live at entry), ``output_bytes`` (what the step
  returns), ``temp_bytes`` (the peak less the arguments) and
  ``alias_bytes`` (outputs that are arguments, updated in place).

Eager dispatch runs every layer, so the counts are whole: there is no
rolled loop to extrapolate from short compiles as the reference does.
``extrapolation`` is null and ``raw_flops`` equals ``flops``.

The compute is the port's, FSDP-style: each layer's leaves are gathered
whole where the model reads them and the ranks of the "model" dimension
compute alike on rank 0's rows. So a cell's per-device FLOPs are about
16 times what the reference's tensor-parallel layout computes per device,
and ``roofline.useful_flops_ratio`` (``model_flops_per_device`` over
``flops``) is about 1/16 of the reference's. A cell at full size is
host-bound dispatch: ``count_s`` (host seconds of the counted step)
takes tens of seconds to minutes.

The roofline is priced at the NVIDIA H100 SXM5's rates (NVIDIA H100 Tensor
Core GPU datasheet): ``PEAK_FLOPS`` bf16 dense (without sparsity),
``HBM_BW`` HBM3, and ``NET_BW`` one 400 Gb/s NDR InfiniBand port per GPU
for the collectives, since a 16-wide mesh axis spans two 8-GPU nodes.

The fake backend lives in a private module of torch
(``torch.testing._internal.distributed.fake_pg``); ``fake_world`` raises
if it cannot be imported, and there is no other route. Records go under
``build/repro_torch_dryrun/`` at the repository root unless ``--out-dir``
says otherwise; exit code 1 if any cell errs.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback
import weakref
from contextlib import contextmanager
from pathlib import Path

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from ..configs import get_config, list_archs
from ..distributed import sharding as shd
from ..models import abstract_params
from ..optim import adamw
from .mesh import make_production_mesh, mesh_context
from .shapes import (SHAPES, ShapeSpec, cell_applicable, input_specs,
                     ruleset_name)
from .steps import make_decode_step, make_prefill_step, make_train_step

ARTIFACT_DIR = str(Path(__file__).resolve().parents[3] / "build"
                   / "repro_torch_dryrun")

# NVIDIA H100 SXM5, from NVIDIA's H100 Tensor Core GPU datasheet
PEAK_FLOPS = 989.4e12        # bf16 dense tensor-core FLOP/s, no sparsity
HBM_BW = 3.35e12             # HBM3 bytes/s
NET_BW = 50e9                # bytes/s: one 400 Gb/s NDR port per GPU

# c10d operation names -> the reference's HLO collective names (a
# broadcast keeps its own)
_COLLECTIVE_NAMES = (("all_gather", "all-gather"),
                     ("allgather", "all-gather"),
                     ("reduce_scatter", "reduce-scatter"),
                     ("all_reduce", "all-reduce"),
                     ("allreduce", "all-reduce"),
                     ("all_to_all", "all-to-all"),
                     ("alltoall", "all-to-all"),
                     ("broadcast", "broadcast"))
_C10D = ("c10d", "c10d_functional", "_c10d_functional",
         "_c10d_functional_autograd")
# operations that read and write no tensor data (as do views, and the
# c10d operations other than the collectives: waits and wrappers)
_NO_TRAFFIC = ("empty", "empty_strided", "empty_like", "detach",
               "lift_fresh")


@contextmanager
def fake_world(world_size: int):
    """The default process group as torch's "fake" backend: ``world_size``
    ranks, this process rank 0, collectives that move no data. The backend
    and its store come from a private module of torch; if it cannot be
    imported this raises (no other backend stands in). Raises if a group
    is running; destroys the fake one on exit."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "the dry run needs torch's fake process-group backend "
            "(torch.testing._internal.distributed.fake_pg), which this "
            f"torch {torch.__version__} does not have") from e
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is running; the dry "
                           "run needs a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local(t):
    """A DTensor's local tensor (without dispatching); a tensor itself."""
    return getattr(t, "_local_tensor", t)


def _tensors(tree):
    return [_local(x) for x in pytree.tree_leaves(tree)
            if isinstance(x, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _collective(func):
    """The reference's name for a c10d collective, None for any other
    operation (a c10d wait or wrapper moves nothing)."""
    if func.namespace not in _C10D:
        return None
    return next((label for key, label in _COLLECTIVE_NAMES
                 if key in func._opname), None)


class StepCounter(TorchDispatchMode):
    """Counts, op by op, the bytes each operation reads and writes, the
    result bytes of each collective, and the live bytes of every storage
    that the tracked arguments and the operations' outputs hold (a storage
    leaves the count when it is freed), with their peak. Only tensors on
    ``device_type`` (the step's) count; the bytes of the outputs on any
    other device are summed apart by device in ``elsewhere`` (a DeviceMesh
    computes its coordinates on small CPU tables of ranks)."""

    def __init__(self, device_type: str):
        super().__init__()
        self.device_type = device_type
        self.bytes_accessed = 0
        self.collectives = {}
        self.collective_calls = {}
        self.live = self.peak = 0
        self.elsewhere = {}
        self._storages = {}

    def _here(self, tensors) -> list:
        return [t for t in tensors if t.device.type == self.device_type]

    def track(self, tree) -> None:
        """Count the storages of ``tree``'s tensors as live."""
        for t in self._here(_tensors(tree)):
            self._track(t)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        held = self._storages.get(key)
        if held is not None and held[0]() is st:
            return
        n = st.nbytes()
        self._storages[key] = (weakref.ref(st, lambda _, k=key, n=n:
                                           self._free(k, n)), n)
        self.live += n
        self.peak = max(self.peak, self.live)

    def _free(self, key, n) -> None:
        if self._storages.pop(key, None) is not None:
            self.live -= n

    def storages(self, tree) -> dict:
        """{storage id: (weak reference, bytes)} of the tracked storages
        that ``tree`` holds."""
        out = {}
        for t in self._here(_tensors(tree)):
            st = t.untyped_storage()
            held = self._storages.get(id(st))
            if held is not None and held[0]() is st:
                out[id(st)] = held
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = _tensors(out)
        for t in outs:
            if t.device.type != self.device_type:
                kind = t.device.type
                self.elsewhere[kind] = self.elsewhere.get(kind, 0) + _nbytes(t)
        outs = self._here(outs)
        for t in outs:
            self._track(t)
        label = _collective(func)
        if label is not None:
            moved = sum(_nbytes(t) for t in outs)
            self.collectives[label] = self.collectives.get(label, 0) + moved
            self.collective_calls[label] = (
                self.collective_calls.get(label, 0) + 1)
        if not (func.is_view or func._opname in _NO_TRAFFIC
                or (func.namespace in _C10D and label is None)):
            self.bytes_accessed += sum(
                _nbytes(t) for t in self._here(_tensors((args, kwargs)))
                + outs)
        return out


def flops_by_op(counter: FlopCounterMode) -> dict:
    """A FlopCounterMode's FLOPs by operation name, over the whole run."""
    return {str(op): int(n) for op, n in
            counter.get_flop_counts().get("Global", {}).items()}


def _placed(tree, axes, mesh, rules):
    """``tree`` (meta tensors) as DTensors on ``mesh`` with the placements
    of ``axes`` under ``rules``: each this rank's shard, a meta tensor of
    the shard's shape (``make_specs`` keeps only even splits)."""
    from torch.distributed.tensor import DTensor

    def one(t, spec):
        local = list(t.shape)
        for d, assignment in enumerate(spec):
            if assignment is not None:
                local[d] //= shd._axis_size(mesh, assignment)
        return DTensor.from_local(
            torch.empty(local, dtype=t.dtype, device="meta"), mesh,
            shd.placements_for(spec, mesh), run_check=False, shape=t.shape,
            stride=t.stride())

    with torch.no_grad():
        return adamw.tree_map(one, tree, shd.make_specs(axes, mesh, rules,
                                                        tree))


def count_step(cfg, shape: ShapeSpec, mesh, rules) -> dict:
    """Rank 0's program of the cell's step on ``mesh`` (a DeviceMesh of a
    running world, fake or not) under ``rules``, on meta tensors, counted:
    flops (and flops_by_op), bytes_accessed, collectives (bytes by
    operation and "total"), collective_calls, peak / argument / output /
    temp / alias bytes, rows (rank 0's rows of the batch), params_numel,
    off_device_bytes (what operations made off the meta device, by
    device) and count_s (host seconds of the counted step)."""
    with mesh_context(mesh), shd.use_rules(rules):
        shards = shd.batch_shards()
    if shape.batch % shards:
        raise ValueError(f"{shape.name}: a batch of {shape.batch} does not "
                         f"split over {shards} ranks")
    rows = shape.batch // shards
    full, axes = abstract_params(cfg)
    numel = sum(t.numel() for t in adamw.tree_leaves(full))
    params = _placed(full, axes, mesh, rules)
    inputs = input_specs(cfg, dataclasses.replace(shape, batch=rows))
    if shape.kind == "train":
        state = adamw.abstract_state(full)
        state = adamw.AdamWState(state.step,
                                 *_placed((state.m, state.v), (axes, axes),
                                          mesh, rules))
        step = make_train_step(cfg, adamw.AdamWConfig(), mesh=mesh)
        args = (params, state, inputs["batch"])
    elif shape.kind == "prefill":
        step = make_prefill_step(cfg, s_max=shape.seq, use_kernel=False,
                                 mesh=mesh, rules=rules)
        args = (params, inputs["batch"])
    else:
        step = make_decode_step(cfg, use_kernel=False, mesh=mesh,
                                rules=rules)
        args = (params, inputs["caches"], inputs["tokens"], shape.seq - 1)
    del full, params, inputs
    counter = StepCounter("meta")
    counter.track(args)
    arg_storages = counter.storages(args)
    argument_bytes = counter.live
    flop_counter = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    with flop_counter, counter:
        out = step(*args)
    count_s = time.perf_counter() - t0
    del args
    out_storages = counter.storages(out)
    # an output that is an argument: the same storage, alive throughout
    aliased = [n for k, (ref, n) in out_storages.items()
               if k in arg_storages and arg_storages[k][0]() is ref()]
    collectives = dict(counter.collectives)
    collectives["total"] = sum(counter.collectives.values())
    return {"flops": float(flop_counter.get_total_flops()),
            "flops_by_op": flops_by_op(flop_counter),
            "bytes_accessed": float(counter.bytes_accessed),
            "collectives": collectives,
            "collective_calls": dict(counter.collective_calls),
            "peak_bytes": counter.peak,
            "argument_bytes": argument_bytes,
            "output_bytes": sum(n for _, n in out_storages.values()),
            "temp_bytes": counter.peak - argument_bytes,
            "alias_bytes": sum(aliased),
            "rows": rows, "params_numel": numel,
            "off_device_bytes": dict(counter.elsewhere),
            "count_s": count_s}


def count_on_fake_world(cfg, shape: ShapeSpec, world: int,
                        build_mesh) -> dict:
    """``count_step`` of ``cfg``'s ``shape`` cell on a fake world of
    ``world`` ranks, on the mesh ``build_mesh()`` builds there, under the
    cell's rule set."""
    with fake_world(world):
        mesh = build_mesh()
        rules = shd.RULESETS[ruleset_name(shape)](mesh, cfg)
        return count_step(cfg, shape, mesh, rules)


def _model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6*N_active*tokens (train) / 2*N_active*tokens (fwd)."""
    total, active = cfg.param_counts()
    if shape.kind == "train":
        tokens = shape.batch * shape.seq
        return 6.0 * active * tokens
    if shape.kind == "prefill":
        tokens = shape.batch * shape.seq
        return 2.0 * active * tokens
    return 2.0 * active * shape.batch        # one token per sequence


def cell_config(arch: str, shape: ShapeSpec):
    """The reference's cell config: bfloat16 weights and activations, the
    loss unchunked along the sequence."""
    return get_config(arch).scaled(dtype="bfloat16", param_dtype="bfloat16",
                                   loss_chunk=shape.seq)


def lower_cell(arch: str, shape_name: str, multi_pod: bool) -> dict:
    """Returns the JSON record for one cell (the reference's name; nothing
    is lowered: the step is counted on a fake world, see the module
    docstring)."""
    shape = SHAPES[shape_name]
    cfg = cell_config(arch, shape)
    skip = cell_applicable(cfg, shape)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec = {"cell": f"{arch}__{shape_name}", "arch": arch, "shape": shape_name,
           "mesh": mesh_name, "kind": shape.kind}
    if skip:
        rec.update(status="skipped", reason=skip)
        return rec

    n_dev = 512 if multi_pod else 256
    c = count_on_fake_world(cfg, shape, n_dev, lambda: make_production_mesh(
        multi_pod=multi_pod, device="cpu"))
    model_flops = _model_flops(cfg, shape)
    total_p, active_p = cfg.param_counts()
    flops_dev, bytes_dev = c["flops"], c["bytes_accessed"]
    coll_total = float(c["collectives"]["total"])
    rec.update(
        status="ok",
        devices=n_dev,
        count_s=c["count_s"],
        rows=c["rows"],                        # rank 0's rows of the batch
        flops=flops_dev,                       # per device (rank 0)
        bytes_accessed=bytes_dev,              # per device, op by op
        collective_bytes=coll_total,           # per device
        collectives=c["collectives"],
        raw_flops=flops_dev,                   # eager: nothing to correct
        raw_bytes_accessed=bytes_dev,
        extrapolation=None,
        memory={k: int(c[k]) for k in ("argument_bytes", "output_bytes",
                                        "temp_bytes", "alias_bytes")},
        bytes_per_device=int(c["peak_bytes"]),
        off_device_bytes=c["off_device_bytes"],  # the mesh's rank tables
        model_flops_global=model_flops,
        model_flops_per_device=model_flops / n_dev,
        params_total=int(total_p),
        params_active=int(active_p),
        params_numel=int(c["params_numel"]),
        roofline={
            "compute_s": flops_dev / PEAK_FLOPS,
            "memory_s": bytes_dev / HBM_BW,
            "collective_s": coll_total / NET_BW,
            "useful_flops_ratio": (model_flops / n_dev) / max(flops_dev, 1.0),
        },
        rates={"peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW, "net_bw": NET_BW},
    )
    dom = max(("compute_s", "memory_s", "collective_s"),
              key=lambda k: rec["roofline"][k])
    rec["roofline"]["dominant"] = dom
    return rec


def run_cells(cells, out_dir: str):
    os.makedirs(out_dir, exist_ok=True)
    records = []
    for arch, shape_name, multi_pod in cells:
        mesh_name = "2x16x16" if multi_pod else "16x16"
        tag = f"{arch}__{shape_name}__{mesh_name}"
        path = os.path.join(out_dir, tag + ".json")
        try:
            rec = lower_cell(arch, shape_name, multi_pod)
        except Exception as e:  # a failing cell is a bug in the system
            rec = {"cell": f"{arch}__{shape_name}", "mesh": mesh_name,
                   "status": "error", "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        status = rec["status"]
        extra = ""
        if status == "ok":
            r = rec["roofline"]
            extra = (f"count={rec['count_s']:.0f}s dom={r['dominant']} "
                     f"comp={r['compute_s']*1e3:.1f}ms "
                     f"mem={r['memory_s']*1e3:.1f}ms "
                     f"coll={r['collective_s']*1e3:.1f}ms "
                     f"useful={r['useful_flops_ratio']:.2f} "
                     f"hbm={rec['bytes_per_device']/2**30:.2f}GiB")
        elif status == "error":
            extra = rec["error"][:160]
        else:
            extra = "SKIP: " + rec["reason"][:120]
        print(f"[dryrun] {tag}: {status} {extra}", flush=True)
        records.append(rec)
    return records


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None],
                    help="shape name (default: all)")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out-dir", default=ARTIFACT_DIR)
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    pods = {"single": [False], "multi": [True],
            "both": [False, True]}[args.mesh]
    cells = [(a, s, mp) for a in archs for s in shapes for mp in pods]
    records = run_cells(cells, args.out_dir)
    n_ok = sum(r["status"] == "ok" for r in records)
    n_skip = sum(r["status"] == "skipped" for r in records)
    n_err = sum(r["status"] == "error" for r in records)
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    sys.exit(1 if n_err else 0)


if __name__ == "__main__":
    main()
