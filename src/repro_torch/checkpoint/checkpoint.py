"""Atomic, restart-safe, async-capable checkpoints — port of
``repro.checkpoint.checkpoint`` on trees of torch tensors (nested dicts,
lists, tuples and NamedTuples such as ``AdamWState``).

Layout: <dir>/step_<N>/
    manifest.json            — tree structure, shapes, dtypes, step metadata
    arr_<i>.npy              — one file per leaf, on the host
    _COMMITTED               — written LAST; absence => partial checkpoint

The step is written to ``step_<N>.tmp`` and renamed into place once
``_COMMITTED`` is in it. Restart = ``load_latest()``: the newest committed
step. ``AsyncCheckpointer`` copies the leaves to the host, then a writer
thread serializes them while training goes on; ``wait()`` joins.

A leaf goes to the host as numpy; numpy has no bfloat16, so a bfloat16
leaf is stored as its 16-bit pattern and the manifest records
"bfloat16". ``load(..., like)`` puts every leaf back on ``like``'s leaf's
device, in its type.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch


def _flatten(tree) -> Tuple[List[Any], Callable[[List[Any]], Any], str]:
    """(leaves, rebuild(leaves) -> a tree of ``tree``'s structure, a
    description of the structure). Dicts in key order, sequences and
    NamedTuples by position; anything else is a leaf."""
    if isinstance(tree, dict):
        parts = [_flatten(v) for v in tree.values()]
        keys = list(tree)
        desc = "{" + ", ".join(f"{k!r}: {d}" for k, (_, _, d)
                               in zip(keys, parts)) + "}"
        kind = dict
    elif isinstance(tree, (list, tuple)):
        parts = [_flatten(v) for v in tree]
        keys = None
        name = type(tree).__name__ if hasattr(tree, "_fields") else ""
        desc = (name + ("[" if isinstance(tree, list) else "(")
                + ", ".join(d for _, _, d in parts)
                + ("]" if isinstance(tree, list) else ")"))
        kind = type(tree)
    else:
        return [tree], lambda leaves: leaves[0], "*"
    sizes = [len(leaves) for leaves, _, _ in parts]

    def rebuild(leaves):
        out, i = [], 0
        for (_, sub, _), n in zip(parts, sizes):
            out.append(sub(leaves[i:i + n]))
            i += n
        if kind is dict:
            return dict(zip(keys, out))
        return kind(*out) if hasattr(kind, "_fields") else kind(out)

    return [x for leaves, _, _ in parts for x in leaves], rebuild, desc


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """(numpy array, dtype name) of a leaf: a copy, since the training
    loop updates its parameters in place while the writer runs."""
    if torch.is_tensor(leaf):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.array(leaf)
    return arr, str(arr.dtype)


def save(path: str, step: int, tree: Any, extra: Optional[dict] = None) -> str:
    """Synchronous save with atomic commit. Returns the step's directory."""
    leaves, _, desc = _flatten(tree)
    return _write(path, step, desc, [_to_host(x) for x in leaves], extra)


def _write(path: str, step: int, desc: str, host: list,
           extra: Optional[dict]) -> str:
    """Write the host leaves ``host`` ((array, dtype name) pairs) of a tree
    described by ``desc`` as step ``step``; ``_COMMITTED`` last, then the
    rename."""
    step_dir = os.path.join(path, f"step_{step:08d}")
    tmp_dir = step_dir + ".tmp"
    if os.path.exists(tmp_dir):
        shutil.rmtree(tmp_dir)
    os.makedirs(tmp_dir, exist_ok=True)
    manifest = {"step": step, "treedef": desc, "n_leaves": len(host),
                "extra": extra or {}, "leaves": []}
    for i, (arr, dtype) in enumerate(host):
        np.save(os.path.join(tmp_dir, f"arr_{i}.npy"), arr)
        manifest["leaves"].append({"shape": list(arr.shape), "dtype": dtype})
    with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp_dir, "_COMMITTED"), "w") as f:
        f.write(str(time.time()))
    if os.path.exists(step_dir):
        shutil.rmtree(step_dir)
    os.rename(tmp_dir, step_dir)   # atomic publish
    return step_dir


def load(step_dir: str, like: Any) -> Tuple[int, Any, dict]:
    """Load into the structure of ``like`` (leaf count and shapes checked;
    each leaf on ``like``'s leaf's device, in its type). Returns (step,
    tree, extra)."""
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    leaves_like, rebuild, _ = _flatten(like)
    if manifest["n_leaves"] != len(leaves_like):
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                         f"expected {len(leaves_like)}: incompatible tree")
    leaves = []
    for i, (ref, meta) in enumerate(zip(leaves_like, manifest["leaves"])):
        arr = np.load(os.path.join(step_dir, f"arr_{i}.npy"))
        want = tuple(ref.shape) if torch.is_tensor(ref) else np.shape(ref)
        if tuple(arr.shape) != tuple(want):
            raise ValueError(f"leaf {i}: shape {arr.shape}, expected {want}")
        t = torch.from_numpy(arr)
        if meta["dtype"] == "bfloat16":
            t = t.view(torch.bfloat16)
        if torch.is_tensor(ref):
            t = t.to(device=ref.device, dtype=ref.dtype)
        leaves.append(t)
    return manifest["step"], rebuild(leaves), manifest.get("extra", {})


def latest_step_dir(path: str) -> Optional[str]:
    """The newest committed step's directory under ``path``, or None."""
    if not os.path.isdir(path):
        return None
    steps = sorted(d for d in os.listdir(path)
                   if d.startswith("step_") and not d.endswith(".tmp")
                   and os.path.exists(os.path.join(path, d, "_COMMITTED")))
    return os.path.join(path, steps[-1]) if steps else None


def load_latest(path: str, like: Any):
    """Returns (step, tree, extra) or None: the restart entry point."""
    d = latest_step_dir(path)
    if d is None:
        return None
    return load(d, like)


class AsyncCheckpointer:
    """Overlap serialization with compute: ``save()`` returns once the
    leaves are on the host; one writer thread serializes them, in order."""

    def __init__(self, path: str, keep: int = 3):
        self.path = path
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None

    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        self.wait()
        leaves, _, desc = _flatten(tree)
        host = [_to_host(x) for x in leaves]   # the copy, now

        def run():
            try:
                _write(self.path, step, desc, host, extra)
                self._gc()
            except BaseException as e:  # surfaced on the next wait()
                self._err = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def _gc(self):
        steps = sorted(d for d in os.listdir(self.path)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for d in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.path, d), ignore_errors=True)
