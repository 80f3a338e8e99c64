"""Provenance stamping for benchmark artifacts — port of
``repro.obs.provenance``.

Every BENCH JSON the port emits embeds :func:`provenance_block` so a number
can always be traced back to the code and machine that produced it — git
SHA (+dirty flag), the torch and CUDA versions, the run's backend
(``"cuda"`` or ``"cpu"``), the card's name and power limit, platform
string, CPU count, UTC timestamp and the CLI args the run was invoked
with. Bench trajectories across PRs and machines are only comparable when
this block says they are; a card may run below its maximum power limit,
and then slower, so the limit is part of the machine.

Everything degrades to ``None`` rather than raising (e.g. git absent, no
card, no ``nvidia-smi``): provenance must never be the reason a benchmark
fails.

The block also carries a **config digest** (:func:`config_digest` — a
sha256 over the run's canonicalized configuration: bench args + solver
config) and the **seed list** the run consumed.
``python -m repro_torch.tools.bench_compare`` refuses to compare two BENCH
files whose digests differ — a tolerance policy is meaningless across
different workloads, and "the numbers moved" must never be confused with
"the experiment changed".
"""
from __future__ import annotations

import hashlib
import json
import os
import platform
import subprocess
import sys
from datetime import datetime, timezone
from typing import Any, Dict, List, Optional, Sequence

import torch

from ..device import DeviceLike

__all__ = ["git_sha", "config_digest", "provenance_block"]


def git_sha(repo_dir: Optional[str] = None) -> Optional[str]:
    """Current commit SHA, suffixed ``+dirty`` when the tree has
    uncommitted changes; None when git/worktree is unavailable."""
    try:
        kw: Dict[str, Any] = {"stderr": subprocess.DEVNULL, "text": True}
        if repo_dir is not None:
            kw["cwd"] = repo_dir
        sha = subprocess.check_output(
            ["git", "rev-parse", "HEAD"], **kw).strip()
        dirty = subprocess.check_output(
            ["git", "status", "--porcelain"], **kw).strip()
        return sha + ("+dirty" if dirty else "")
    except (OSError, subprocess.CalledProcessError):
        return None


def _canonical(obj: Any) -> Any:
    """Coerce a config value into a JSON-stable form: numpy or torch
    scalars/arrays to Python numbers/lists, tuples to lists, anything
    exotic to its repr — so the digest depends on VALUES, not container,
    dtype or library identity (a 0-dim tensor's ``shape`` equals ``()``)."""
    if isinstance(obj, dict):
        return {str(k): _canonical(v) for k, v in sorted(obj.items(),
                                                         key=lambda kv:
                                                         str(kv[0]))}
    if isinstance(obj, (list, tuple)):
        return [_canonical(v) for v in obj]
    if isinstance(obj, (str, bool)) or obj is None:
        return obj
    if isinstance(obj, (int, float)):
        return obj
    if hasattr(obj, "item") and getattr(obj, "shape", None) == ():
        return obj.item()                     # numpy/torch scalar
    if hasattr(obj, "tolist"):
        return obj.tolist()                   # numpy/torch array
    return repr(obj)


def config_digest(config: Any) -> str:
    """A short sha256 hex digest of the run's canonicalized configuration
    (bench args + solver config). Two BENCH files are comparable only when
    their digests match — ``bench_compare`` refuses otherwise. Dict key
    order, tuple-vs-list and numpy/torch-vs-Python scalar types do not
    affect the digest; values do."""
    blob = json.dumps(_canonical(config), sort_keys=True,
                      separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _card(dev: torch.device) -> Dict[str, Optional[str]]:
    """The card's name (``torch.cuda.get_device_name``) and power limit (as
    ``nvidia-smi --query-gpu=power.limit --format=csv,noheader`` prints
    it, the line of the device's index); None where either is not there."""
    name = power = None
    try:
        index = dev.index if dev.index is not None else 0
        name = torch.cuda.get_device_name(index)
        lines = subprocess.check_output(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], stderr=subprocess.DEVNULL,
            text=True, timeout=30).splitlines()
        power = lines[index].strip() if index < len(lines) else None
    except (RuntimeError, AssertionError, OSError,
            subprocess.SubprocessError):
        pass
    return {"device": name, "power_limit": power}


def provenance_block(argv: Optional[List[str]] = None,
                     config: Any = None,
                     seeds: Optional[Sequence[int]] = None,
                     device: DeviceLike = None) -> Dict[str, Any]:
    """The provenance dict embedded in every emitted BENCH JSON.

    ``argv`` should be the CLI args the bench was invoked with (defaults
    to ``sys.argv[1:]``). ``config`` is the run's full configuration (bench
    parameters + solver config), digested via :func:`config_digest` so
    ``bench_compare`` can refuse cross-config comparisons; ``seeds`` the
    RNG seeds the run consumed. Both stamp ``None`` when omitted.
    ``device`` is the run's device, ``None`` meaning ``"cuda"`` as at
    every entry point of the port: ``backend`` is ``"cuda"`` for a CUDA
    device, else ``"cpu"``; ``device`` and ``power_limit`` name the card,
    or are None (a CPU run, no card, no ``nvidia-smi``). In place of the
    reference's ``jax`` / ``jaxlib`` keys the block stamps ``torch`` and
    ``cuda`` (``torch.version.cuda``, None in a CPU build)."""
    try:
        dev = torch.device("cuda" if device is None else device)
    except (RuntimeError, TypeError):   # not a device: stamp what we can
        dev = None
    backend = None if dev is None else (
        "cuda" if dev.type == "cuda" else "cpu")
    card = (_card(dev) if backend == "cuda"
            else {"device": None, "power_limit": None})
    return {
        "git_sha": git_sha(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "backend": backend,
        **card,
        "platform": platform.platform(),
        "python": sys.version.split()[0],
        "cpu_count": os.cpu_count(),
        "timestamp_utc": datetime.now(timezone.utc).isoformat(),
        "argv": list(sys.argv[1:] if argv is None else argv),
        "config_digest": None if config is None else config_digest(config),
        "seeds": None if seeds is None else [int(s) for s in seeds],
    }
