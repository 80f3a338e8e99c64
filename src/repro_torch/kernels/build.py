"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into ``build/repro_torch_kernels/`` at the repository root
(listed in ``.gitignore``), then loaded with ``ctypes``. A library is named
after a hash of its source and flags, so an edited source is rebuilt and an
unchanged one is reused. ``nvcc``'s output, with ``-Xptxas=-v``'s register
and spill counts, is kept beside each library as ``<name>.log``;
``ptxas_report`` reads those counts back per kernel, ``sass_counts``
counts an instruction in a library's machine code (``cuobjdump -sass``),
and ``instantiation_report`` joins the two for one kernel's template
instantiations.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
NVCC_TIMEOUT_S = 600


def nvcc() -> str:
    """The CUDA compiler: under PyTorch's CUDA_HOME, else on PATH."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is not None:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are built on a machine with the CUDA toolkit")
    return found


def library_path(source: Path) -> Path:
    """Where ``source``'s library lives: named by a hash of source + flags."""
    digest = hashlib.sha256(Path(source).read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}_{digest}.so"


def build_libraries(sources: Sequence[Path]) -> Dict[Path, Path]:
    """Compile every source whose library is missing, one ``nvcc`` each,
    all started together. Returns {source: library path}; raises with the
    compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {Path(s): library_path(Path(s)) for s in sources}
    todo = {s: lib for s, lib in out.items() if not lib.exists()}
    procs = {}
    for src, lib in todo.items():
        tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, lib)
    failed = []
    for src, (proc, tmp, lib) in procs.items():
        try:
            log, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
        lib.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{src}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


def parse_ptxas(log: str) -> Dict[str, Dict[str, int]]:
    """-Xptxas=-v's lines, per kernel (mangled name): registers, spill
    stores and spill loads (bytes), stack frame (bytes)."""
    out: Dict[str, Dict[str, int]] = {}
    fn = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?([\w$.]+)'?", line)
        if m:
            fn = m.group(1)
            out.setdefault(fn, {})
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[fn].update(stack_frame=int(m.group(1)),
                           spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[fn]["registers"] = int(m.group(1))
    return out


def ptxas_report(library: Path) -> Dict[str, Dict[str, int]]:
    """``parse_ptxas`` of the build log kept beside ``library``."""
    return parse_ptxas(Path(library).with_suffix(".log").read_text())


def instantiation_report(ptxas: Dict[str, Dict[str, int]],
                         hmma: Optional[Dict[str, int]], pattern: re.Pattern,
                         name: Callable[[re.Match], str]) -> Dict[str, dict]:
    """The kernels of ``ptxas`` (``parse_ptxas``'s output) whose mangled name
    ``pattern`` matches, keyed by ``name(match)``: registers and spills, and
    HMMA instructions from ``hmma`` (``parse_sass_counts``'s output; None
    where the listing was not read)."""
    out = {}
    for fn, rec in ptxas.items():
        m = pattern.search(fn)
        if m:
            out[name(m)] = {**rec,
                            "hmma": None if hmma is None else hmma.get(fn, 0)}
    return dict(sorted(out.items()))


def parse_sass_counts(sass: str, opcode: str) -> Dict[str, int]:
    """Instructions whose opcode starts with ``opcode`` (HMMA.1688.F32.TF32
    counts as HMMA), per function of ``cuobjdump -sass``'s listing."""
    out: Dict[str, int] = {}
    fn = None
    pat = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                     + re.escape(opcode) + r"\b")
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out.setdefault(fn, 0)
        elif fn is not None and pat.search(line):
            out[fn] += 1
    return out


def sass_counts(library: Path, opcode: str) -> Optional[Dict[str, int]]:
    """``parse_sass_counts`` of ``cuobjdump -sass library``; None where the
    toolkit has no cuobjdump."""
    tool = Path(nvcc()).parent / "cuobjdump"
    if not tool.exists():
        found = shutil.which("cuobjdump")
        if found is None:
            return None
        tool = Path(found)
    sass = subprocess.run([str(tool), "-sass", str(library)],
                          capture_output=True, text=True, check=True,
                          timeout=NVCC_TIMEOUT_S).stdout
    return parse_sass_counts(sass, opcode)


@lru_cache(maxsize=None)
def load_library(source: Path) -> ctypes.CDLL:
    """Build ``source`` if needed and load it (once per process)."""
    return ctypes.CDLL(str(build_libraries([Path(source)])[Path(source)]))
