"""Build the port's CUDA sources with nvcc and load them through ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``build/lib<name>-<digest>.so`` inside the package, where the digest
covers the source, the shared headers ``csrc/*.cuh`` and the flags, so an
edited source or header is rebuilt and an unchanged one is reused. Sources
build in parallel, one ``nvcc`` each, at first use; nothing is compiled when
a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
SOURCES = ("mdct", "imdct", "stage")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libraries: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None:
        candidate = Path(CUDA_HOME) / "bin" / "nvcc"
        if candidate.exists():
            return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path(name: str) -> Path:
    """Where the compiled ``name`` kernel library lives (built or not)."""
    text = (CSRC_DIR / f"{name}.cu").read_bytes() + b"".join(
        header.read_bytes() for header in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: tuple[str, ...] = SOURCES) -> dict[str, str]:
    """Compile every missing library in ``names``, all nvcc runs at once.

    Returns the compiler's output (register and shared-memory use from
    ``-Xptxas -v``) for each library built now; raises if any build fails.
    """
    pending = {name: library_path(name) for name in names
               if not library_path(name).exists()}
    if not pending:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, target in pending.items():
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failures = {}, []
    for name, (tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu:\n{logs[name]}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, pending[name])
    if failures:
        raise RuntimeError("\n".join(failures))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded ``name`` kernel library, built first if it is missing."""
    if name not in _libraries:
        build((name,))
        _libraries[name] = ctypes.CDLL(str(library_path(name)))
    return _libraries[name]
