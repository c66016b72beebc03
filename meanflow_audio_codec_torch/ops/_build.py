"""Build the port's native sources and load them through ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles with nvcc on
its own into ``build/lib<name>-<digest>.so`` inside the package, where the
digest covers the source, the shared headers ``csrc/*.cuh`` and the flags, so
an edited source or header is rebuilt and an unchanged one is reused. The
host C++ sources the port binds (``HOST_SOURCES``: the repository's
``native/entropy.cpp``, the rANS coder, and ``native/dataloader.cpp``, the
audio loader) compile the same way with g++, each with its own flags
(``host_flags``), the digest covering the source and those flags. Sources
build in parallel, one compiler each, at first use; nothing is compiled
when a module is imported.
A failed build raises with the compiler's output: there is no fallback.
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
#: host C++ sources by library name (built with g++, never edited here)
HOST_SOURCES = {"entropy": PACKAGE_DIR.parent / "native" / "entropy.cpp",
                "dataloader": PACKAGE_DIR.parent / "native" / "dataloader.cpp"}
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
#: flags a host source takes beyond ``GXX_FLAGS`` (the loader's threads)
HOST_EXTRA_FLAGS = {"dataloader": ("-pthread",)}

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


def _source(name: str) -> Path:
    return HOST_SOURCES.get(name, CSRC_DIR / f"{name}.cu")


def host_flags(name: str) -> tuple[str, ...]:
    """g++'s flags for the host source ``name``."""
    return GXX_FLAGS + HOST_EXTRA_FLAGS.get(name, ())


def library_path(name: str) -> Path:
    """Where the compiled ``name`` library lives (built or not)."""
    if name in HOST_SOURCES:
        text, flags = _source(name).read_bytes(), host_flags(name)
    else:
        text = _source(name).read_bytes() + b"".join(
            header.read_bytes() for header in sorted(CSRC_DIR.glob("*.cuh")))
        flags = NVCC_FLAGS
    digest = hashlib.sha256(text + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: tuple[str, ...] = SOURCES) -> dict[str, str]:
    """Compile every missing library in ``names``, all compilers at once.

    Returns the compiler's output (for the CUDA sources, register and
    shared-memory use from ``-Xptxas -v``) for each library built now;
    raises if any build fails.
    """
    pending = {name: library_path(name) for name in names
               if not library_path(name).exists()}
    if not pending:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, target in pending.items():
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        if name in HOST_SOURCES:
            compiler = [shutil.which("g++") or "g++", *host_flags(name)]
        else:
            compiler = [_nvcc(), *NVCC_FLAGS]
        cmd = [*compiler, "-o", str(tmp), str(_source(name))]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failures = {}, []
    for name, (tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failures.append(f"{Path(proc.args[0]).name} failed for "
                            f"{_source(name).name}:\n{logs[name]}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, pending[name])
    if failures:
        raise RuntimeError("\n".join(failures))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded ``name`` library, built first if it is missing."""
    if name not in _libraries:
        build((name,))
        _libraries[name] = ctypes.CDLL(str(library_path(name)))
    return _libraries[name]
