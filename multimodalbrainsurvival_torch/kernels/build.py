"""Build the port's CUDA sources into shared libraries with a C interface.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
``build/lib<name>-<digest>.so`` at first use and loaded with ``ctypes``. The
digest covers the source, every header it includes from ``csrc/``
(``hopper.cuh``) and the flags, so a changed source or header is rebuilt and
a stale library is never loaded. The build directory is not part of the
repository. Nothing is compiled or loaded when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
KERNEL_SOURCES = ("attention_pool", "qmm_requant", "dropout_matmul", "fused_stage")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}
#: nvcc's output (ptxas registers / shared memory / spills) per source built
#: by this process.
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin); the "
            "CUDA kernels are built on the machine with the card"
        )
    return nvcc


def _sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and the ``csrc/`` headers it includes, directly or
    through another header (``#include "..."``), each once."""
    found, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in found:
            continue
        found.append(path)
        for inc in re.findall(r'^\s*#\s*include\s*"([^"]+)"', path.read_text(),
                              flags=re.MULTILINE):
            todo.append(CSRC / inc)
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256(
        b"".join(p.read_bytes() for p in _sources(name)) + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: tuple[str, ...] = KERNEL_SOURCES) -> dict[str, Path]:
    """Compile every source in ``names`` that is not built yet, one ``nvcc``
    per source, all started together; raise with nvcc's output if any
    fails. Returns each library's path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pending = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        pending[name] = (proc, tmp, out)
    failed = []
    for name, (proc, tmp, out) in pending.items():
        build_logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(build_logs[n] for n in failed)
        )
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` (built on first use)."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build((name,))[name]))
        _loaded[name] = lib
    return lib
