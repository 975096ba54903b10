"""The JAX package's libtiff slide reader for the port's tests, steady under
pytest-xdist.

The JAX binding (``multimodalbrainsurvival_tpu/utils/native_tiff.py``)
builds ``native/libtiffslide.so`` with g++ writing straight to that path,
and latches ``_load_failed`` for the life of the process when a load fails.
A worker that loads the file while another worker's compiler is still
writing it would fail every later test that reads a slide through the JAX
reader. ``jax_tiff_library`` takes an ``fcntl`` lock, builds the library
itself into a file of its own that it renames into place when it is missing
or older than its source (so no half-written library is ever at that path
on its account), and then loads it through the JAX ``get_library``. When
that still fails while another process is writing the file, it waits for
the file to settle, clears the latch and tries once more. The JAX package
is not edited.
"""

from __future__ import annotations

import fcntl
import os
import subprocess
import time

from multimodalbrainsurvival_torch.kernels.build import BUILD_DIR
from multimodalbrainsurvival_tpu.data import tiler as jax_tiler
from multimodalbrainsurvival_tpu.utils import native_tiff as jax_native_tiff

LOCK = BUILD_DIR / "jax-libtiffslide.lock"
SETTLE_S, SETTLE_TIMEOUT_S = 1.0, 180.0


def _build_in_place() -> None:
    """The JAX build's command, written to a temporary file and renamed
    into place; nothing when the library is newer than its source."""
    src, lib = jax_native_tiff._SRC, jax_native_tiff._LIB
    if os.path.isfile(lib) and os.path.getmtime(lib) >= os.path.getmtime(src):
        return
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", src, "-o", tmp,
                           "-ltiff"], capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"the JAX libtiff reader did not build:\n{proc.stderr}")
    os.replace(tmp, lib)


def _wait_until_settled(path: str) -> None:
    """Until ``path`` exists and its size and mtime stay put for ``SETTLE_S``."""
    deadline = time.monotonic() + SETTLE_TIMEOUT_S
    last = None
    while time.monotonic() < deadline:
        try:
            st = os.stat(path)
            now = (st.st_size, st.st_mtime_ns)
        except FileNotFoundError:
            now = None
        if now is not None and now == last:
            return
        last = now
        time.sleep(SETTLE_S)
    raise RuntimeError(f"{path} did not settle in {SETTLE_TIMEOUT_S:.0f} s")


def jax_tiff_library():
    """The JAX package's loaded libtiff reader; raises when it cannot be had."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(LOCK, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            _build_in_place()
            lib = jax_native_tiff.get_library()
            if lib is None:
                _wait_until_settled(jax_native_tiff._LIB)
                with jax_native_tiff._lock:
                    jax_native_tiff._load_failed = False
                    jax_native_tiff._lib = None
                lib = jax_native_tiff.get_library()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    if lib is None:
        raise RuntimeError("the JAX libtiff reader (native/libtiffslide.so) did not load")
    return lib


def jax_native_tiff_slide(path: str):
    """The JAX ``NativeTiffSlide`` of ``path``, its library loaded first."""
    jax_tiff_library()
    return jax_tiler.NativeTiffSlide(path)
