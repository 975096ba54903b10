"""ctypes binding of the C++ patch loader, built from ``native/patch_loader.cc``.

The port's own binding of the loader the JAX package binds in
``multimodalbrainsurvival_tpu/utils/native.py:44-165``: two C entries,
``assemble_patch_batch`` (a whole batch in one call: shard rows copied
with ``memcpy``, PNGs decoded (zlib) and resized by a C++ thread pool,
straight into the batch buffer, with the GIL released) and
``decode_patch_batch`` (PNGs alone).

The source is compiled as it is, with ``g++ -O3 -shared -fPIC -std=c++17
... -lz -lpthread``, into ``kernels/build/libpatchloader-<digest>.so``, the
digest over the source and the flags, as ``kernels/build.py`` builds the
CUDA sources: the compiler writes a file named after its process and
``os.replace`` moves it into place, so processes that build at once never
load a partial library. It is built on first use, never when this module
is imported. The JAX package's ``native/libpatchloader.so`` is neither
built nor loaded here. A failed build raises with the compiler's output,
and a PNG the loader cannot decode raises naming the file: there is no
other decoder to fall back on.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from multimodalbrainsurvival_torch.kernels.build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / "native" / "patch_loader.cc"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LINK_FLAGS = ("-lz", "-lpthread")
#: the assembler's code for a shard row whose size is not the batch's
RESIZE_CODE = 200
#: the loader's per-file codes (``native/patch_loader.cc``)
DECODE_ERRORS = {
    1: "not a PNG", 2: "truncated chunk", 3: "bad IHDR",
    4: "not 8-bit non-interlaced", 5: "unsupported colour type",
    6: "zlib inflate failed", 7: "bad filter", 100: "cannot open",
    101: "empty file", 102: "short read",
}

_lock = threading.Lock()
_loaded: dict[Path, ctypes.CDLL] = {}


def library_path(build_dir: Path | None = None) -> Path:
    """``<build_dir>/libpatchloader-<digest>.so`` (``BUILD_DIR`` by
    default)."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(GXX_FLAGS + LINK_FLAGS).encode()
    ).hexdigest()[:16]
    return Path(build_dir or BUILD_DIR) / f"libpatchloader-{digest}.so"


def build(build_dir: Path | None = None) -> Path:
    """Compile the loader unless this digest is built; raise with g++'s
    output if it fails. Returns the library's path."""
    out = library_path(build_dir)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp), *LINK_FLAGS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found: the patch loader is built with g++ and "
                           "zlib's headers") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SOURCE} ({' '.join(cmd)}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load(build_dir: Path | None = None) -> ctypes.CDLL:
    """The loaded library (built on first use), its entries declared."""
    path = library_path(build_dir)
    with _lock:
        lib = _loaded.get(path)
        if lib is None:
            lib = ctypes.CDLL(str(build(build_dir)))
            lib.decode_patch_batch.restype = ctypes.c_int
            lib.decode_patch_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.POINTER(ctypes.c_int),
            ]
            lib.assemble_patch_batch.restype = ctypes.c_int
            lib.assemble_patch_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),   # paths (NULL-able)
                ctypes.POINTER(ctypes.c_void_p),   # shard rows (NULL-able)
                ctypes.POINTER(ctypes.c_int),      # each row's height
                ctypes.POINTER(ctypes.c_int),      # each row's width
                ctypes.c_int,                      # slots
                ctypes.POINTER(ctypes.c_uint8),    # out (n, h, w, 3)
                ctypes.c_int, ctypes.c_int,        # h, w
                ctypes.c_int,                      # threads
                ctypes.POINTER(ctypes.c_int),      # codes
            ]
            _loaded[path] = lib
    return lib


def _check_out(out: np.ndarray, n: int) -> None:
    if (out.ndim != 4 or out.shape[0] != n or out.shape[3] != 3
            or out.dtype != np.uint8 or not out.flags.c_contiguous):
        raise ValueError(f"out must be a C-contiguous (n={n}, h, w, 3) uint8 array, "
                         f"got {out.shape} {out.dtype}")


def raise_decode_errors(codes: np.ndarray, paths: list) -> None:
    """Raise for the first slot whose PNG did not decode, naming it."""
    for slot in np.flatnonzero((codes != 0) & (codes != RESIZE_CODE)):
        code = int(codes[slot])
        raise ValueError(f"cannot decode patch {paths[slot]}: "
                         f"{DECODE_ERRORS.get(code, 'error')} (code {code})")


def decode_patch_batch(paths: list[str], out: np.ndarray, num_threads: int = 8) -> None:
    """Decode the PNGs at ``paths`` into ``out`` (n, h, w, 3) uint8, each
    resized (bilinear) to h x w where its size differs; raises naming the
    first file that does not decode."""
    _check_out(out, len(paths))
    lib = load()
    n = len(paths)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    codes = np.zeros(n, np.int32)
    lib.decode_patch_batch(arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                           out.shape[1], out.shape[2], num_threads,
                           codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    raise_decode_errors(codes, paths)


def assemble_patch_batch(paths: list, srcs: np.ndarray, src_h: np.ndarray,
                         src_w: np.ndarray, out: np.ndarray,
                         num_threads: int = 8) -> np.ndarray:
    """Fill ``out`` (n, h, w, 3) uint8 in one native call: slot i is copied
    from the RGB row at address ``srcs[i]`` (a shard row of ``src_h[i]`` x
    ``src_w[i]``) where that is not 0, else decoded from the PNG
    ``paths[i]`` where that is not None, else left as it is. The caller
    keeps the rows' arrays alive. Raises naming the first PNG that does not
    decode; returns the per-slot codes, where ``RESIZE_CODE`` marks a shard
    row of another size, left for the caller to resize."""
    n = len(paths)
    _check_out(out, n)
    srcs = np.ascontiguousarray(srcs, dtype=np.uintp)
    src_h = np.ascontiguousarray(src_h, dtype=np.int32)
    src_w = np.ascontiguousarray(src_w, dtype=np.int32)
    if srcs.shape != (n,) or src_h.shape != (n,) or src_w.shape != (n,):
        raise ValueError("paths, srcs, src_h and src_w need one entry per slot")
    lib = load()
    path_arr = (ctypes.c_char_p * n)(*[None if p is None else os.fsencode(p)
                                       for p in paths])
    codes = np.zeros(n, np.int32)
    lib.assemble_patch_batch(
        path_arr, srcs.ctypes.data_as(ctypes.POINTER(ctypes.c_void_p)),
        src_h.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        src_w.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.shape[1], out.shape[2],
        num_threads, codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    raise_decode_errors(codes, paths)
    return codes
