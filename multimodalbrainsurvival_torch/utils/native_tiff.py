"""ctypes binding of the libtiff test writers of ``native/tiff_slide.cc``.

``write_test_pyramid`` and ``SlideBuilder`` fabricate scanner-style
pyramidal TIFFs (tiled levels, stripped associated images, libtiff-encoded
or pre-encoded blocks) for the tests, where libtiff is installed; the port
reads slides with its own reader (``data/tiler.py::TiffSlide``), and the
source's reader entries are not bound here.

The source is compiled as it is, with ``g++ -O3 -shared -fPIC -std=c++17
... -ltiff``, into ``kernels/build/libtiffslide-<digest>.so``, the digest
over the source and the flags, as ``data/native.py`` builds the patch
loader: the compiler writes a file named after its process and
``os.replace`` moves it into place, so processes that build at once never
load a partial library. It is built on first use, never when this module is
imported. A failed build (no g++, no libtiff headers) raises with the
compiler's output.
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

SOURCE = Path(__file__).resolve().parents[2] / "native" / "tiff_slide.cc"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LINK_FLAGS = ("-ltiff",)

_lock = threading.Lock()
_loaded: dict[Path, ctypes.CDLL] = {}

_P_INT = ctypes.POINTER(ctypes.c_int)
_P_U8 = ctypes.POINTER(ctypes.c_uint8)
#: (entry, restype, argtypes) of the writer entries of ``tiff_slide.cc``
_SIGNATURES = (
    ("tiff_slide_write_test", ctypes.c_int,
     [ctypes.c_char_p, ctypes.POINTER(ctypes.c_char_p), _P_INT, _P_INT, ctypes.c_int,
      ctypes.c_int, ctypes.c_int, ctypes.c_char_p]),
    ("tiff_builder_open", ctypes.c_void_p, [ctypes.c_char_p]),
    ("tiff_builder_dir_begin", ctypes.c_int,
     [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
      ctypes.c_char_p]),
    ("tiff_builder_write_raw_tile", ctypes.c_int,
     [ctypes.c_void_p, ctypes.c_int, _P_U8, ctypes.c_int64]),
    ("tiff_builder_write_rgb", ctypes.c_int,
     [ctypes.c_void_p, _P_U8, ctypes.c_int, ctypes.c_int, ctypes.c_int]),
    ("tiff_builder_dir_end", ctypes.c_int, [ctypes.c_void_p]),
    ("tiff_builder_close", None, [ctypes.c_void_p]),
)


def library_path(build_dir: Path | None = None) -> Path:
    """``<build_dir>/libtiffslide-<digest>.so`` (``BUILD_DIR`` by default)."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(GXX_FLAGS + LINK_FLAGS).encode()
    ).hexdigest()[:16]
    return Path(build_dir or BUILD_DIR) / f"libtiffslide-{digest}.so"


def build(build_dir: Path | None = None) -> Path:
    """Compile the library unless this digest is built; raise with g++'s
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
        raise RuntimeError("g++ not found: the libtiff test writers are built with g++ "
                           "and libtiff's headers") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SOURCE} ({' '.join(cmd)}); the test writers "
                           f"need libtiff's headers and library:\n"
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
            for name, restype, argtypes in _SIGNATURES:
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _loaded[path] = lib
    return lib


def _u8(a: np.ndarray):
    return a.ctypes.data_as(_P_U8)


def write_test_pyramid(path: str, levels: list[np.ndarray], tile: int,
                       compression: str = "none", description: str = "") -> None:
    """Write a scanner-style pyramidal TIFF from RGB arrays, largest first:
    tiled directories with ``tile > 0``, stripped with 0; ``compression``
    ``"none"`` or ``"jpeg"`` (quality 90, lossy)."""
    lib = load()
    comp = {"none": 1, "jpeg": 7}[compression]
    levels = [np.ascontiguousarray(lvl, dtype=np.uint8) for lvl in levels]
    ptrs = (ctypes.c_char_p * len(levels))(
        *[lvl.ctypes.data_as(ctypes.c_char_p) for lvl in levels])
    ws = (ctypes.c_int * len(levels))(*[lvl.shape[1] for lvl in levels])
    hs = (ctypes.c_int * len(levels))(*[lvl.shape[0] for lvl in levels])
    rc = lib.tiff_slide_write_test(os.fsencode(path), ptrs, ws, hs, len(levels), tile,
                                   comp, description.encode())
    if rc != 0:
        raise OSError(f"tiff_slide_write_test failed (code {rc})")


class SlideBuilder:
    """Writes an ``.svs``-like TIFF a directory at a time: tiled pyramid
    levels (libtiff-encoded, or pre-encoded raw tiles under any compression
    tag) and stripped associated images with their descriptions."""

    def __init__(self, path: str):
        self._lib = load()
        self._b = self._lib.tiff_builder_open(os.fsencode(path))
        if not self._b:
            raise OSError(f"could not open {path} for writing")

    def _call(self, name: str, *args) -> None:
        if getattr(self._lib, name)(self._b, *args):
            raise OSError(f"{name} failed")

    def add_rgb_dir(self, img: np.ndarray, tile: int = 0, compression: int = 1,
                    description: str = "") -> None:
        """One directory encoded by libtiff (``tile`` 0: stripped)."""
        img = np.ascontiguousarray(img, dtype=np.uint8)
        h, w = img.shape[:2]
        self._call("tiff_builder_dir_begin", w, h, tile, compression, description.encode())
        self._call("tiff_builder_write_rgb", _u8(img), w, h, tile)
        self._call("tiff_builder_dir_end")

    def add_raw_tiled_dir(self, w: int, h: int, tile: int, tiles: list[bytes],
                          compression: int, description: str = "") -> None:
        """One tiled directory of pre-encoded tiles, row-major over the
        ``ceil(w / tile) x ceil(h / tile)`` grid."""
        self._call("tiff_builder_dir_begin", w, h, tile, compression, description.encode())
        for idx, data in enumerate(tiles):
            buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
            self._call("tiff_builder_write_raw_tile", idx, buf, len(data))
        self._call("tiff_builder_dir_end")

    def close(self) -> None:
        if self._b:
            self._lib.tiff_builder_close(self._b)
            self._b = None
