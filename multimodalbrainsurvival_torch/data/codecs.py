"""ctypes binding of the port's slide codecs, built from ``data/csrc/tiff_codecs.cc``
and ``data/csrc/j2k.cc``.

Three uses: ``decode_blocks`` decodes the tiles or strips of one TIFF
directory that a region needs (JPEG, LZW, deflate, PackBits or none, with
the horizontal predictor, and Aperio's JPEG 2000 tiles, 33003 / 33005) in
one call, on a pool of C++ threads with the GIL released, straight into the
caller's buffer as RGB; ``decode_jpeg`` decodes a whole JPEG file and
``decode_j2k`` a whole JPEG 2000 codestream. The JPEG decoder reads
libjpeg-turbo's default decode bit for bit (the islow IDCT, fancy
upsampling, its YCbCr → RGB and its guess of the colour space); the JPEG
2000 decoder keeps to OpenJPEG 2.5's reconstruction and Pillow's unpack and
YCbCr → RGB (see each source's header).

The sources are compiled together with ``g++ -O3 -shared -fPIC -std=c++17
-ffp-contract=off ... -lz -lpthread`` into
``kernels/build/libtiffcodecs-<digest>.so``, the digest over the sources,
the header and the flags, as ``data/native.py`` builds the patch loader
(no ``-ffast-math``, and no fused multiply-adds, so the 9/7 wavelet's float
steps round alike on every machine): the compiler writes a file named after its process and
``os.replace`` moves it into place, so processes that build at once never
load a partial library. It is built on first use, never when this module
is imported. A failed build raises with the compiler's output, and a block
that does not decode raises naming what it could not read: there is no
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

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "tiff_codecs.cc", CSRC / "j2k.cc")
HEADERS = (CSRC / "j2k.h",)
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")
LINK_FLAGS = ("-lz", "-lpthread")
#: threads a decode call uses unless its caller says otherwise
DEFAULT_THREADS = min(4, len(os.sched_getaffinity(0)))
#: the codecs' error codes (``tiff_codecs.cc``'s ``enum Code``)
ERRORS = {
    1: "cannot open the file", 2: "short read", 3: "truncated data", 4: "corrupt data",
    5: "unsupported compression", 6: "unsupported predictor",
    7: "unsupported photometric interpretation or samples per pixel",
    8: "progressive or hierarchical JPEG", 9: "arithmetic-coded JPEG",
    10: "lossless JPEG", 11: "JPEG sample precision other than 8 bits",
    12: "JPEG sampling factors that are not integral ratios",
    13: "JPEG with neither 1 nor 3 components", 14: "JPEG table never defined",
    15: "JPEG height given by a DNL marker", 16: "old-style (LSB-first) LZW",
    17: "zlib error", 18: "empty block",
    19: "JPEG 2000 progression order change (POC marker)",
    20: "JPEG 2000 region of interest (RGN marker)",
    21: "JPEG 2000 packed packet headers in the main header (PPM marker)",
    22: "JPEG 2000 packed packet headers in a tile-part header (PPT marker)",
    23: "a JPEG 2000 marker the decoder does not read",
    24: "signed JPEG 2000 components", 25: "JPEG 2000 precision other than 8 bits",
    26: "subsampled JPEG 2000 components (XRsiz / YRsiz other than 1)",
    27: "more than 4 JPEG 2000 components",
    28: "JPEG 2000 code-block style 0x01 (selective arithmetic coding bypass)",
    29: "JPEG 2000 code-block style 0x02 (context reset on each pass)",
    30: "JPEG 2000 code-block style 0x04 (termination on each pass)",
    31: "JPEG 2000 code-block style 0x08 (vertically causal context)",
    32: "JPEG 2000 code-block style 0x10 (predictable termination)",
    33: "JPEG 2000 code-block style 0x20 (segmentation symbols)",
    34: "JPEG 2000 code-block style 0x40 / 0x80 (Part 2 or high-throughput blocks)",
    35: "a JPEG 2000 component transform other than none, RCT or ICT",
}

_lock = threading.Lock()
_loaded: dict[Path, ctypes.CDLL] = {}

_P_I64 = ctypes.POINTER(ctypes.c_int64)
_P_I32 = ctypes.POINTER(ctypes.c_int32)
_P_INT = ctypes.POINTER(ctypes.c_int)
_P_U8 = ctypes.POINTER(ctypes.c_uint8)
_SIGNATURES = (
    ("tiff_decode_blocks", ctypes.c_int,
     [ctypes.c_char_p, _P_I64, _P_I64, _P_I32, ctypes.c_int, ctypes.c_int, ctypes.c_int,
      ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P_U8, ctypes.c_int64, _P_U8,
      ctypes.c_int, _P_I32]),
    ("jpeg_frame_info", ctypes.c_int, [_P_U8, ctypes.c_int64, _P_INT, _P_INT, _P_INT]),
    ("jpeg_decode_rgb", ctypes.c_int, [_P_U8, ctypes.c_int64, _P_U8, ctypes.c_int,
                                       ctypes.c_int]),
    ("j2k_info", ctypes.c_int, [_P_U8, ctypes.c_int64, _P_INT, _P_INT, _P_INT]),
    ("j2k_decode", ctypes.c_int, [_P_U8, ctypes.c_int64, ctypes.c_int, _P_U8, ctypes.c_int,
                                  ctypes.c_int]),
)


class DecodeError(ValueError):
    """A block or file the codecs cannot read; ``code`` is the codec's."""

    def __init__(self, message: str, code: int):
        super().__init__(message)
        self.code = code


def describe(code: int) -> str:
    return f"{ERRORS.get(code, 'error')} (code {code})"


def library_path(build_dir: Path | None = None) -> Path:
    """``<build_dir>/libtiffcodecs-<digest>.so`` (``BUILD_DIR`` by default)."""
    digest = hashlib.sha256(
        b"".join(f.read_bytes() for f in SOURCES + HEADERS)
        + " ".join(GXX_FLAGS + LINK_FLAGS).encode()
    ).hexdigest()[:16]
    return Path(build_dir or BUILD_DIR) / f"libtiffcodecs-{digest}.so"


def build(build_dir: Path | None = None) -> Path:
    """Compile the codecs unless this digest is built; raise with g++'s
    output if it fails. Returns the library's path."""
    out = library_path(build_dir)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *GXX_FLAGS, *map(str, SOURCES), "-o", str(tmp), *LINK_FLAGS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found: the slide codecs are built with g++ and "
                           "zlib's headers") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {CSRC} ({' '.join(cmd)}):\n"
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


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def decode_blocks(path: str, offsets, counts, rows, block_w: int, block_h: int, *,
                  compression: int, predictor: int = 1, photometric: int = 2,
                  samples: int = 3, jpeg_tables: bytes | None = None,
                  num_threads: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Decode blocks of one directory of the TIFF at ``path``: block i is
    ``counts[i]`` bytes at ``offsets[i]`` holding ``rows[i]`` rows of
    ``block_w`` pixels. Returns ``(blocks, codes)``: an (n, block_h,
    block_w, 3) uint8 RGB array (rows past ``rows[i]`` zero) and each
    block's code (0, or a key of ``ERRORS``). ``num_threads`` defaults to
    ``DEFAULT_THREADS``."""
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    n = len(offsets)
    if counts.shape != (n,) or rows.shape != (n,):
        raise ValueError("offsets, counts and rows need one entry per block")
    if block_w <= 0 or block_h <= 0 or (rows > block_h).any() or (rows < 0).any():
        raise ValueError(f"bad block geometry {block_w} x {block_h}, rows {rows}")
    out = np.zeros((n, block_h, block_w, 3), np.uint8)
    codes = np.zeros(n, np.int32)
    if n == 0:
        return out, codes
    tables = np.frombuffer(jpeg_tables or b"\0", np.uint8)
    lib = load()
    rc = lib.tiff_decode_blocks(
        os.fsencode(path), _ptr(offsets, _P_I64), _ptr(counts, _P_I64), _ptr(rows, _P_I32),
        n, block_w, block_h, compression, predictor, photometric, samples,
        _ptr(tables, _P_U8), len(jpeg_tables or b""), _ptr(out, _P_U8),
        max(1, num_threads or DEFAULT_THREADS),
        _ptr(codes, _P_I32))
    if rc < 0:
        raise OSError(f"cannot open {path}")
    return out, codes


def jpeg_frame(data: bytes) -> tuple[int, int, int, int]:
    """``(code, width, height, components)`` of a JPEG stream's frame."""
    buf = np.frombuffer(data, np.uint8)
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    code = load().jpeg_frame_info(_ptr(buf, _P_U8), len(buf), ctypes.byref(w),
                                  ctypes.byref(h), ctypes.byref(c))
    return code, w.value, h.value, c.value


def decode_jpeg(data: bytes, name: str = "JPEG stream") -> np.ndarray:
    """A whole JPEG stream → (height, width, 3) uint8 RGB, as libjpeg
    decodes it by default; raises ``DecodeError`` naming ``name`` and what
    it cannot read."""
    code, w, h, _ = jpeg_frame(data)
    if code:
        raise DecodeError(f"cannot decode {name}: {describe(code)}", code)
    out = np.zeros((h, w, 3), np.uint8)
    buf = np.frombuffer(data, np.uint8)
    code = load().jpeg_decode_rgb(_ptr(buf, _P_U8), len(buf), _ptr(out, _P_U8), w, h)
    if code:
        raise DecodeError(f"cannot decode {name}: {describe(code)}", code)
    return out


def j2k_info(data: bytes) -> tuple[int, int, int, int]:
    """``(code, width, height, components)`` of a JPEG 2000 codestream's image."""
    buf = np.frombuffer(data, np.uint8)
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    code = load().j2k_info(_ptr(buf, _P_U8), len(buf), ctypes.byref(w), ctypes.byref(h),
                           ctypes.byref(c))
    return code, w.value, h.value, c.value


def decode_j2k(data: bytes, ycbcr: bool = False, name: str = "JPEG 2000 codestream"
               ) -> np.ndarray:
    """A bare JPEG 2000 codestream → (height, width, 3) uint8 RGB, as Pillow
    decodes it and converts it to RGB; ``ycbcr``: the components are Y, Cb,
    Cr (Aperio's compression 33003) and go through Pillow's YCbCr → RGB.
    Raises ``DecodeError`` naming ``name`` and what it cannot read."""
    code, w, h, _ = j2k_info(data)
    if code:
        raise DecodeError(f"cannot decode {name}: {describe(code)}", code)
    out = np.zeros((h, w, 3), np.uint8)
    buf = np.frombuffer(data, np.uint8)
    code = load().j2k_decode(_ptr(buf, _P_U8), len(buf), int(ycbcr), _ptr(out, _P_U8), w, h)
    if code:
        raise DecodeError(f"cannot decode {name}: {describe(code)}", code)
    return out
