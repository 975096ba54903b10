"""TIFF / BigTIFF container: directories, the slide level model, a small writer.

The reader parses classic TIFF (magic 42, 4-byte offsets) and BigTIFF
(magic 43, 8-byte offsets) in either byte order (``II``, ``MM``) with the
stdlib's ``struct`` and numpy, and keeps of each directory what the slide
reader needs: its size (256 / 257), samples (258, 277, 284), compression
(259), photometric interpretation (262), description (270), strips (273,
278, 279) or tiles (322-325), predictor (317), ``JPEGTables`` (347) and
``YCbCrSubSampling`` (530). Pixels are decoded by ``data/codecs.py``.

``slide_levels`` is the JAX reader's level model (``native/tiff_slide.cc``):
when any directory is tiled, the tiled directories are the pyramid levels,
largest area first, and the stripped ones are associated images (an
Aperio ``.svs``'s thumbnail, label and macro); when none is tiled, every
directory is a level.

The writer (``write_tiff``, ``image_directory``) writes classic or BigTIFF
files in either byte order from pre-encoded tiles or strips under any
compression tag, and encodes none, deflate (8) and PackBits (32773) itself,
with the horizontal predictor for deflate. The tests and ``chip_smoke.py``
make their slides with it: the machine with the card has no TIFF library.
"""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

NONE, LZW, OJPEG, JPEG, DEFLATE, ADOBE_DEFLATE, PACKBITS = 1, 5, 6, 7, 8, 32946, 32773
APERIO_J2K_YCBCR, APERIO_J2K_RGB = 33003, 33005
#: Aperio's JPEG 2000 compressions: each tile a bare codestream
APERIO_J2K = (APERIO_J2K_YCBCR, APERIO_J2K_RGB)
#: compression tags the port's codecs decode (Aperio JPEG 2000 in tiles only)
DECODED = (NONE, LZW, JPEG, DEFLATE, ADOBE_DEFLATE, PACKBITS) + APERIO_J2K
COMPRESSION_NAMES = {NONE: "uncompressed", LZW: "LZW", OJPEG: "old-style JPEG", JPEG: "JPEG",
                     DEFLATE: "deflate", ADOBE_DEFLATE: "deflate", PACKBITS: "PackBits",
                     33003: "Aperio JPEG 2000 (YCbCr)", 33005: "Aperio JPEG 2000 (RGB)",
                     34712: "JPEG 2000", 50000: "Zstandard", 34887: "LERC", 34925: "LZMA"}
MINISWHITE, MINISBLACK, RGB, YCBCR = 0, 1, 2, 6
NDPI_TAG = 65420  # Hamamatsu's format flag

# (size, numpy code) of each field type; rationals are pairs of 4-byte ints
_TYPES = {1: (1, "u1"), 2: (1, "u1"), 3: (2, "u2"), 4: (4, "u4"), 5: (8, "u4"),
          6: (1, "i1"), 7: (1, "u1"), 8: (2, "i2"), 9: (4, "i4"), 10: (8, "i4"),
          11: (4, "f4"), 12: (8, "f8"), 13: (4, "u4"), 16: (8, "u8"), 17: (8, "i8"),
          18: (8, "u8")}
_MAX_DIRECTORIES = 1 << 16


@dataclass
class Directory:
    """One image file directory: what the slide reader uses of it."""

    index: int
    width: int
    height: int
    bits: tuple
    samples: int
    compression: int
    photometric: int
    planar: int
    predictor: int
    fill_order: int
    description: str
    tile: tuple | None  # (width, height); None when stripped
    rows_per_strip: int
    offsets: np.ndarray  # int64, one a block
    counts: np.ndarray
    jpeg_tables: bytes | None
    ycbcr_subsampling: tuple
    ndpi: bool  # the Hamamatsu NDPI tag (65420) is present

    @property
    def tiled(self) -> bool:
        return self.tile is not None

    @property
    def block_size(self) -> tuple[int, int]:
        """A block's (width, height): the tile, or (image width, rows per strip)."""
        return self.tile if self.tiled else (self.width, min(self.rows_per_strip, self.height))

    @property
    def grid(self) -> tuple[int, int]:
        """Blocks across and down."""
        bw, bh = self.block_size
        return -(-self.width // bw), -(-self.height // bh)

    def block_rows(self, index: np.ndarray) -> np.ndarray:
        """Rows each block holds: a tile's height, or a strip's rows (the last
        one's may be fewer)."""
        bw, bh = self.block_size
        index = np.asarray(index)
        if self.tiled:
            return np.full(index.shape, bh, np.int32)
        return np.minimum(bh, self.height - index * bh).astype(np.int32)

    def unreadable(self) -> str | None:
        """Why the port's codecs cannot read this directory, or None."""
        if self.compression not in DECODED:
            name = COMPRESSION_NAMES.get(self.compression, "unknown")
            return f"{name} blocks (compression {self.compression})"
        nx, ny = self.grid
        if len(self.offsets) < nx * ny or len(self.counts) < nx * ny:
            return f"{len(self.offsets)} block offsets for a grid of {nx} x {ny}"
        if self.compression in APERIO_J2K:
            # each tile's codestream says what it holds (the JAX reader, too,
            # takes the JPEG 2000 route for tiled directories only)
            if not self.tiled:
                return (f"{COMPRESSION_NAMES[self.compression]} strips (compression "
                        f"{self.compression}; JPEG 2000 is read in tiles only)")
            return None
        if any(b != 8 for b in self.bits):
            return f"{self.bits} bits per sample (8 only)"
        if self.samples not in (1, 3) or (self.samples == 3 and self.planar != 1):
            return f"{self.samples} samples per pixel, planar configuration {self.planar}"
        if self.compression == JPEG:
            if self.photometric not in (MINISWHITE, MINISBLACK, RGB, YCBCR):
                return f"photometric interpretation {self.photometric} under JPEG"
        elif not ((self.samples == 3 and self.photometric == RGB)
                  or (self.samples == 1 and self.photometric in (MINISWHITE, MINISBLACK))):
            return (f"photometric interpretation {self.photometric} with {self.samples} "
                    f"samples under {COMPRESSION_NAMES[self.compression]} blocks")
        if self.fill_order != 1:
            return f"fill order {self.fill_order}"
        if self.predictor not in (1, 2):
            return f"predictor {self.predictor}"
        return None


def _read(f, offset: int, size: int) -> bytes:
    f.seek(offset)
    data = f.read(size)
    if len(data) != size:
        raise ValueError(f"{f.name}: {size} bytes at offset {offset} run past the end")
    return data


def read_directories(path: str) -> list[Directory]:
    """Every top-level directory of the TIFF or BigTIFF at ``path``, in file
    order; raises ``ValueError`` naming the file when it is not one."""
    with open(path, "rb") as f:
        head = f.read(16)
        if len(head) < 8 or head[:2] not in (b"II", b"MM"):
            raise ValueError(f"{path}: not a TIFF file")
        bo = "<" if head[:2] == b"II" else ">"
        magic = struct.unpack(bo + "H", head[2:4])[0]
        if magic == 42:
            big, first = False, struct.unpack(bo + "I", head[4:8])[0]
        elif magic == 43 and len(head) == 16:
            size, _ = struct.unpack(bo + "HH", head[4:8])
            if size != 8:
                raise ValueError(f"{path}: BigTIFF with {size}-byte offsets")
            big, first = True, struct.unpack(bo + "Q", head[8:16])[0]
        else:
            raise ValueError(f"{path}: not a TIFF file (magic {magic})")
        dirs, seen, offset = [], set(), first
        while offset and len(dirs) < _MAX_DIRECTORIES:
            if offset in seen:
                raise ValueError(f"{path}: directory chain loops at offset {offset}")
            seen.add(offset)
            tags, offset = _read_ifd(f, bo, big, offset)
            dirs.append(_directory(len(dirs), tags))
    return dirs


def _read_ifd(f, bo: str, big: bool, offset: int) -> tuple[dict, int]:
    """One IFD's tags (tag → numpy array, or bytes for ASCII / UNDEFINED)
    and the next IFD's offset."""
    count_fmt, entry_size, ptr_fmt = ("Q", 20, "Q") if big else ("H", 12, "I")
    n = struct.unpack(bo + count_fmt, _read(f, offset, 8 if big else 2))[0]
    table = _read(f, offset + (8 if big else 2), n * entry_size + (8 if big else 4))
    inline = 8 if big else 4
    tags = {}
    for i in range(n):
        e = table[i * entry_size:(i + 1) * entry_size]
        tag, typ = struct.unpack(bo + "HH", e[:4])
        count = struct.unpack(bo + count_fmt.replace("H", "I"), e[4:12 if big else 8])[0]
        if typ not in _TYPES:
            continue
        size, code = _TYPES[typ]
        nbytes = size * count
        raw = e[-inline:][:nbytes] if nbytes <= inline else _read(
            f, struct.unpack(bo + ptr_fmt, e[-inline:])[0], nbytes)
        if typ in (2, 7):
            tags[tag] = raw
        else:
            tags[tag] = np.frombuffer(raw, np.dtype(code).newbyteorder(bo)).astype(
                np.float64 if code[0] == "f" else np.int64)
    nxt = struct.unpack(bo + ptr_fmt, table[n * entry_size:])[0]
    return tags, nxt


def _directory(index: int, tags: dict) -> Directory:
    def one(tag, default):
        v = tags.get(tag)
        return default if v is None or len(v) == 0 else int(v[0])

    samples = one(277, 1)
    bits = tuple(int(b) for b in tags.get(258, [1] * samples))
    if len(bits) == 1 and samples > 1:
        bits = bits * samples
    tiled = 322 in tags and 323 in tags
    desc = tags.get(270, b"")
    return Directory(
        index=index, width=one(256, 0), height=one(257, 0), bits=bits, samples=samples,
        compression=one(259, NONE), photometric=one(262, MINISBLACK), planar=one(284, 1),
        predictor=one(317, 1), fill_order=one(266, 1),
        description=bytes(desc).split(b"\0", 1)[0].decode("utf-8", errors="replace"),
        tile=(one(322, 0), one(323, 0)) if tiled else None,
        rows_per_strip=one(278, 2 ** 32 - 1),
        offsets=np.asarray(tags.get(324 if tiled else 273, []), np.int64),
        counts=np.asarray(tags.get(325 if tiled else 279, []), np.int64),
        jpeg_tables=bytes(tags[347]) if 347 in tags else None,
        ycbcr_subsampling=tuple(int(v) for v in tags.get(530, (2, 2))),
        ndpi=NDPI_TAG in tags)


def slide_levels(dirs: list[Directory]) -> tuple[list[Directory], list[Directory]]:
    """``(levels, associated)``: the JAX reader's level model. Directories
    of no area are dropped."""
    dirs = [d for d in dirs if d.width > 0 and d.height > 0]
    if any(d.tiled for d in dirs):
        levels = [d for d in dirs if d.tiled]
        associated = [d for d in dirs if not d.tiled]
    else:
        levels, associated = dirs, []
    levels = sorted(levels, key=lambda d: -d.width * d.height)  # stable
    return levels, associated


def associated_name(i: int, description: str) -> str:
    """The JAX reader's name for associated image ``i``: label, macro, the
    first stripped directory the thumbnail, else ``associated_<i>``."""
    low = description.lower()
    if "label" in low:
        return "label"
    if "macro" in low:
        return "macro"
    return "thumbnail" if i == 0 else f"associated_{i}"


# --- writer --------------------------------------------------------------------


@dataclass
class DirectorySpec:
    """A directory to write: its blocks already encoded under
    ``compression``, row-major over the tile grid, or one a strip."""

    width: int
    height: int
    blocks: list
    compression: int = NONE
    tile: tuple | None = None  # (width, height); None: strips of rows_per_strip
    rows_per_strip: int = 0
    photometric: int = RGB
    samples: int = 3
    predictor: int = 1
    description: str = ""
    jpeg_tables: bytes | None = None
    ycbcr_subsampling: tuple | None = None
    # tag -> (field type, values or bytes) written as given: a vendor's tags
    extra_tags: dict = field(default_factory=dict)


def packbits(data: bytes) -> bytes:
    """PackBits of one row: repeats of 2-128 bytes, literals of up to 128."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes(((i - j) & 0xFF, data[i]))
            i = j + 1
            continue
        k = i + 1
        while k < n and k - i < 128 and not (k + 1 < n and data[k] == data[k + 1]):
            k += 1
        out.append(k - i - 1)
        out += data[i:k]
        i = k
    return bytes(out)


def encode_block(pixels: np.ndarray, compression: int, predictor: int = 1) -> bytes:
    """(rows, width, samples) uint8 → one block's bytes."""
    pixels = np.ascontiguousarray(pixels, dtype=np.uint8)
    if predictor == 2:
        if compression not in (DEFLATE, ADOBE_DEFLATE):
            raise ValueError("the writer applies predictor 2 under deflate only")
        rows, width, spp = pixels.shape
        flat = pixels.reshape(rows, width * spp)
        diff = flat.copy()
        diff[:, spp:] = flat[:, spp:] - flat[:, :-spp]  # uint8: wraps as TIFF's does
        pixels = diff
    elif predictor != 1:
        raise ValueError(f"predictor {predictor}")
    if compression == NONE:
        return pixels.tobytes()
    if compression in (DEFLATE, ADOBE_DEFLATE):
        return zlib.compress(pixels.tobytes(), 6)
    if compression == PACKBITS:
        return b"".join(packbits(row.tobytes()) for row in pixels.reshape(pixels.shape[0], -1))
    raise ValueError(f"the writer does not encode compression {compression}")


def image_directory(img: np.ndarray, *, tile: int | None = None, rows_per_strip: int = 16,
                    compression: int = NONE, predictor: int = 1,
                    description: str = "") -> DirectorySpec:
    """An (H, W, 3) or (H, W) uint8 image as a tiled (``tile`` px squares,
    edge tiles zero-padded as libtiff writes them) or stripped directory,
    encoded under none, deflate or PackBits on a thread pool (zlib releases
    the GIL)."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, spp = img.shape
    if tile:
        corners = [(ty, tx) for ty in range(0, h, tile) for tx in range(0, w, tile)]
    else:
        corners = [(y, 0) for y in range(0, h, rows_per_strip)]

    def encode(corner):
        y, x = corner
        if not tile:
            return encode_block(img[y:y + rows_per_strip], compression, predictor)
        block = np.zeros((tile, tile, spp), np.uint8)
        part = img[y:y + tile, x:x + tile]
        block[:part.shape[0], :part.shape[1]] = part
        return encode_block(block, compression, predictor)

    with ThreadPoolExecutor(min(8, len(os.sched_getaffinity(0)))) as pool:
        blocks = list(pool.map(encode, corners))
    return DirectorySpec(width=w, height=h, blocks=blocks, compression=compression,
                         tile=(tile, tile) if tile else None, rows_per_strip=rows_per_strip,
                         photometric=RGB if spp == 3 else MINISBLACK, samples=spp,
                         predictor=predictor, description=description)


def write_tiff(path: str, dirs: list[DirectorySpec], *, bigtiff: bool = False,
               big_endian: bool = False) -> None:
    """Write ``dirs`` as one TIFF (BigTIFF with ``bigtiff``; ``MM`` with
    ``big_endian``): each directory's blocks, then its IFD and the values
    that do not fit in an entry."""
    bo = ">" if big_endian else "<"
    off_type, off_fmt = (16, "Q") if bigtiff else (4, "I")
    limit = 2 ** 64 if bigtiff else 2 ** 32
    body = bytearray()
    if bigtiff:
        body += (b"MM" if big_endian else b"II") + struct.pack(bo + "HHHQ", 43, 8, 0, 0)
    else:
        body += (b"MM" if big_endian else b"II") + struct.pack(bo + "HI", 42, 0)
    link = 8 if bigtiff else 4  # where the first IFD's offset goes
    for spec in dirs:
        offsets, counts = [], []
        for block in spec.blocks:
            offsets.append(len(body))
            counts.append(len(block))
            body += block
            if len(body) % 2:
                body += b"\0"
        if len(body) >= limit:
            raise ValueError(f"{path}: {len(body)} bytes need BigTIFF")
        entries = {
            256: (4, [spec.width]), 257: (4, [spec.height]), 258: (3, [8] * spec.samples),
            259: (3, [spec.compression]), 262: (3, [spec.photometric]),
            277: (3, [spec.samples]), 284: (3, [1]),
        }
        if spec.description:
            entries[270] = (2, spec.description.encode() + b"\0")
        if spec.tile:
            entries.update({322: (4, [spec.tile[0]]), 323: (4, [spec.tile[1]]),
                            324: (off_type, offsets), 325: (off_type, counts)})
        else:
            entries.update({273: (off_type, offsets), 278: (4, [spec.rows_per_strip]),
                            279: (off_type, counts)})
        if spec.predictor != 1:
            entries[317] = (3, [spec.predictor])
        if spec.jpeg_tables:
            entries[347] = (7, spec.jpeg_tables)
        if spec.ycbcr_subsampling:
            entries[530] = (3, list(spec.ycbcr_subsampling))
        entries.update(spec.extra_tags)
        ifd = len(body)
        struct.pack_into(bo + off_fmt, body, link, ifd)
        body += _ifd_bytes(entries, ifd, bo, bigtiff)
        link = _next_link(entries, ifd, bigtiff)
    with open(path, "wb") as f:
        f.write(body)


_PACK = {1: "B", 2: "B", 3: "H", 4: "I", 7: "B", 16: "Q"}


def _ifd_bytes(entries: dict, ifd: int, bo: str, bigtiff: bool) -> bytes:
    """The IFD at file offset ``ifd`` (next-IFD offset 0), then the values
    that do not fit in their entries, each at an even offset."""
    count_fmt, entry_size, inline, ptr_fmt = (("Q", 20, 8, "Q") if bigtiff
                                              else ("H", 12, 4, "I"))
    head = struct.pack(bo + count_fmt, len(entries))
    table_size = len(head) + len(entries) * entry_size + inline
    table, extra = bytearray(head), bytearray()
    for tag in sorted(entries):
        typ, values = entries[tag]
        if isinstance(values, (bytes, bytearray)):
            raw, count = bytes(values), len(values)
        else:
            raw, count = struct.pack(bo + _PACK[typ] * len(values), *values), len(values)
        table += struct.pack(bo + "HH" + ("Q" if bigtiff else "I"), tag, typ, count)
        if len(raw) <= inline:
            table += raw + b"\0" * (inline - len(raw))
        else:
            table += struct.pack(bo + ptr_fmt, ifd + table_size + len(extra))
            extra += raw + b"\0" * (len(raw) % 2)
    table += b"\0" * inline  # next IFD: none yet
    return bytes(table + extra)


def _next_link(entries: dict, ifd: int, bigtiff: bool) -> int:
    """Offset of the next-IFD field of the IFD written at ``ifd``."""
    head, entry_size = (8, 20) if bigtiff else (2, 12)
    return ifd + head + len(entries) * entry_size
