"""Whole-slide tiling: tissue segmentation, tile selection, patch files.

Counterpart of ``multimodalbrainsurvival_tpu/data/tiler.py`` (reference
``1_HistoPathology/1_WSI2Patches.py``), with its artifact contract:

- ``<patch_path>/<slide_id>/<slide_id>_patch_<i>.png`` patches;
- ``loc.txt``: a ``slide_id <id>`` line, a header line, then ``i x y
  patch_level patch_size_read patch_size_output`` rows;
- ``<mask_path>/<slide_id>/mask.npy``: the transposed (x-major) boolean
  tissue mask at the lowest pyramid level, dilated x3 then eroded x3;
- ``pack_patch_dir``: a slide's PNGs packed into ``patches.npy`` (an (N,
  P, P, 3) uint8 array the datasets read rows of with no decode).

The mask recipe, the seeded candidate shuffle and the acceptance rule are
the JAX tiler's (numpy and scipy); its four OpenCV calls are
``data/opencv_compat.py``'s (the grey conversion of the contrast test, the
bilinear 2x downscale of AppMag-40 slides) and ``write_png``'s (stdlib
zlib; the PNG bytes differ from OpenCV's, the decoded pixels do not).

Readers (``open_slide``): OpenSlide when it is importable, as the JAX
package orders them; else the port's own lazy reader ``TiffSlide`` for
``.svs/.mrxs/.tif/.tiff`` (``data/tiff.py``'s container, classic or
BigTIFF, tiled or stripped, and ``data/codecs.py``'s C++ codecs: JPEG, LZW,
deflate, PackBits, none, and Aperio's JPEG 2000 tiles), with no outside
library; ``ImageSlide`` for a PNG (decoded by the port's C++ loader,
``data/native.py``) and for a JPEG (``data/codecs.py``). Any other format
raises naming it; so do Hamamatsu NDPI files (the ``.ndpi`` extension or
the NDPI tag 65420), JPEG 2000 in strips and progressive JPEG files,
naming the format or the codec.
The JAX package's libtiff and eager PIL readers and its cv2 fallback are
not carried over: the machine with the card has none of those libraries.
"""

from __future__ import annotations

import os
import struct
import threading
import zlib
from collections import OrderedDict
from dataclasses import dataclass
from multiprocessing import Pool

import numpy as np
from scipy import ndimage

from multimodalbrainsurvival_torch.data import codecs, native, tiff
from multimodalbrainsurvival_torch.data.opencv_compat import resize_linear, rgb_to_gray

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
SLIDE_EXTS = (".svs", ".png", ".tif", ".tiff", ".jpg", ".jpeg", ".ndpi")
TIFF_EXTS = (".svs", ".mrxs", ".tiff", ".tif")
JPEG_EXTS = (".jpg", ".jpeg")
NDPI_EXTS = (".ndpi",)
NDPI_REFUSED = ("{path}: a Hamamatsu NDPI file, which the port's TIFF reader does not read "
                "(whole-level JPEG strips, offsets past 4 GiB wrapped to 32 bits); "
                "OpenSlide reads it where it is installed")


# --- tissue segmentation (JAX data/tiler.py:47-97) ---------------------------


def otsu_threshold(values: np.ndarray) -> float:
    """Otsu's method on a 256-bin histogram (skimage-compatible for uint8)."""
    values = np.asarray(values)
    if values.dtype == np.uint8:
        hist = np.bincount(values.reshape(-1), minlength=256).astype(np.float64)
        centers = np.arange(256, dtype=np.float64)
    else:
        hist, edges = np.histogram(values.reshape(-1), bins=256)
        hist = hist.astype(np.float64)
        centers = (edges[:-1] + edges[1:]) / 2.0
    w0 = np.cumsum(hist)
    w1 = w0[-1] - w0
    mu_cum = np.cumsum(hist * centers)
    mu0 = np.where(w0 > 0, mu_cum / np.maximum(w0, 1e-12), 0.0)
    mu1 = np.where(w1 > 0, (mu_cum[-1] - mu_cum) / np.maximum(w1, 1e-12), 0.0)
    between = w0[:-1] * w1[:-1] * (mu0[:-1] - mu1[:-1]) ** 2
    return float(centers[np.argmax(between)])


def rgb_to_saturation(img_rgb: np.ndarray) -> np.ndarray:
    """HSV saturation in float64. The channel max and min are taken on the
    input's own dtype (exact, and much faster than a float64 reduction over
    the last axis), then the JAX tiler's float64 formula."""
    r, g, b = img_rgb[..., 0], img_rgb[..., 1], img_rgb[..., 2]
    maxc = np.maximum(np.maximum(r, g), b).astype(np.float64)
    minc = np.minimum(np.minimum(r, g), b).astype(np.float64)
    return np.where(maxc > 0, (maxc - minc) / np.maximum(maxc, 1e-12), 0.0)


def tissue_mask(img_rgb: np.ndarray, rgb_min: int = 50) -> np.ndarray:
    """Per-channel Otsu background ∧ saturation Otsu ∧ RGB > ``rgb_min``
    (``get_mask_image``, ``1_WSI2Patches.py:37-51``)."""
    r, g, b = img_rgb[..., 0], img_rgb[..., 1], img_rgb[..., 2]
    background = (r > otsu_threshold(r)) & (g > otsu_threshold(g)) & (b > otsu_threshold(b))
    sat = rgb_to_saturation(img_rgb)
    tissue_s = sat > otsu_threshold(sat)
    return ~background & tissue_s & (r > rgb_min) & (g > rgb_min) & (b > rgb_min)


def is_low_contrast(img_rgb: np.ndarray, fraction_threshold: float = 0.05) -> bool:
    """skimage's test: the grey range (1st to 99th percentile) below 5% of
    the dtype's range."""
    lo, hi = np.percentile(rgb_to_gray(img_rgb), [1, 99])
    return (hi - lo) / 255.0 < fraction_threshold


# --- PNG files ----------------------------------------------------------------


def png_size(path: str) -> tuple[int, int]:
    """(height, width) from a PNG's IHDR chunk."""
    with open(path, "rb") as f:
        head = f.read(24)
    if len(head) < 24 or head[:8] != PNG_SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"not a PNG: {path}")
    width, height = struct.unpack(">II", head[16:24])
    return height, width


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, rgb: np.ndarray, level: int = 6) -> None:
    """(H, W, 3) uint8 RGB → an 8-bit RGB PNG (no filter, zlib ``level``)."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w = rgb.shape[:2]
    raw = np.zeros((h, 1 + 3 * w), np.uint8)
    raw[:, 1:] = rgb.reshape(h, 3 * w)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
                + _chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """A PNG → (H, W, 3) uint8 RGB, decoded by the C++ loader."""
    out = np.zeros((1, *png_size(path), 3), np.uint8)
    native.decode_patch_batch([path], out, num_threads=1)
    return out[0]


# --- slide readers ------------------------------------------------------------


class ImageSlide:
    """A plain image as a two-level pyramid: the image and a thumbnail
    subsampled to at most ``thumb_max`` a side (JAX ``ImageSlide``)."""

    def __init__(self, img: np.ndarray, thumb_max: int = 1024):
        self.img = img
        h, w = img.shape[:2]
        scale = max(1, int(np.ceil(max(h, w) / thumb_max)))
        self.thumb = img[::scale, ::scale]
        # (width, height) per level, OpenSlide's convention
        self.level_dimensions = [(w, h), (self.thumb.shape[1], self.thumb.shape[0])]
        self.properties: dict = {}

    @classmethod
    def from_png(cls, path: str, thumb_max: int = 1024) -> "ImageSlide":
        if not os.path.isfile(path):
            raise FileNotFoundError(path)
        return cls(read_png(path), thumb_max)

    @classmethod
    def from_jpeg(cls, path: str, thumb_max: int = 1024) -> "ImageSlide":
        """A JPEG file, decoded as libjpeg decodes it by default (what the
        JAX ``ImageSlide`` reads through OpenCV)."""
        with open(path, "rb") as f:
            data = f.read()
        return cls(codecs.decode_jpeg(data, path), thumb_max)

    def read_region(self, xy, level, size):
        x, y = xy
        w, h = size
        src = self.img if level == 0 else self.thumb
        out = np.zeros((h, w, 3), np.uint8)
        ys, xs = src.shape[:2]
        y1, x1 = min(y + h, ys), min(x + w, xs)
        if y < ys and x < xs:
            out[: y1 - y, : x1 - x] = src[y:y1, x:x1]
        return out


def parse_aperio(description: str) -> dict:
    """``aperio.<key>`` properties from an Aperio ImageDescription's
    ``|key = value|`` fields."""
    props: dict = {}
    for field in description.split("|"):
        if "=" in field:
            k, _, v = field.partition("=")
            props[f"aperio.{k.strip()}"] = v.strip()
    return props


class TiffSlide:
    """The port's lazy pyramidal-TIFF reader: ``data/tiff.py`` parses the
    container (classic or BigTIFF, either byte order), ``data/codecs.py``
    decodes only the tiles or strips a ``read_region`` touches, all of them
    in one call on ``codecs.DEFAULT_THREADS`` C++ threads. The OpenSlide
    API the tiler uses: ``level_dimensions``, ``properties``
    (``aperio.AppMag``), ``read_region((x, y), level, (w, h))`` with (x, y)
    in level-0 coordinates and zeros past the edge, ``associated_images``.
    The last ``cache_blocks`` decoded blocks are kept, each a copy of its
    own (0 keeps none): adjacent patches share tiles, and a JPEG 2000 block
    costs several times a JPEG block to decode. Aperio's JPEG 2000 tiles
    (33003, YCbCr samples; 33005, RGB) go through the port's own decoder
    (``data/csrc/j2k.cc``) to the pixels the JAX reader gets from Pillow.
    A block that does not decode raises naming the file, the level, the
    block and what it could not read; a directory the codecs cannot read (a
    compression the port lacks, JPEG 2000 in strips) raises naming it, and
    a Hamamatsu NDPI file (tag 65420: whole-level JPEG strips, offsets past
    4 GiB wrapped to 32 bits) raises when it is opened."""

    cache_blocks = 64

    def __init__(self, path: str):
        self.path = path
        dirs = tiff.read_directories(path)
        if not dirs:
            raise ValueError(f"{path}: a TIFF with no directory")
        if any(d.ndpi for d in dirs):
            raise ValueError(NDPI_REFUSED.format(path=path))
        self._levels, self._associated = tiff.slide_levels(dirs)
        if not self._levels:
            raise ValueError(f"{path}: no directory holds an image")
        self.level_dimensions = [(d.width, d.height) for d in self._levels]
        self.properties = parse_aperio(dirs[0].description)
        self._cache: OrderedDict = OrderedDict()
        self._lock = threading.Lock()

    def _decode(self, d: "tiff.Directory", index: np.ndarray, what: str) -> list:
        """Directory ``d``'s blocks at ``index`` (decoded, or from the cache)."""
        why = d.unreadable()
        if why is not None:
            raise NotImplementedError(f"{self.path}: {what} holds {why}, which the port's "
                                      f"TIFF reader does not decode")
        with self._lock:
            got = {int(i): self._cache.get((d.index, int(i))) for i in index}
            for i, block in got.items():
                if block is not None:
                    self._cache.move_to_end((d.index, i))
        todo = np.array([i for i, b in got.items() if b is None], np.int64)
        if len(todo):
            bw, bh = d.block_size
            blocks, codes = codecs.decode_blocks(
                self.path, d.offsets[todo], d.counts[todo], d.block_rows(todo), bw, bh,
                compression=d.compression, predictor=d.predictor, photometric=d.photometric,
                samples=d.samples, jpeg_tables=d.jpeg_tables)
            for k in np.flatnonzero(codes):
                i = int(todo[k])
                nx = d.grid[0]
                block = f"tile ({i % nx}, {i // nx})" if d.tiled else f"strip {i}"
                raise codecs.DecodeError(
                    f"{self.path}: {what}, {block}: cannot decode its "
                    f"{tiff.COMPRESSION_NAMES[d.compression]} data: "
                    f"{codecs.describe(int(codes[k]))}", int(codes[k]))
            with self._lock:
                for k, i in enumerate(todo):
                    got[int(i)] = blocks[k]
                # copies: a view would keep the whole decode's array alive
                for k in range(len(todo) - min(self.cache_blocks, len(todo)), len(todo)):
                    self._cache[(d.index, int(todo[k]))] = blocks[k].copy()
                while len(self._cache) > self.cache_blocks:
                    self._cache.popitem(last=False)
        return [got[int(i)] for i in index]

    def _read(self, d: "tiff.Directory", x: int, y: int, w: int, h: int,
              what: str) -> np.ndarray:
        """(x, y) in the directory's coordinates → (h, w, 3) uint8 RGB,
        zero outside it."""
        out = np.zeros((h, w, 3), np.uint8)
        x0, y0 = max(x, 0), max(y, 0)
        x1, y1 = min(x + w, d.width), min(y + h, d.height)
        if x0 >= x1 or y0 >= y1:
            return out
        bw, bh = d.block_size
        nx = d.grid[0]
        bxs = range(x0 // bw, (x1 - 1) // bw + 1)
        bys = range(y0 // bh, (y1 - 1) // bh + 1)
        index = np.array([by * nx + bx for by in bys for bx in bxs], np.int64)
        for i, block in zip(index, self._decode(d, index, what)):
            bx, by = (int(i) % nx) * bw, (int(i) // nx) * bh
            rx0, ry0 = max(x0, bx), max(y0, by)
            rx1, ry1 = min(x1, bx + bw), min(y1, by + bh)
            out[ry0 - y:ry1 - y, rx0 - x:rx1 - x] = block[ry0 - by:ry1 - by, rx0 - bx:rx1 - bx]
        return out

    def read_region(self, xy, level, size):
        x0, y0 = xy
        w, h = size
        ds_x = self.level_dimensions[0][0] / self.level_dimensions[level][0]
        ds_y = self.level_dimensions[0][1] / self.level_dimensions[level][1]
        return self._read(self._levels[level], int(x0 / ds_x), int(y0 / ds_y), w, h,
                          f"level {level}")

    @property
    def associated_images(self) -> dict:
        """name → (h, w, 3) uint8 of each associated image (the stripped
        directories of a tiled slide), named as the JAX reader names them."""
        out = {}
        for i, d in enumerate(self._associated):
            name = tiff.associated_name(i, d.description)
            out[name] = self._read(d, 0, 0, d.width, d.height, f"associated image {name!r}")
        return out


def slide_id_for(name: str) -> str:
    """A slide file's id: its base name without a known slide extension
    (and every other dot kept: TCGA names embed a UUID after a dot)."""
    base = os.path.basename(name)
    stem, ext = os.path.splitext(base)
    return stem if ext.lower() in SLIDE_EXTS else base


def open_slide(path: str):
    """OpenSlide (when importable) for a TIFF pyramid or an NDPI file; else
    the port's ``TiffSlide`` for a TIFF pyramid; ``ImageSlide`` for a PNG or
    a JPEG; raises naming any other format, NDPI included. A TIFF of one
    level becomes an ``ImageSlide`` of that level, as the JAX package's
    fallback makes it."""
    low = path.lower()
    if low.endswith(TIFF_EXTS + NDPI_EXTS):
        try:
            from openslide import OpenSlide
        except ImportError:
            pass
        else:
            return OpenSlide(path)
        if low.endswith(NDPI_EXTS):
            raise ValueError(NDPI_REFUSED.format(path=path))
        slide = TiffSlide(path)
        if len(slide.level_dimensions) > 1:
            return slide
        w, h = slide.level_dimensions[0]
        return ImageSlide(slide.read_region((0, 0), 0, (w, h)))
    if low.endswith(".png"):
        return ImageSlide.from_png(path)
    if low.endswith(JPEG_EXTS):
        return ImageSlide.from_jpeg(path)
    raise ValueError(f"{path}: cannot read {os.path.splitext(path)[1] or 'this'} slides "
                     f"(TIFF pyramids {', '.join(TIFF_EXTS)}, PNG and JPEG images only)")



def region_rgb(slide, xy, level, size) -> np.ndarray:
    """A region as (h, w, 3) uint8 RGB (OpenSlide returns an RGBA image)."""
    region = slide.read_region(xy, level, size)
    if isinstance(region, np.ndarray):
        return region
    return np.array(region.convert("RGB"))


# --- tile selection (JAX data/tiler.py:426-500) -------------------------------


@dataclass
class TileConfig:
    patch_size: int = 224
    max_patches_per_slide: int = 2000
    dezoom_factor: float = 1.0
    background_threshold: float = 0.2
    rgb_min: int = 50
    seed: int = 5  # the reference's fixed shuffle seed (1_WSI2Patches.py:105)
    # also write <slide>/patches.npy (pack_patch_dir)
    pack: bool = False


def compute_tissue_mask(slide, config: TileConfig = TileConfig()) -> np.ndarray:
    """Low-res tissue mask at the lowest pyramid level: transposed (x-major),
    dilated x3 then eroded x3 (``1_WSI2Patches.py:58-60,75-78``)."""
    mask_level = len(slide.level_dimensions) - 1
    thumb = region_rgb(slide, (0, 0), mask_level, slide.level_dimensions[mask_level])
    mask = tissue_mask(np.transpose(thumb, (1, 0, 2)), config.rgb_min)
    mask = ndimage.binary_dilation(mask, iterations=3)
    return ndimage.binary_erosion(mask, iterations=3)


def read_size_for(slide, config: TileConfig) -> int:
    """Level-0 read size for one output patch: AppMag-40 slides read 2x and
    downscale (``1_WSI2Patches.py:98-104``)."""
    app_mag = float(slide.properties.get("aperio.AppMag", 20))
    return int((app_mag / 20.0) * config.dezoom_factor * config.patch_size)


def candidate_positions(slide, mask: np.ndarray, config: TileConfig) -> np.ndarray:
    """Seed-shuffled level-0 grid positions kept by the low-res mask; (M, 2)."""
    xmax, ymax = slide.level_dimensions[0]
    mask_level = len(slide.level_dimensions) - 1
    mx, my = slide.level_dimensions[mask_level]
    read_size = read_size_for(slide, config)
    xs = np.arange(0, xmax, read_size)
    ys = np.arange(0, ymax, read_size)
    grid = np.stack(np.meshgrid(xs, ys, indexing="ij"), axis=-1).reshape(-1, 2)
    np.random.RandomState(config.seed).shuffle(grid)
    mask_ix = np.minimum((grid[:, 0] / (xmax / mx)).astype(int), mask.shape[0] - 1)
    mask_iy = np.minimum((grid[:, 1] / (ymax / my)).astype(int), mask.shape[1] - 1)
    return grid[mask[mask_ix, mask_iy]]


def _accepted(slide, config: TileConfig, read_size: int, x: int, y: int):
    """The tile at level-0 (x, y) as a (patch_size, patch_size, 3) patch
    when it is accepted (a dilated-tissue fraction above
    ``background_threshold`` and not low-contrast,
    ``1_WSI2Patches.py:106-121``), else None."""
    patch = region_rgb(slide, (int(x), int(y)), 0, (read_size, read_size))
    m = ndimage.binary_dilation(tissue_mask(patch, config.rgb_min), iterations=3)
    if m.sum() > config.background_threshold * m.size and not is_low_contrast(patch):
        if read_size != config.patch_size:
            patch = resize_linear(patch, (config.patch_size, config.patch_size))
        return patch
    return None


def iter_tissue_patches(slide, config: TileConfig = TileConfig(), mask=None):
    """Yield ``(index, x, y, patch)`` for each accepted tissue tile, the
    patch (patch_size, patch_size, 3) uint8 RGB, in the order
    ``extract_patches`` writes them."""
    if mask is None:
        mask = compute_tissue_mask(slide, config)
    read_size = read_size_for(slide, config)
    i = 0
    for x, y in candidate_positions(slide, mask, config):
        patch = _accepted(slide, config, read_size, x, y)
        if patch is not None:
            yield i, x, y, patch
            i += 1
        if i >= config.max_patches_per_slide:
            return


# --- patch files (JAX data/tiler.py:394-561) ----------------------------------


def pack_patch_dir(patch_dir: str, num_threads: int = 8) -> int:
    """Pack a slide's PNG patches into ``patches.npy``; returns the number
    of patches. Idempotent: a shard at least as new as ``loc.txt`` is
    kept. Every patch must have the first one's size."""
    loc = os.path.join(patch_dir, "loc.txt")
    out = os.path.join(patch_dir, "patches.npy")
    with open(loc) as f:
        n = sum(1 for _ in f) - 2
    if n <= 0:
        return 0
    if os.path.isfile(out) and os.path.getmtime(out) >= os.path.getmtime(loc):
        return n
    slide_id = os.path.basename(os.path.normpath(patch_dir))
    paths = [os.path.join(patch_dir, f"{slide_id}_patch_{i}.png") for i in range(n)]
    for p in paths:  # loc.txt's count out of step with the files on disk
        if not os.path.isfile(p):
            raise FileNotFoundError(p)
    size = png_size(paths[0])
    for p in paths[1:]:
        if png_size(p) != size:
            raise ValueError(f"{p} is {png_size(p)}, the slide's first patch {size}")
    packed = np.zeros((n, *size, 3), np.uint8)
    native.decode_patch_batch(paths, packed, num_threads=num_threads)
    np.save(out, packed)
    return n


def extract_patches(slide_path: str, patch_path: str, mask_path: str,
                    config: TileConfig = TileConfig(), slide_id: str | None = None) -> int:
    """Tile one slide into the artifact contract; returns the number of
    patches written. A ``mask.npy`` already on disk is reused."""
    if slide_id is None:
        slide_id = slide_id_for(slide_path)
    patch_dir = os.path.join(patch_path, slide_id)
    mask_dir = os.path.join(mask_path, slide_id)
    os.makedirs(patch_dir, exist_ok=True)
    slide = open_slide(slide_path)
    mask_file = os.path.join(mask_dir, "mask.npy")
    if os.path.isfile(mask_file):
        mask = np.load(mask_file)
    else:
        os.makedirs(mask_dir, exist_ok=True)
        mask = compute_tissue_mask(slide, config)
        np.save(mask_file, mask)
    read_size = read_size_for(slide, config)
    n = 0
    with open(os.path.join(patch_dir, "loc.txt"), "w") as loc:
        loc.write(f"slide_id {slide_id}\n")
        loc.write("id x y patch_level patch_size_read patch_size_output\n")
        for i, x, y, patch in iter_tissue_patches(slide, config, mask=mask):
            loc.write(f"{i} {x} {y} 0 {read_size} {read_size}\n")
            write_png(os.path.join(patch_dir, f"{slide_id}_patch_{i}.png"), patch)
            n = i + 1
    if n == 0:
        print(f"no patch extracted for slide {slide_id}")
    elif config.pack:
        pack_patch_dir(patch_dir)
    return n


def _tile_one(args) -> int:
    return extract_patches(*args)


def tile_slides(slide_paths: list[str], patch_path: str, mask_path: str,
                config: TileConfig = TileConfig(), num_processes: int = 10) -> list[int]:
    """Tile slides over ``num_processes`` processes (the reference's Pool,
    ``1_WSI2Patches.py:181-182``)."""
    jobs = [(p, patch_path, mask_path, config) for p in slide_paths]
    if num_processes <= 1:
        return [_tile_one(j) for j in jobs]
    with Pool(num_processes) as pool:
        return pool.map(_tile_one, jobs)
