"""The port's slide readers (``data/tiff.py``, ``data/codecs.py`` and its
C++ ``data/csrc/tiff_codecs.cc``, ``data/tiler.py::TiffSlide`` and
``ImageSlide.from_jpeg``) against the JAX readers and libjpeg, on the CPU.

Slides are numpy-seeded images written by libtiff (the port's libtiff
binding ``utils/native_tiff.py``), by Pillow, or by the port's writer around
tiles that Pillow or OpenCV encoded. Tolerances: none. The pixels equal

- the JAX libtiff reader's (``NativeTiffSlide``) for tiled and stripped
  directories under none, LZW (with predictor 2 from Pillow's writer),
  deflate, PackBits and libtiff's own JPEG (abbreviated streams with
  ``JPEGTables``), for BigTIFF and ``MM`` files from the port's writer, and
  for JPEG under Photometric YCbCr, on partial edge tiles and past the edge;
- libjpeg's decode of each tile's stream (Pillow's, and OpenCV's where the
  stream is whole) for JPEG tiles in 4:4:4, 4:2:2, 4:2:0 and 4:4:0, with
  and without restart markers, under Photometric RGB and YCbCr. Under
  Photometric RGB the JAX libtiff route refuses a subsampled YCbCr stream
  and hands back a 4:4:4 one's YCbCr samples as RGB; the port reads what
  libjpeg reads (ROADMAP.md, "Reference defects the port must not copy");
- the JAX ``ImageSlide``'s (OpenCV) for ``.jpg`` slides.

The whole-slide CLIs are held to the JAX CLIs on a JPEG-tiled slide:
``wsi2patches`` and ``attention_heatmap`` (artifacts and pixels identical),
``slide_extractfeatures`` and ``slide_joint_savescore``
(``tests/test_torch_slide_extract.py``'s float32 tolerances). Torch and the
codecs run on 2 threads.
"""

import hashlib
import io
import json
import os
import subprocess
import sys
import textwrap

import cv2
import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from multimodalbrainsurvival_torch.cli import (
    attention_heatmap,
    slide_extractfeatures,
    slide_joint_savescore,
    wsi2patches,
)
from multimodalbrainsurvival_torch.cli.histo_train import build_mil_model
from multimodalbrainsurvival_torch.cli.joint_train import build_joint_model
from multimodalbrainsurvival_torch.config import Config
from multimodalbrainsurvival_torch.data import codecs, tiff, tiler
from multimodalbrainsurvival_torch.utils import native_tiff
from multimodalbrainsurvival_tpu.data import tiler as jax_tiler
from tests._torch_jax_tiff import jax_native_tiff_slide
from tests._torch_tmp import remove_module_tmp, remove_tmp_path  # noqa: F401

torch.set_num_threads(2)
THREADS = 2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "torch_tiff")
W, H, T = 410, 300, 64  # a level of 7 x 5 tiles, the last row and column partial
# (level, x, y, w, h): the whole level, regions across tiles, past each edge
REGIONS = ((0, 0, 0, W, H), (0, 100, 63, 128, 131), (0, -20, -10, 100, 90),
           (0, 390, 280, 100, 100), (0, 500, 0, 10, 10), (1, 0, 0, W // 2, H // 2),
           (1, 150, 100, 80, 80))
SAMPLING = {"4:4:4": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "4:2:2": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "4:2:0": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "4:4:0": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}
YCBCR_TAG = {"4:4:4": (1, 1), "4:2:2": (2, 1), "4:2:0": (2, 2), "4:4:0": (1, 2)}


@pytest.fixture(autouse=True)
def _codec_threads(monkeypatch):
    monkeypatch.setattr(codecs, "DEFAULT_THREADS", THREADS)


def _image(seed: int, h: int = H, w: int = W) -> np.ndarray:
    """A smooth field of 16-px cells plus grain: JPEG-friendly, and every
    tile differs."""
    rng = np.random.default_rng(seed)
    cells = rng.integers(0, 200, (h // 16 + 1, w // 16 + 1, 3))
    field = np.repeat(np.repeat(cells, 16, 0), 16, 1)[:h, :w]
    return (field + rng.integers(0, 56, (h, w, 3))).astype(np.uint8)


def _tissue_slide(seed: int, size: int = 512) -> np.ndarray:
    """``tests/test_torch_tiler.py``'s recipe: a noisy tissue rectangle on white."""
    rng = np.random.default_rng(seed)
    img = np.full((size, size, 3), 255, np.uint8)
    noise = rng.integers(0, 60, size=(256, 320, 3), dtype=np.uint8)
    img[128:384, 64:384] = np.array([200, 120, 160], np.uint8) - noise // 2
    return img


def _same_as_libtiff(path: str) -> tiler.TiffSlide:
    """The port's reader and the JAX libtiff reader agree on the levels,
    the properties, the associated images and every region of ``REGIONS``."""
    ours = tiler.TiffSlide(path)
    theirs = jax_native_tiff_slide(path)
    assert ours.level_dimensions == list(theirs.level_dimensions)
    assert ours.properties == theirs.properties
    for level, x, y, w, h in REGIONS:
        if level < len(ours.level_dimensions):
            np.testing.assert_array_equal(ours.read_region((x, y), level, (w, h)),
                                          theirs.read_region((x, y), level, (w, h)))
    got, want = ours.associated_images, theirs.associated_images
    assert sorted(got) == sorted(want)
    for name in got:
        np.testing.assert_array_equal(got[name], np.asarray(want[name]))
    return ours


@pytest.mark.parametrize("layout", ["tiled", "stripped"])
@pytest.mark.parametrize("compression", [tiff.NONE, tiff.LZW, tiff.JPEG, tiff.DEFLATE,
                                         tiff.PACKBITS])
def test_libtiff_written_slides_read_as_libtiff_reads_them(tmp_path, layout, compression):
    """An Aperio layout written by libtiff: two levels, a thumbnail and a
    label; libtiff's JPEG tiles are abbreviated streams after JPEGTables."""
    img = _image(compression)
    path = str(tmp_path / "s.svs")
    tile = T if layout == "tiled" else 0
    b = native_tiff.SlideBuilder(path)
    b.add_rgb_dir(img, tile=tile, compression=compression,
                  description="Aperio Image|AppMag = 40|MPP = 0.25")
    b.add_rgb_dir(img[::4, ::4], tile=0, compression=compression, description="thumb")
    b.add_rgb_dir(img[::2, ::2], tile=tile, compression=compression)
    b.add_rgb_dir(img[:40, :60], tile=0, compression=compression, description="label 60x40")
    b.close()
    dirs = tiff.read_directories(path)
    assert [d.compression for d in dirs] == [compression] * 4
    if compression == tiff.JPEG:
        assert dirs[0].jpeg_tables is not None
    slide = _same_as_libtiff(path)
    if layout == "tiled":
        assert sorted(slide.associated_images) == ["label", "thumbnail"]


def test_lzw_with_predictor_2_from_pillow(tmp_path):
    """Pillow's writer (libtiff's LZW encoder): two stripped levels."""
    img = _image(11)
    path = str(tmp_path / "s.tif")
    Image.fromarray(img).save(path, compression="tiff_lzw", tiffinfo={317: 2}, save_all=True,
                              append_images=[Image.fromarray(img[::2, ::2])])
    assert [(d.compression, d.predictor) for d in tiff.read_directories(path)] == [(5, 2)] * 2
    _same_as_libtiff(path)


@pytest.mark.parametrize("bigtiff", [False, True])
@pytest.mark.parametrize("big_endian", [False, True])
@pytest.mark.parametrize("compression, predictor", [(tiff.NONE, 1), (tiff.DEFLATE, 2),
                                                    (tiff.ADOBE_DEFLATE, 1),
                                                    (tiff.PACKBITS, 1)])
def test_port_writer_files_read_as_libtiff_reads_them(tmp_path, bigtiff, big_endian,
                                                      compression, predictor):
    img = _image(3)
    path = str(tmp_path / "s.tif")
    tiff.write_tiff(path, [
        tiff.image_directory(img, tile=T, compression=compression, predictor=predictor,
                             description="Aperio Image|AppMag = 20"),
        tiff.image_directory(img[::2, ::2], tile=32, compression=compression,
                             predictor=predictor),
        tiff.image_directory(img[::8, ::8], rows_per_strip=5, compression=compression,
                             predictor=predictor, description="macro image")],
        bigtiff=bigtiff, big_endian=big_endian)
    with open(path, "rb") as f:
        head = f.read(4)
    assert head[:2] == (b"MM" if big_endian else b"II")
    assert head[2:] == (43 if bigtiff else 42).to_bytes(2, "big" if big_endian else "little")
    slide = _same_as_libtiff(path)
    assert list(slide.associated_images) == ["macro"]


def _cv2_tiles(img: np.ndarray, sampling: str, restart: int) -> list[bytes]:
    """Whole JPEG streams (JFIF, YCbCr), one a 64-px tile, edge tiles
    zero-padded, encoded by OpenCV (libjpeg)."""
    out = []
    for ty in range(0, img.shape[0], T):
        for tx in range(0, img.shape[1], T):
            block = np.zeros((T, T, 3), np.uint8)
            part = img[ty:ty + T, tx:tx + T]
            block[:part.shape[0], :part.shape[1]] = part
            ok, enc = cv2.imencode(".jpg", block[:, :, ::-1], [
                cv2.IMWRITE_JPEG_QUALITY, 85, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                SAMPLING[sampling], cv2.IMWRITE_JPEG_RST_INTERVAL, restart])
            assert ok
            out.append(enc.tobytes())
    return out


def _libjpeg_level(tiles: list[bytes], w: int, h: int, tables: bytes = b"",
                   mode: str = "RGB") -> np.ndarray:
    """libjpeg's decode of each tile (Pillow's; OpenCV's too for a whole
    stream), assembled into the level; ``mode`` "YCbCr": the samples
    before the colour conversion."""
    nx = -(-w // T)
    level = np.zeros((-(-h // T) * T, nx * T, 3), np.uint8)
    for i, data in enumerate(tiles):
        stream = tables[:-2] + data[2:] if tables else data
        im = Image.open(io.BytesIO(stream))
        if mode == "YCbCr":
            im.draft("YCbCr", im.size)
        px = np.asarray(im.convert(mode))
        if not tables:
            bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
            np.testing.assert_array_equal(bgr[:, :, ::-1], px)
        ty, tx = divmod(i, nx)
        level[ty * T:(ty + 1) * T, tx * T:(tx + 1) * T] = px
    return level[:h, :w]


@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("restart", [0, 2])
@pytest.mark.parametrize("photometric", [tiff.RGB, tiff.YCBCR])
def test_jpeg_tiles_read_as_libjpeg_decodes_them(tmp_path, sampling, restart, photometric):
    img = _image(20 + restart)
    tiles = _cv2_tiles(img, sampling, restart)
    assert (b"\xff\xdd" in tiles[0]) == (restart > 0)
    path = str(tmp_path / "s.tif")
    tiff.write_tiff(path, [tiff.DirectorySpec(
        width=W, height=H, blocks=tiles, compression=tiff.JPEG, tile=(T, T),
        photometric=photometric, ycbcr_subsampling=YCBCR_TAG[sampling],
        description="Aperio Image|AppMag = 20"), tiff.image_directory(img[::4, ::4], tile=T)])
    want = _libjpeg_level(tiles, W, H)
    slide = tiler.TiffSlide(path)
    np.testing.assert_array_equal(slide.read_region((0, 0), 0, (W, H)), want)
    np.testing.assert_array_equal(slide.read_region((250, 200), 0, (200, 150))[:100, :160],
                                  want[200:, 250:])
    if photometric == tiff.YCBCR:  # libtiff converts through libjpeg too
        _same_as_libtiff(path)


def _pillow_tiles(img: np.ndarray, subsampling: int) -> tuple[list[bytes], bytes]:
    """Aperio-style tiles: abbreviated streams (Pillow's ``streamtype=2``)
    and the tables stream that goes in ``JPEGTables``."""
    tiles = []
    for ty in range(0, img.shape[0], T):
        for tx in range(0, img.shape[1], T):
            block = np.zeros((T, T, 3), np.uint8)
            part = img[ty:ty + T, tx:tx + T]
            block[:part.shape[0], :part.shape[1]] = part
            buf = io.BytesIO()
            Image.fromarray(block).save(buf, "JPEG", quality=85, subsampling=subsampling,
                                        streamtype=2)
            tiles.append(buf.getvalue())
    buf = io.BytesIO()
    Image.fromarray(img[:16, :16]).save(buf, "JPEG", quality=85, subsampling=subsampling,
                                        streamtype=1)
    return tiles, buf.getvalue()


def _write_jpeg_slide(path: str, img: np.ndarray, photometric: int,
                      subsampling: int = 2) -> tuple[list, bytes]:
    """Two levels (the second 4x smaller) of Pillow's abbreviated tiles;
    returns level 0's tiles and tables."""
    tiles, tables = _pillow_tiles(img, subsampling)
    low = img[::4, ::4]
    low_tiles, low_tables = _pillow_tiles(low, subsampling)
    ss = {0: (1, 1), 1: (2, 1), 2: (2, 2)}[subsampling]
    tiff.write_tiff(path, [
        tiff.DirectorySpec(width=img.shape[1], height=img.shape[0], blocks=tiles,
                           compression=tiff.JPEG, tile=(T, T), photometric=photometric,
                           jpeg_tables=tables, ycbcr_subsampling=ss,
                           description="Aperio Image|AppMag = 20|MPP = 0.5"),
        tiff.DirectorySpec(width=low.shape[1], height=low.shape[0], blocks=low_tiles,
                           compression=tiff.JPEG, tile=(T, T), photometric=photometric,
                           jpeg_tables=low_tables, ycbcr_subsampling=ss)])
    return tiles, tables


@pytest.mark.parametrize("subsampling", [0, 2])
def test_aperio_style_streams_read_as_libjpeg_not_as_libtiff(tmp_path, subsampling):
    """YCbCr streams under Photometric RGB (what Aperio scanners write):
    the port reads libjpeg's decode; the JAX libtiff route refuses the 4:2:0
    stream and hands the 4:4:4 one's YCbCr samples back as RGB."""
    img = _image(30 + subsampling)
    path = str(tmp_path / "s.svs")
    tiles, tables = _write_jpeg_slide(path, img, tiff.RGB, subsampling)
    want = _libjpeg_level(tiles, W, H, tables)
    ours = tiler.TiffSlide(path).read_region((0, 0), 0, (W, H))
    np.testing.assert_array_equal(ours, want)
    theirs = jax_native_tiff_slide(path)
    if subsampling:
        with pytest.raises(OSError):
            theirs.read_region((0, 0), 0, (W, H))
    else:
        got = theirs.read_region((0, 0), 0, (W, H))
        assert np.abs(got.astype(int) - want).max() > 50
        np.testing.assert_array_equal(got, _libjpeg_level(tiles, W, H, tables, "YCbCr"))


def test_the_committed_fixture_decodes_to_its_digests():
    """``tests/data/torch_tiff/`` (``tools/make_tiff_fixture.py``): every
    level and associated image at libjpeg's digests."""
    with open(os.path.join(FIXTURE, "fixture.json")) as f:
        meta = json.load(f)
    slide = tiler.open_slide(os.path.join(FIXTURE, meta["slide"]))
    assert isinstance(slide, tiler.TiffSlide)
    assert slide.level_dimensions == [tuple(lv["size"]) for lv in meta["levels"]]
    assert slide.properties["aperio.AppMag"] == str(meta["app_mag"])
    for level, lv in enumerate(meta["levels"]):
        px = slide.read_region((0, 0), level, tuple(lv["size"]))
        assert hashlib.sha256(px.tobytes()).hexdigest() == lv["sha256"]
    assoc = slide.associated_images
    assert sorted(assoc) == sorted(meta["associated"])
    for name, a in meta["associated"].items():
        assert assoc[name].shape[1::-1] == tuple(a["size"])
        assert hashlib.sha256(assoc[name].tobytes()).hexdigest() == a["sha256"]


def test_the_block_cache_changes_no_pixel(tmp_path, monkeypatch):
    """Overlapping reads with the LRU and without it: the same pixels, and
    the LRU decodes fewer tiles."""
    path = str(tmp_path / "s.svs")
    _write_jpeg_slide(path, _image(40), tiff.RGB)
    decoded = []
    real = codecs.decode_blocks

    def counting(*args, **kwargs):
        decoded.append(len(args[1]))
        return real(*args, **kwargs)

    monkeypatch.setattr(codecs, "decode_blocks", counting)
    rng = np.random.default_rng(0)
    boxes = [(int(x), int(y)) for x, y in rng.integers(-20, 380, (40, 2))]
    runs = {}
    for cache in (64, 0):
        slide = tiler.TiffSlide(path)
        slide.cache_blocks = cache
        decoded.clear()
        runs[cache] = [slide.read_region(xy, 0, (70, 70)) for xy in boxes]
        runs[f"{cache}_decoded"] = sum(decoded)
    for a, b in zip(runs[64], runs[0]):
        np.testing.assert_array_equal(a, b)
    assert runs["64_decoded"] <= 35 < runs["0_decoded"]
    # the whole level (35 blocks in one decode) through an LRU of 8: the
    # last 8 are kept, each owning its pixels (none keeps the decode alive)
    slide = tiler.TiffSlide(path)
    slide.cache_blocks = 8
    uncached = tiler.TiffSlide(path)
    uncached.cache_blocks = 0
    np.testing.assert_array_equal(slide.read_region((0, 0), 0, (W, H)),
                                  uncached.read_region((0, 0), 0, (W, H)))
    assert len(slide._cache) == 8
    assert all(b.base is None and b.shape == (T, T, 3) for b in slide._cache.values())


@pytest.mark.parametrize("gray", [False, True])
def test_jpeg_slides_read_as_the_jax_image_slide_reads_them(tmp_path, gray):
    img = _image(50, 700, 1100)
    path = str(tmp_path / "s.jpg")
    cv2.imwrite(path, img[..., 0] if gray else img[:, :, ::-1], [cv2.IMWRITE_JPEG_QUALITY, 90])
    ours, theirs = tiler.open_slide(path), jax_tiler.ImageSlide(path)
    assert isinstance(ours, tiler.ImageSlide)
    assert ours.level_dimensions == theirs.level_dimensions == [(1100, 700), (550, 350)]
    np.testing.assert_array_equal(ours.img, theirs.img)
    for level, xy, size in ((0, (1000, 650), (150, 100)), (1, (0, 0), (550, 350))):
        np.testing.assert_array_equal(ours.read_region(xy, level, size),
                                      theirs.read_region(xy, level, size))


def _rewrite_tile(path: str, index: int, data: bytes) -> None:
    """Point tile ``index`` of directory 0 at ``data``, appended to the file."""
    d = tiff.read_directories(path)[0]
    with open(path, "rb") as f:
        raw = bytearray(f.read())
    new_off = len(raw)
    raw += data
    for arr_tag, value in ((324, new_off), (325, len(data))):
        _patch_entry(raw, arr_tag, index, value, len(d.offsets))
    with open(path, "wb") as f:
        f.write(raw)


def _patch_entry(raw: bytearray, tag: int, index: int, value: int, count: int) -> None:
    """Set element ``index`` of a LONG array tag in a classic little-endian
    file's first IFD."""
    ifd = int.from_bytes(raw[4:8], "little")
    n = int.from_bytes(raw[ifd:ifd + 2], "little")
    for i in range(n):
        e = ifd + 2 + 12 * i
        if int.from_bytes(raw[e:e + 2], "little") == tag:
            at = int.from_bytes(raw[e + 8:e + 12], "little") if count > 1 else e + 8
            raw[at + 4 * index:at + 4 * index + 4] = value.to_bytes(4, "little")
            return
    raise KeyError(tag)


@pytest.mark.parametrize("fault", ["truncated", "corrupt", "progressive", "deflate"])
def test_a_tile_that_does_not_decode_raises_naming_it(tmp_path, fault):
    img = _image(60)
    path = str(tmp_path / "s.svs")
    if fault == "deflate":
        tiff.write_tiff(path, [tiff.image_directory(img, tile=T, compression=tiff.DEFLATE),
                               tiff.image_directory(img[::4, ::4], tile=T)])
        bad = b"\x78\x9c" + bytes(range(200))
    else:
        tiles, _ = _write_jpeg_slide(path, img, tiff.RGB)
        if fault == "truncated":
            bad = tiles[8][:len(tiles[8]) // 2]
        elif fault == "corrupt":
            bad = b"\xff\xd8" + np.random.default_rng(0).bytes(300)
        else:
            buf = io.BytesIO()
            Image.fromarray(img[:T, :T]).save(buf, "JPEG", progressive=True)
            bad = buf.getvalue()
    _rewrite_tile(path, 8, bad)  # tile (1, 1)
    slide = tiler.TiffSlide(path)
    first = slide.read_region((0, 0), 0, (T, T))  # tile (0, 0) alone still reads
    if fault == "deflate":
        np.testing.assert_array_equal(first, img[:T, :T])
    what = {"truncated": "truncated data", "corrupt": "corrupt data",
            "progressive": "progressive", "deflate": "corrupt data"}[fault]
    with pytest.raises(codecs.DecodeError, match=rf"s\.svs: level 0, tile \(1, 1\).*{what}"):
        slide.read_region((60, 60), 0, (20, 20))


def test_aperio_jpeg_2000_levels_raise_naming_the_codec(tmp_path):
    """JPEG 2000 in strips (which the JAX reader does not read either)
    raises naming the codec; the same codestreams in tiles decode (as
    Pillow decodes them; ``tests/test_torch_j2k.py`` holds the rest)."""
    img = _image(1, 128, 128)
    streams = []
    for y in range(0, 128, T):
        for x in range(0, 128, T):
            buf = io.BytesIO()
            Image.fromarray(img[y:y + T, x:x + T]).save(buf, "JPEG2000", no_jp2=True,
                                                        irreversible=True)
            streams.append(buf.getvalue())
    stripped, tiled = str(tmp_path / "s.svs"), str(tmp_path / "t.svs")
    for path, spec, tile in ((stripped, dict(blocks=streams[::2], rows_per_strip=T), None),
                             (tiled, dict(blocks=streams, tile=(T, T)), T)):
        tiff.write_tiff(path, [tiff.DirectorySpec(width=128, height=128, compression=33003,
                                                  photometric=tiff.YCBCR, **spec),
                               tiff.image_directory(_image(1, 32, 32), tile=tile)])
    slide = tiler.TiffSlide(stripped)
    with pytest.raises(NotImplementedError,
                       match=r"s\.svs: level 0 holds Aperio JPEG 2000 \(YCbCr\) strips"):
        slide.read_region((0, 0), 0, (10, 10))
    want = np.zeros_like(img)
    for i, data in enumerate(streams):
        y, x = (i // 2) * T, (i % 2) * T
        want[y:y + T, x:x + T] = np.asarray(
            Image.fromarray(np.asarray(Image.open(io.BytesIO(data))), mode="YCbCr").convert("RGB"))
    np.testing.assert_array_equal(tiler.open_slide(tiled).read_region((0, 0), 0, (128, 128)),
                                  want)


@pytest.mark.parametrize("name, flagged", [("s.ndpi", True), ("s.ndpi", False),
                                           ("s.tif", True)])
def test_ndpi_files_raise_naming_the_file_and_the_format(tmp_path, name, flagged):
    """Hamamatsu NDPI (its format tag 65420, or the ``.ndpi`` extension)
    raises when opened, before any level is parsed as a plain TIFF."""
    path = str(tmp_path / name)
    level = tiff.image_directory(_image(3, 128, 128), rows_per_strip=128)
    if flagged:
        level.extra_tags = {tiff.NDPI_TAG: (4, [1])}
    tiff.write_tiff(path, [level, tiff.image_directory(_image(3, 32, 32), rows_per_strip=32)])
    assert any(d.ndpi for d in tiff.read_directories(path)) == flagged
    with pytest.raises(ValueError, match=rf"{name.replace('.', '[.]')}: a Hamamatsu NDPI file"):
        tiler.open_slide(path)
    if flagged:
        with pytest.raises(ValueError, match="NDPI"):
            tiler.TiffSlide(path)


def test_progressive_jpeg_slides_raise_naming_the_codec(tmp_path):
    path = str(tmp_path / "s.jpg")
    Image.fromarray(_image(2, 64, 64)).save(path, "JPEG", progressive=True)
    with pytest.raises(codecs.DecodeError, match=r"s\.jpg: progressive"):
        tiler.open_slide(path)


def test_four_processes_build_the_codecs_at_once(tmp_path):
    build_dir = tmp_path / "build"
    code = textwrap.dedent(f"""
        from pathlib import Path
        from multimodalbrainsurvival_torch.data import codecs
        lib = codecs.load(Path({str(build_dir)!r}))
        print(lib.tiff_decode_blocks.restype is not None)
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "True"
    assert sorted(os.listdir(build_dir)) == [codecs.library_path(build_dir).name]


def test_a_failed_codec_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    broken = tmp_path / "tiff_codecs.cc"
    broken.write_text("int tiff_decode_blocks( {\n")
    monkeypatch.setattr(codecs, "SOURCES", (broken, codecs.CSRC / "j2k.cc"))
    with pytest.raises(RuntimeError, match=r"(?s)g\+\+ failed.*: error:"):
        codecs.build(tmp_path / "build")
    assert not any((tmp_path / "build").iterdir())


# --- the whole-slide CLIs on a JPEG-tiled slide --------------------------------


@pytest.fixture(scope="module")
def jpeg_slide(tmp_path_factory):
    """A 512-px tissue slide of 4:2:0 JPEG tiles under Photometric YCbCr
    (which libtiff decodes through libjpeg, so the JAX CLIs read the same
    pixels), with a level 4x smaller."""
    root = tmp_path_factory.mktemp("jpeg_slide")
    (root / "wsi").mkdir()
    path = str(root / "wsi" / "J1.svs")
    _write_jpeg_slide(path, _tissue_slide(9), tiff.YCBCR)
    return root, path


def test_wsi2patches_on_a_jpeg_tiled_slide_equals_the_jax_cli(jpeg_slide, tmp_path):
    from multimodalbrainsurvival_tpu.cli import wsi2patches as jax_wsi2patches

    root, _ = jpeg_slide
    common = ["--wsi_path", str(root / "wsi"), "--patch_size", "64",
              "--max_patches_per_slide", "12", "--num_process", "1", "--ext", "svs"]
    wsi2patches.main(common + ["--patch_path", str(tmp_path / "p"), "--mask_path",
                               str(tmp_path / "m"), "--device", "cpu"])
    jax_wsi2patches.main(common + ["--patch_path", str(tmp_path / "jp"), "--mask_path",
                                   str(tmp_path / "jm")])
    ours, theirs = tmp_path / "p" / "J1", tmp_path / "jp" / "J1"
    assert (ours / "loc.txt").read_text() == (theirs / "loc.txt").read_text()
    np.testing.assert_array_equal(np.load(tmp_path / "m" / "J1" / "mask.npy"),
                                  np.load(tmp_path / "jm" / "J1" / "mask.npy"))
    n = len((ours / "loc.txt").read_text().splitlines()) - 2
    assert n == 12
    for i in range(n):
        np.testing.assert_array_equal(tiler.read_png(str(ours / f"J1_patch_{i}.png")),
                                      cv2.imread(str(theirs / f"J1_patch_{i}.png"))[:, :, ::-1])


def _random_state(model, seed):
    """``tests/test_torch_slide_extract.py``'s weights: BN near identity,
    fan-in-scaled kernels."""
    rng = np.random.default_rng(seed)
    state = {}
    for k, v in model.state_dict().items():
        if not v.is_floating_point():
            state[k] = v
        elif k.endswith("running_var") or (k.endswith("weight") and v.dim() == 1):
            state[k] = torch.tensor(rng.uniform(0.5, 1.5, v.shape), dtype=torch.float32)
        elif v.dim() == 1:
            state[k] = torch.tensor(rng.normal(0.0, 0.1, v.shape), dtype=torch.float32)
        else:
            state[k] = torch.tensor(rng.normal(0.0, 1.0, v.shape) / np.sqrt(v[0].numel()),
                                    dtype=torch.float32)
    return state


def _save_flax(tree, path):
    import jax

    from multimodalbrainsurvival_tpu.train.checkpoint import Checkpointer

    Checkpointer().save(path, jax.tree.map(np.asarray, tree), block=True)


def _run_both(root, name, jax_main, port_main, cfg, port_model, jax_model):
    """One config through the JAX CLI and the port's (``--device cpu``);
    their output directories."""
    out = {}
    for stack, main, model, extra in (("jax", jax_main, jax_model, []),
                                      ("port", port_main, port_model, ["--device", "cpu"])):
        c = dict(cfg, model_path=str(root / model), output_path=str(root / f"{name}_{stack}"))
        (root / f"{name}_{stack}.json").write_text(json.dumps(c))
        main(["--config", str(root / f"{name}_{stack}.json")] + extra)
        out[stack] = root / f"{name}_{stack}"
    return out["jax"], out["port"]


CLI_CFG = {"model_name": "resnet18", "num_classes": 1, "aggregator_hdim": 512, "img_size": 64,
           "batch_size": 8, "max_patches_per_slide": 16, "compute_dtype": "float32"}
CLI_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def extract_runs(jpeg_slide):
    from multimodalbrainsurvival_tpu.cli import slide_extractfeatures as jax_sx
    from multimodalbrainsurvival_tpu.models.convert import torch_mil_to_flax

    root, path = jpeg_slide
    cfg = dict(CLI_CFG, aggregator="attention", slides=[path], save_patch_features=True)
    state = _random_state(build_mil_model(Config(cfg)), seed=3)
    torch.save(state, str(root / "mil.pt"))
    _save_flax(torch_mil_to_flax({k: v.numpy() for k, v in state.items()}),
               str(root / "mil_flax"))
    return _run_both(root, "extract", jax_sx.main, slide_extractfeatures.main, cfg, "mil.pt",
                     "mil_flax")


def test_slide_extractfeatures_on_a_jpeg_tiled_slide_matches_the_jax_cli(extract_runs):
    jax_dir, port_dir = extract_runs
    got = pd.read_csv(port_dir / "slide_scores.csv")
    want = pd.read_csv(jax_dir / "slide_scores.csv")
    assert list(got["n_patches"]) == list(want["n_patches"]) == [16]
    np.testing.assert_allclose(got["score"], want["score"], **CLI_TOL)
    gp = pd.read_csv(port_dir / "patch_features" / "J1_patches.csv")
    wp = pd.read_csv(jax_dir / "patch_features" / "J1_patches.csv")
    assert list(zip(gp["x"], gp["y"])) == list(zip(wp["x"], wp["y"]))
    np.testing.assert_allclose(gp["attention"], wp["attention"], **CLI_TOL)
    np.testing.assert_allclose(np.load(port_dir / "patch_features" / "J1_features.npy"),
                               np.load(jax_dir / "patch_features" / "J1_features.npy"),
                               **CLI_TOL)
    np.testing.assert_allclose(
        np.loadtxt(port_dir / "pathology_features_slides.csv", delimiter=","),
        np.loadtxt(jax_dir / "pathology_features_slides.csv", delimiter=","), **CLI_TOL)


def test_attention_heatmap_on_a_jpeg_tiled_slide_matches_the_jax_cli(jpeg_slide,
                                                                     extract_runs, tmp_path):
    """The heatmap over the slide's thumbnail (its lowest level): equal pixels."""
    from multimodalbrainsurvival_tpu.cli import attention_heatmap as jax_heatmap

    _, path = jpeg_slide
    csv = str(extract_runs[1] / "patch_features" / "J1_patches.csv")
    extra = ["--slide", path, "--target", "100"]
    attention_heatmap.main(["--patches_csv", csv, "--output", str(tmp_path / "port.png"),
                            "--device", "cpu"] + extra)
    jax_heatmap.main(["--patches_csv", csv, "--output", str(tmp_path / "jax.png")] + extra)
    np.testing.assert_array_equal(tiler.read_png(str(tmp_path / "port.png")),
                                  cv2.imread(str(tmp_path / "jax.png"))[:, :, ::-1])


def test_slide_joint_savescore_on_a_jpeg_tiled_slide_matches_the_jax_cli(jpeg_slide):
    from multimodalbrainsurvival_tpu.cli import slide_joint_savescore as jax_sj
    from multimodalbrainsurvival_tpu.models.convert import torch_joint_to_flax

    root, _ = jpeg_slide
    genes = 24
    rng = np.random.default_rng(7)
    joint = pd.DataFrame({"case": ["c1"], "wsi_file_name": ["J1.svs"],
                          "survival_months": [12.5], "vital_status": [1]})
    for g in range(genes):
        joint[f"rna_{g}"] = rng.normal(size=1).astype(np.float32)
    joint.to_csv(root / "joint.csv", index=False)
    cfg = dict(CLI_CFG, aggregator="identity", slide_csv_path=str(root / "joint.csv"),
               slide_path=str(root / "wsi"))
    state = _random_state(build_joint_model(Config(cfg), in_features=genes), seed=5)
    torch.save(state, str(root / "joint.pt"))
    _save_flax(torch_joint_to_flax({k: v.numpy() for k, v in state.items()}),
               str(root / "joint_flax"))
    jax_dir, port_dir = _run_both(root, "joint", jax_sj.main, slide_joint_savescore.main, cfg,
                                  "joint.pt", "joint_flax")
    want = pd.read_csv(jax_dir / "joint_slide_scores.csv")
    got = pd.read_csv(port_dir / "joint_slide_scores.csv")
    assert list(got.columns) == list(want.columns)
    for col in ("slide", "case", "n_patches", "survival_months", "vital_status"):
        assert list(got[col]) == list(want[col])
    assert list(got["n_patches"]) == [16]
    np.testing.assert_allclose(got["score"], want["score"], **CLI_TOL)
