"""Write the JPEG- and JPEG 2000-tiled slide fixtures of ``tests/data/torch_tiff/``.

An Aperio-style pyramid, made from a seed: a 2,048 x 2,048 level of
240-px JPEG tiles (quality 80, YCbCr 4:2:0, abbreviated streams whose
tables are in ``JPEGTables``, under Photometric RGB as Aperio scanners
write them) and a 512 x 512 level of the same kind, then a thumbnail (JPEG
strips of 64 rows) and a label (uncompressed) as stripped directories.
The tiles are encoded by Pillow (libjpeg) and the container is written by
the port's ``data/tiff.py``. Beside the slide, ``fixture.json`` holds the
SHA-256 of each level's and each associated image's pixels as libjpeg
decodes them (Pillow on each tile's tables and stream), which the tests and
``chip_smoke.py`` hold the port's reader to.

Two Aperio-style JPEG 2000 slides go beside it, each tile a bare
codestream (``no_jp2``) encoded by Pillow (OpenJPEG): ``aperio_j2k.svs``,
the same image as a 2,048 x 2,048 and a 512 x 512 level of 240-px tiles
under compression 33003 (irreversible 9/7, no component transform, the
samples Y, Cb, Cr as Aperio writes them) with a thumbnail in deflate strips,
and ``aperio_j2k_rgb.svs``, a small 33005 slide (reversible 5/3, RGB, two
quality layers). Their digests in ``fixture.json`` (``"j2k"``) are the
pixels the JAX package's libtiff reader (``NativeTiffSlide``, which decodes
the codestreams with Pillow) reads.

Run from the root of the repository where Pillow is installed (the machine
with the card has none; it reads the committed files):

    python tools/make_tiff_fixture.py [--out tests/data/torch_tiff]
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import sys

import numpy as np
from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from multimodalbrainsurvival_torch.data import tiff  # noqa: E402
from multimodalbrainsurvival_tpu.data.tiler import NativeTiffSlide  # noqa: E402

SEED = 17
SIZE, TILE, QUALITY = 2048, 240, 80
TISSUE = (320, 1728)  # the tissue square's first and last row / column
DESCRIPTION = ("Aperio Image Library fixture\r\n2048x2048 [0,0 2048x2048] (240x240) "
               "JPEG/RGB Q=80|AppMag = 20|MPP = 0.4990")


def slide_image(seed: int = SEED) -> np.ndarray:
    """White, with a square of stained tissue: a smooth field of 32-px
    cells plus fine grain on (200, 120, 160)."""
    rng = np.random.default_rng(seed)
    img = np.full((SIZE, SIZE, 3), 255, np.uint8)
    lo, hi = TISSUE
    n = hi - lo
    coarse = rng.integers(0, 40, size=(n // 32 + 1, n // 32 + 1, 3))
    field = np.repeat(np.repeat(coarse, 32, 0), 32, 1)[:n, :n]
    grain = rng.integers(0, 24, size=(n, n, 3))
    img[lo:hi, lo:hi] = np.array([200, 120, 160]) - (field + grain) // 2
    return img


def _jpeg(block: np.ndarray, streamtype: int) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(block).save(buf, "JPEG", quality=QUALITY, subsampling=2,
                                streamtype=streamtype)
    return buf.getvalue()


def libjpeg_decode(tables: bytes, stream: bytes) -> np.ndarray:
    """libjpeg's decode of an abbreviated stream after its tables."""
    return np.asarray(Image.open(io.BytesIO(tables[:-2] + stream[2:])).convert("RGB"))


def jpeg_directory(img: np.ndarray, tile: int | None, rows: int = 0,
                   description: str = "") -> tuple[tiff.DirectorySpec, np.ndarray]:
    """A directory of abbreviated JPEG blocks (tiles, or strips of ``rows``)
    and libjpeg's decode of it."""
    tables = _jpeg(np.zeros((16, 16, 3), np.uint8), streamtype=1)
    h, w = img.shape[:2]
    blocks, decoded = [], np.zeros_like(img)
    bw, bh = (tile, tile) if tile else (w, rows)
    for y in range(0, h, bh):
        for x in range(0, w, bw):
            part = img[y:y + bh, x:x + bw]
            block = np.full((bh, bw, 3), 255, np.uint8) if tile else part
            block[:part.shape[0], :part.shape[1]] = part
            blocks.append(_jpeg(block, streamtype=2))
            decoded[y:y + bh, x:x + bw] = libjpeg_decode(tables, blocks[-1])[
                :part.shape[0], :part.shape[1]]
    spec = tiff.DirectorySpec(width=w, height=h, blocks=blocks, compression=tiff.JPEG,
                              tile=(tile, tile) if tile else None, rows_per_strip=rows,
                              photometric=tiff.RGB, jpeg_tables=tables,
                              ycbcr_subsampling=(2, 2), description=description)
    return spec, decoded


J2K_RATE = 24  # the 33003 slide's compression ratio (OpenJPEG's "rates" layer)
J2K_RGB_SIZE, J2K_RGB_RATES = 480, [60, 16]


def j2k_directory(img: np.ndarray, tile: int, compression: int, description: str = "",
                  **encode) -> tiff.DirectorySpec:
    """A directory of bare JPEG 2000 codestreams, one a tile (edge tiles
    padded with white to the full tile, as Aperio writes them); under 33003
    each tile's samples are Pillow's Y, Cb, Cr, coded with no component
    transform."""
    h, w = img.shape[:2]
    blocks = []
    for y in range(0, h, tile):
        for x in range(0, w, tile):
            block = np.full((tile, tile, 3), 255, np.uint8)
            part = img[y:y + tile, x:x + tile]
            block[:part.shape[0], :part.shape[1]] = part
            if compression == tiff.APERIO_J2K_YCBCR:
                block = np.asarray(Image.fromarray(block).convert("YCbCr"))
            buf = io.BytesIO()
            Image.fromarray(block).save(buf, "JPEG2000", no_jp2=True, mct=0, **encode)
            blocks.append(buf.getvalue())
    return tiff.DirectorySpec(width=w, height=h, blocks=blocks, compression=compression,
                              tile=(tile, tile), photometric=tiff.RGB,
                              description=description)


def jax_digests(path: str) -> dict:
    """Each level's and each associated image's size and SHA-256 as the JAX
    libtiff reader reads them."""
    slide = NativeTiffSlide(path)
    levels = [{"size": list(size), "sha256": sha256(slide.read_region((0, 0), i, size))}
              for i, size in enumerate(slide.level_dimensions)]
    associated = {name: {"size": list(im.size), "sha256": sha256(np.asarray(im.convert("RGB")))}
                  for name, im in slide.associated_images.items()}
    return {"slide": os.path.basename(path), "levels": levels, "associated": associated}


def write_j2k_slides(out: str, img: np.ndarray, level1: np.ndarray,
                     thumb: np.ndarray) -> list[dict]:
    """``aperio_j2k.svs`` (33003) and ``aperio_j2k_rgb.svs`` (33005) and
    their JAX digests."""
    path = os.path.join(out, "aperio_j2k.svs")
    desc = DESCRIPTION.replace("JPEG/RGB Q=80", "J2K/YUV16 Q=70")
    tiff.write_tiff(path, [
        j2k_directory(img, TILE, tiff.APERIO_J2K_YCBCR, desc, irreversible=True,
                      quality_mode="rates", quality_layers=[J2K_RATE]),
        tiff.image_directory(thumb, rows_per_strip=64, compression=tiff.DEFLATE,
                             description="thumbnail 256x256"),
        j2k_directory(level1, TILE, tiff.APERIO_J2K_YCBCR, irreversible=True,
                      quality_mode="rates", quality_layers=[J2K_RATE])])
    rgb_path = os.path.join(out, "aperio_j2k_rgb.svs")
    lo = TISSUE[0] + 160
    small = img[lo:lo + J2K_RGB_SIZE, lo:lo + J2K_RGB_SIZE]
    tiff.write_tiff(rgb_path, [
        j2k_directory(small, TILE, tiff.APERIO_J2K_RGB,
                      DESCRIPTION.replace("2048x2048 [0,0 2048x2048]", "480x480 [0,0 480x480]"),
                      irreversible=False, quality_mode="rates", quality_layers=J2K_RGB_RATES),
        j2k_directory(small[::2, ::2], TILE, tiff.APERIO_J2K_RGB, irreversible=False,
                      quality_mode="rates", quality_layers=J2K_RGB_RATES)])
    return [dict(jax_digests(path), compression=tiff.APERIO_J2K_YCBCR, rate=J2K_RATE),
            dict(jax_digests(rgb_path), compression=tiff.APERIO_J2K_RGB, rates=J2K_RGB_RATES)]


def sha256(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img, np.uint8).tobytes()).hexdigest()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("tests", "data", "torch_tiff"))
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    img = slide_image()
    level1 = img.reshape(SIZE // 4, 4, SIZE // 4, 4, 3).mean((1, 3)).round().astype(np.uint8)
    thumb = img[::8, ::8]
    label = np.full((60, 120, 3), 230, np.uint8)
    label[20:40, 10:110] = 20
    d0, px0 = jpeg_directory(img, TILE, description=DESCRIPTION)
    d1, px1 = jpeg_directory(level1, TILE)
    dt, pxt = jpeg_directory(thumb, None, rows=64, description="thumbnail 256x256")
    dl = tiff.image_directory(label, description="label 120x60")
    path = os.path.join(args.out, "aperio_jpeg.svs")
    tiff.write_tiff(path, [d0, dt, d1, dl])
    meta = {
        "slide": os.path.basename(path), "made_by": "tools/make_tiff_fixture.py",
        "seed": SEED, "tile": TILE, "quality": QUALITY, "app_mag": 20, "tissue": list(TISSUE),
        "levels": [{"size": [SIZE, SIZE], "sha256": sha256(px0)},
                   {"size": [SIZE // 4, SIZE // 4], "sha256": sha256(px1)}],
        "associated": {"thumbnail": {"size": list(thumb.shape[1::-1]), "sha256": sha256(pxt)},
                       "label": {"size": list(label.shape[1::-1]), "sha256": sha256(label)}},
        "j2k": write_j2k_slides(args.out, img, level1, thumb),
    }
    with open(os.path.join(args.out, "fixture.json"), "w") as f:
        json.dump(meta, f, indent=1)
        f.write("\n")
    for name in [meta["slide"]] + [j["slide"] for j in meta["j2k"]]:
        print(f"{name}: {os.path.getsize(os.path.join(args.out, name))} bytes")
    print(json.dumps(meta))
    return 0


if __name__ == "__main__":
    sys.exit(main())
