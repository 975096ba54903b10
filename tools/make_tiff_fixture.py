"""Write the JPEG-tiled slide fixture of ``tests/data/torch_tiff/``.

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
        "seed": SEED, "tile": TILE, "quality": QUALITY, "app_mag": 20,
        "levels": [{"size": [SIZE, SIZE], "sha256": sha256(px0)},
                   {"size": [SIZE // 4, SIZE // 4], "sha256": sha256(px1)}],
        "associated": {"thumbnail": {"size": list(thumb.shape[1::-1]), "sha256": sha256(pxt)},
                       "label": {"size": list(label.shape[1::-1]), "sha256": sha256(label)}},
    }
    with open(os.path.join(args.out, "fixture.json"), "w") as f:
        json.dump(meta, f, indent=1)
        f.write("\n")
    print(f"{path}: {os.path.getsize(path)} bytes; {json.dumps(meta)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
