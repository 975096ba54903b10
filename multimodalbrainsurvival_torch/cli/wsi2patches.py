"""Whole-slide tiling CLI.

Parity with ``1_HistoPathology/1_WSI2Patches.py:147-182`` and the JAX CLI
``multimodalbrainsurvival_tpu/cli/wsi2patches.py``: the same flags and the
same artifacts (per-slide patch PNGs, ``loc.txt``, ``mask.npy``), slides
fanned out over processes (``data/tiler.py``). Reads TIFF pyramids
(``.svs``, ``.tif``, ...; OpenSlide where it is importable, else the
native libtiff reader) and PNG images. The tiling runs on the host;
``--device`` follows every entry point's rule (``cuda`` by default, which
raises without a card).

    python -m multimodalbrainsurvival_torch.cli.wsi2patches --wsi_path wsi/ \\
        --patch_path patches/ --mask_path masks/ --ext svs --device cpu
"""

from __future__ import annotations

import argparse
import glob
import os

from multimodalbrainsurvival_torch.data.tiler import TileConfig, tile_slides
from multimodalbrainsurvival_torch.device import resolve_device


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--wsi_path", type=str, required=True,
                   help="directory of whole-slide images")
    p.add_argument("--patch_path", type=str, required=True)
    p.add_argument("--mask_path", type=str, required=True)
    p.add_argument("--patch_size", type=int, default=224)
    p.add_argument("--max_patches_per_slide", type=int, default=2000)
    p.add_argument("--num_process", type=int, default=10)
    p.add_argument("--dezoom_factor", type=float, default=1.0)
    p.add_argument("--ext", type=str, default="svs",
                   help="slide file extension to glob (svs, png, tif, ...)")
    p.add_argument("--pack", type=int, default=0,
                   help="also write patches.npy shards")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    a = p.parse_args(argv)
    resolve_device(a.device)

    slides = sorted(glob.glob(os.path.join(a.wsi_path, f"*.{a.ext}")))
    if not slides:
        raise SystemExit(f"no *.{a.ext} slides under {a.wsi_path}")
    os.makedirs(a.patch_path, exist_ok=True)
    os.makedirs(a.mask_path, exist_ok=True)
    cfg = TileConfig(patch_size=a.patch_size, max_patches_per_slide=a.max_patches_per_slide,
                     dezoom_factor=a.dezoom_factor, pack=bool(a.pack))
    counts = tile_slides(slides, a.patch_path, a.mask_path, cfg, num_processes=a.num_process)
    for s, n in zip(slides, counts):
        print(f"{os.path.basename(s)}: {n} patches")


if __name__ == "__main__":
    main()
