"""Packed patch shards: ``pack_patch_dir`` (JAX ``data/tiler.py:394-423``).

A slide's patch directory (``loc.txt`` and ``<slide>_patch_<i>.png``)
becomes ``<dir>/patches.npy``, an (N, P, P, 3) uint8 RGB array the
datasets read rows of with no decode. The PNGs are decoded by the C++
loader (``data/native.py``; the JAX package reads them with cv2 and flips
BGR to RGB, the loader gives RGB). The tiler itself (whole-slide images to
patches) is not ported yet (ROADMAP.md, queue 1, item 6).
"""

from __future__ import annotations

import os
import struct

import numpy as np

from multimodalbrainsurvival_torch.data import native

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def png_size(path: str) -> tuple[int, int]:
    """(height, width) from a PNG's IHDR chunk."""
    with open(path, "rb") as f:
        head = f.read(24)
    if len(head) < 24 or head[:8] != PNG_SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"not a PNG: {path}")
    width, height = struct.unpack(">II", head[16:24])
    return height, width


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
