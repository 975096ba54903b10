"""Repack per-slide PNG patch directories into shards the loaders read.

Parity with the JAX CLI ``multimodalbrainsurvival_tpu/cli/pack_patches.py``:
writes ``<slide>/patches.npy``, an (N, P, P, 3) uint8 RGB array of the
slide's patches, for every directory under ``--patch_path`` with a
``loc.txt`` (``data/tiler.py::pack_patch_dir``: the PNGs decoded by the
C++ loader, built with g++ and zlib on first use). The PNGs and
``loc.txt`` stay as they are; a slide whose shard is at least as new as
its ``loc.txt`` is skipped. No device work.

    python -m multimodalbrainsurvival_torch.cli.pack_patches --patch_path patches/
"""

from __future__ import annotations

import argparse
import glob
import os

from multimodalbrainsurvival_torch.data.tiler import pack_patch_dir


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--patch_path", type=str, required=True,
                   help="root directory of per-slide patch dirs")
    p.add_argument("--num_threads", type=int, default=8,
                   help="decoding threads of the C++ loader")
    a = p.parse_args(argv)
    dirs = sorted(d for d in glob.glob(os.path.join(a.patch_path, "*"))
                  if os.path.isfile(os.path.join(d, "loc.txt")))
    if not dirs:
        raise SystemExit(f"no patch dirs with loc.txt under {a.patch_path}")
    total = 0
    for d in dirs:
        n = pack_patch_dir(d, num_threads=a.num_threads)
        total += n
        print(f"{os.path.basename(d)}: packed {n} patches")
    print(f"packed {total} patches across {len(dirs)} slides")


if __name__ == "__main__":
    main()
