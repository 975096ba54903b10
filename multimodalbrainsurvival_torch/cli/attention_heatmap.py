"""Render per-patch attention as a slide-overlay heatmap PNG.

Parity with the JAX CLI ``multimodalbrainsurvival_tpu/cli/attention_heatmap.py``:
``slide_extractfeatures`` (with ``save_patch_features``) writes
``<slide>_patches.csv`` (id, x, y, attention at level-0 coordinates), and
this tool turns it into a picture of which tissue drives the slide's score.

    python -m multimodalbrainsurvival_torch.cli.attention_heatmap \\
        --patches_csv out/patch_features/S1_patches.csv \\
        [--slide wsi/S1.svs] [--output out/S1_attention.png] \\
        [--patch_size 224] [--target 1024] [--alpha 0.6] [--device cpu]

With ``--slide`` the heatmap is blended over the slide's lowest pyramid
level, scaled to at most ``--target`` pixels a side (OpenCV's area
resampling, ``data/opencv_compat.py``); without it, over a white canvas of
the tiles' bounding box. Attention is normalized between its 1st and 99th
percentiles and mapped through viridis (OpenCV's ``COLORMAP_VIRIDIS``
table, kept here as data); the hottest tiles are drawn last. The PNG is
written by the tiler's zlib writer. The rendering runs on the host;
``--device`` follows every entry point's rule (``cuda`` by default, which
raises without a card).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from multimodalbrainsurvival_torch.data.opencv_compat import resize_area
from multimodalbrainsurvival_torch.data.tiler import open_slide, region_rgb, write_png
from multimodalbrainsurvival_torch.device import resolve_device
from multimodalbrainsurvival_torch.frames import read_frame

#: OpenCV's COLORMAP_VIRIDIS, index 0..255 → RGB
VIRIDIS = np.frombuffer(bytes.fromhex(
    "44015444025645045745055946075a46085c460a5d460b5e470d60470e61471063471164"
    "47136548146748166848176948186a481a6c481b6d481c6e481d6f481f70482071482173"
    "482374482475482576482677482878482979472a7a472c7a472d7b472e7c472f7d46307e"
    "46327e46337f463480453581453781453882443983443a83443b84433d84433e85423f85"
    "4240864241864142874144874045884046883f47883f48893e49893e4a893e4c8a3d4d8a"
    "3d4e8a3c4f8a3c508b3b518b3b528b3a538b3a548c39558c39568c38588c38598c375a8c"
    "375b8d365c8d365d8d355e8d355f8d34608d34618d33628d33638d32648e32658e31668e"
    "31678e31688e30698e306a8e2f6b8e2f6c8e2e6d8e2e6e8e2e6f8e2d708e2d718e2c718e"
    "2c728e2c738e2b748e2b758e2a768e2a778e2a788e29798e297a8e297b8e287c8e287d8e"
    "277e8e277f8e27808e26818e26828e26828e25838e25848e25858e24868e24878e23888e"
    "23898e238a8d228b8d228c8d228d8d218e8d218f8d21908d21918c20928c20928c20938c"
    "1f948c1f958b1f968b1f978b1f988b1f998a1f9a8a1e9b8a1e9c891e9d891f9e891f9f88"
    "1fa0881fa1881fa1871fa28720a38620a48621a58521a68522a78522a88423a98324aa83"
    "25ab8225ac8226ad8127ad8128ae8029af7f2ab07f2cb17e2db27d2eb37c2fb47c31b57b"
    "32b67a34b67935b77937b87838b9773aba763bbb753dbc743fbc7340bd7242be7144bf70"
    "46c06f48c16e4ac16d4cc26c4ec36b50c46a52c56954c56856c66758c7655ac8645cc863"
    "5ec96260ca6063cb5f65cb5e67cc5c69cd5b6ccd5a6ece5870cf5773d05675d05477d153"
    "7ad1517cd2507fd34e81d34d84d44b86d54989d5488bd6468ed64590d74393d74195d840"
    "98d83e9bd93c9dd93ba0da39a2da37a5db36a8db34aadc32addc30b0dd2fb2dd2db5de2b"
    "b8de29bade28bddf26c0df25c2df23c5e021c8e020cae11fcde11dd0e11cd2e21bd5e21a"
    "d8e219dae319dde318dfe318e2e418e5e419e7e419eae51aece51befe51cf1e51df4e61e"
    "f6e620f8e621fbe723fde725"
), np.uint8).reshape(256, 3)


def infer_patch_size(xs: np.ndarray, ys: np.ndarray) -> int:
    """The tiles' level-0 footprint: the smallest positive step of the
    coordinate grid along either axis (224 for a single tile)."""
    steps = []
    for v in (np.unique(xs), np.unique(ys)):
        if len(v) > 1:
            steps.append(int(np.diff(v).min()))
    return min(steps) if steps else 224


def render_heatmap(frame: dict, patch_size: int | None = None,
                   thumb: np.ndarray | None = None,
                   slide_dims: tuple[int, int] | None = None,
                   target: int = 1024, alpha: float = 0.6) -> np.ndarray:
    """``{x, y, attention}`` columns → an RGB uint8 heatmap. ``thumb``: an
    RGB background of the slide; ``slide_dims``: the level-0 (width,
    height) the coordinates live in (needed with ``thumb``)."""
    xs = np.asarray(frame["x"], np.int64)
    ys = np.asarray(frame["y"], np.int64)
    att = np.asarray(frame["attention"], np.float64)
    if patch_size is None:
        patch_size = infer_patch_size(xs, ys)
    lo, hi = np.percentile(att, [1.0, 99.0])
    norm = np.clip((att - lo) / max(hi - lo, 1e-12), 0.0, 1.0)
    if thumb is not None:
        if slide_dims is None:
            raise ValueError("slide_dims is required with a thumbnail")
        w0, h0 = slide_dims
        th, tw = thumb.shape[:2]
        scale = min(target / max(tw, th), 1.0)
        canvas = resize_area(thumb, (max(int(tw * scale), 1), max(int(th * scale), 1)))
        fx, fy = canvas.shape[1] / w0, canvas.shape[0] / h0
    else:
        w0 = int(xs.max()) + patch_size
        h0 = int(ys.max()) + patch_size
        f = target / max(w0, h0)
        canvas = np.full((max(int(h0 * f), 1), max(int(w0 * f), 1), 3), 255, np.uint8)
        fx = fy = f
    out = canvas.astype(np.float32)
    for i in np.argsort(norm):  # the hottest last, never covered
        x0 = int(round(xs[i] * fx))
        y0 = int(round(ys[i] * fy))
        x1 = max(int(round((xs[i] + patch_size) * fx)), x0 + 1)
        y1 = max(int(round((ys[i] + patch_size) * fy)), y0 + 1)
        color = VIRIDIS[int(round(norm[i] * 255))].astype(np.float32)
        out[y0:y1, x0:x1] = (1 - alpha) * out[y0:y1, x0:x1] + alpha * color
    return out.astype(np.uint8)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--patches_csv", required=True, nargs="+",
                   help="<slide>_patches.csv file(s) from slide_extractfeatures")
    p.add_argument("--slide", default=None, nargs="*",
                   help="the matching slide file(s), for the background")
    p.add_argument("--output", default=None, help="output PNG (one input) or directory")
    p.add_argument("--patch_size", type=int, default=None,
                   help="level-0 tile footprint; inferred from the grid when omitted")
    p.add_argument("--target", type=int, default=1024, help="largest output side in pixels")
    p.add_argument("--alpha", type=float, default=0.6)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    a = p.parse_args(argv)
    resolve_device(a.device)

    slides = a.slide or []
    if slides and len(slides) != len(a.patches_csv):
        raise SystemExit("--slide count must match --patches_csv")
    outdir = None
    if a.output and (len(a.patches_csv) > 1 or os.path.isdir(a.output)):
        outdir = a.output
        os.makedirs(outdir, exist_ok=True)
    for i, csv_path in enumerate(a.patches_csv):
        frame = read_frame(csv_path)
        thumb = dims = None
        if slides:
            slide = open_slide(slides[i])
            lowest = len(slide.level_dimensions) - 1
            thumb = region_rgb(slide, (0, 0), lowest, slide.level_dimensions[lowest])
            dims = slide.level_dimensions[0]
        img = render_heatmap(frame, patch_size=a.patch_size, thumb=thumb, slide_dims=dims,
                             target=a.target, alpha=a.alpha)
        stem = os.path.basename(csv_path).replace("_patches.csv", "")
        if outdir:
            out = os.path.join(outdir, f"{stem}_attention.png")
        else:
            out = a.output or os.path.join(os.path.dirname(csv_path) or ".",
                                           f"{stem}_attention.png")
        write_png(out, img)
        print(f"{out}: {img.shape[1]}x{img.shape[0]} ({len(frame['x'])} patches)")


if __name__ == "__main__":
    main()
