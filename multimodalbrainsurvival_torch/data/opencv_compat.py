"""The OpenCV calls of the JAX tiler and heatmap, reproduced on numpy.

The machine with the card has no OpenCV, so the port computes what the JAX
package asks of ``cv2`` itself, to the same integer pixels:

- ``rgb_to_gray``: ``cv2.cvtColor(img, COLOR_RGB2GRAY)`` on uint8, OpenCV's
  fixed-point weights (15 fraction bits, rounded);
- ``resize_linear``: ``cv2.resize(img, (w, h), interpolation=INTER_LINEAR)``
  on uint8. An exact 2x downscale (the tiler's AppMag-40 case at
  ``dezoom_factor`` 1) is the mean of each 2x2 block, rounded half up, as
  OpenCV computes it (it takes its area path there); any other size runs
  OpenCV's vectorised fixed-point code (11-bit horizontal coefficients,
  the vertical sum as two 16-bit high products, rounded by 2 bits). Equal
  on the downscales tested; an upscale (which the tiler never asks for)
  can differ by one level where OpenCV finishes a row in scalar code;
- ``resize_area``: ``cv2.resize(..., interpolation=INTER_AREA)`` for a
  downscale on uint8: integer factors as OpenCV's fast path (the block sum
  times a float32 reciprocal, rounded), other factors as its float32
  area-weight tables, summed in its order and rounded half to even.

``tests/test_torch_tiler.py`` holds each against ``cv2`` where the test
machine has it.
"""

from __future__ import annotations

import math

import numpy as np

#: COLOR_RGB2GRAY on 8-bit: R, G, B weights with 15 fraction bits
GRAY_SHIFT = 15
GRAY_WEIGHTS = (9798, 19235, 3735)
#: INTER_LINEAR on 8-bit: coefficients with 11 fraction bits
RESIZE_COEF_BITS = 11


def rgb_to_gray(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 RGB → (H, W) uint8 grey."""
    x = img.astype(np.int32)
    r, g, b = GRAY_WEIGHTS
    y = x[..., 0] * r + x[..., 1] * g + x[..., 2] * b + (1 << (GRAY_SHIFT - 1))
    return (y >> GRAY_SHIFT).astype(np.uint8)


def _block_mean_2x(img: np.ndarray, h: int, w: int) -> np.ndarray:
    x = img[: 2 * h, : 2 * w].astype(np.int32)
    s = x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]
    return ((s + 2) >> 2).astype(np.uint8)


def _linear_taps(src: int, dst: int) -> tuple[np.ndarray, np.ndarray]:
    """OpenCV's per-output (first source index, [w0, w1] int16 weights)."""
    scale = src / dst
    idx = np.zeros(dst, np.int64)
    wts = np.zeros((dst, 2), np.int64)
    one = 1 << RESIZE_COEF_BITS
    for d in range(dst):
        f = (d + 0.5) * scale - 0.5
        s = math.floor(f)
        f -= s
        if s < 0:
            s, f = 0, 0.0
        if s >= src - 1:
            s, f = src - 1, 0.0
        w1 = int(round(f * one))  # saturate_cast<short>(f * 2048)
        idx[d] = s
        wts[d] = (one - w1, w1)
    return idx, wts


def resize_linear(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """(H, W, C) uint8 → (h, w, C) uint8 for ``size = (w, h)``, as
    ``cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)``."""
    w, h = size
    H, W = img.shape[:2]
    if (H, W) == (h, w):
        return img.copy()
    if H == 2 * h and W == 2 * w:
        return _block_mean_2x(img, h, w)
    xi, xw = _linear_taps(W, w)
    yi, yw = _linear_taps(H, h)
    x = img.astype(np.int64)
    x1 = np.minimum(xi + 1, W - 1)
    rows = x[:, xi] * xw[:, 0, None] + x[:, x1] * xw[:, 1, None]  # (H, w, C)
    y1 = np.minimum(yi + 1, H - 1)
    # OpenCV's VResizeLinearVec_32s8u: mulhi(row >> 4, beta) per row
    top = ((rows[yi] >> 4) * yw[:, 0, None, None]) >> 16
    bottom = ((rows[y1] >> 4) * yw[:, 1, None, None]) >> 16
    return np.clip((top + bottom + 2) >> 2, 0, 255).astype(np.uint8)


def _area_table(src: int, dst: int) -> list[list[tuple[int, np.float32]]]:
    """OpenCV's ``computeResizeAreaTab``: per output index, the (source
    index, float32 weight) pairs in order."""
    scale = src / dst
    tab = []
    for d in range(dst):
        fs1 = d * scale
        fs2 = fs1 + scale
        cell = min(scale, src - fs1)
        s1, s2 = math.ceil(fs1), math.floor(fs2)
        s2 = min(s2, src - 1)
        s1 = min(s1, s2)
        taps = []
        if s1 - fs1 > 1e-3:
            taps.append((s1 - 1, np.float32((s1 - fs1) / cell)))
        for s in range(s1, s2):
            taps.append((s, np.float32(1.0 / cell)))
        if fs2 - s2 > 1e-3:
            taps.append((s2, np.float32(min(min(fs2 - s2, 1.0), cell) / cell)))
        tab.append(taps)
    return tab


def resize_area(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """(H, W, C) uint8 → (h, w, C) uint8 for a downscale ``size = (w,
    h)``, as ``cv2.resize(img, size, interpolation=cv2.INTER_AREA)``."""
    w, h = size
    H, W = img.shape[:2]
    if (H, W) == (h, w):
        return img.copy()
    if w > W or h > H:
        raise ValueError("resize_area downscales only")
    sx, sy = W / w, H / h
    if sx == int(sx) and sy == int(sy):
        fx, fy = int(sx), int(sy)
        if fx == 2 and fy == 2:
            return _block_mean_2x(img, h, w)
        blocks = img[: h * fy, : w * fx].astype(np.int64)
        s = blocks.reshape(h, fy, w, fx, -1).sum(axis=(1, 3))
        v = s.astype(np.float32) * np.float32(1.0 / (fx * fy))
        return np.clip(np.rint(v), 0, 255).astype(np.uint8)
    xt, yt = _area_table(W, w), _area_table(H, h)
    src = img.astype(np.float32)
    buf = np.zeros((H, w, img.shape[2]), np.float32)
    for d, taps in enumerate(xt):
        acc = np.zeros((H, img.shape[2]), np.float32)
        for s, a in taps:
            acc += src[:, s] * a
        buf[:, d] = acc
    out = np.zeros((h, w, img.shape[2]), np.float32)
    for d, taps in enumerate(yt):
        acc = np.zeros((w, img.shape[2]), np.float32)
        for s, b in taps:
            acc += b * buf[s]
        out[d] = acc
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)
