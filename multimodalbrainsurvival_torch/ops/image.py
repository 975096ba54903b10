"""Batched patch preprocessing on the device: train-mode augmentation and
ImageNet normalization.

Counterpart of ``multimodalbrainsurvival_tpu/ops/image.py:45-234``: uint8
patches → ``/255`` → (train mode) per-image flips and colour jitter →
ImageNet normalization, in the model's compute dtype. The JAX package keeps
NHWC; here the result is NCHW in ``channels_last`` memory, which is NHWC in
memory and the layout cuDNN's fast convolutions take.

The train-mode chain is the JAX package's ``batched_color_jitter``, which
stands for the reference's torchvision ``RandomHorizontalFlip +
RandomVerticalFlip + ColorJitter(64/255, 0.75, 0.25, 0.04)``
(``2_HistoPath_train.py:474-481``): per image an H and a V flip at p = 0.5,
then brightness → contrast → saturation → hue in that fixed order (the
JAX package's documented deviation from torchvision's random order), each
op clamped to [0, 1]. It is split in two:

- ``jitter_draws`` draws the flips and factors of a batch, in float32, from
  a ``torch.Generator`` on the batch's device;
- ``apply_color_jitter`` applies given draws, deterministically.

Torch's random stream cannot match ``jax.random``, so the tests feed
``apply_color_jitter`` the draws the JAX function makes and compare the two
stacks exactly.
"""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# ITU-R 601 luma weights (torchvision rgb_to_grayscale)
GRAY_WEIGHTS = (0.299, 0.587, 0.114)
# the reference's ColorJitter(64/255, 0.75, 0.25, 0.04)
JITTER = {"brightness": 64.0 / 255.0, "contrast": 0.75, "saturation": 0.25,
          "hue": 0.04}


def normalize_imagenet(img: torch.Tensor) -> torch.Tensor:
    """(..., 3) channels-last float images → ImageNet-normalized."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=img.dtype, device=img.device)
    std = torch.tensor(IMAGENET_STD, dtype=img.dtype, device=img.device)
    return (img - mean) / std


def _grayscale(img: torch.Tensor) -> torch.Tensor:
    """(..., 3) → (...) luma: the weights rounded to the image's dtype, the
    sum of the three products in float32, rounded once (the JAX einsum)."""
    w = torch.tensor(GRAY_WEIGHTS, dtype=img.dtype, device=img.device)
    return (img.float() * w.float()).sum(dim=-1).to(img.dtype)


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) float RGB in [0, 1] → HSV in [0, 1]."""
    r, g, b = rgb.unbind(dim=-1)
    maxc = rgb.amax(dim=-1)
    minc = rgb.amin(dim=-1)
    delta = maxc - minc
    zero, one = torch.zeros_like(maxc), torch.ones_like(maxc)
    safe_delta = torch.where(delta == 0, one, delta)
    s = torch.where(maxc == 0, zero, delta / torch.where(maxc == 0, one, maxc))
    rc = (maxc - r) / safe_delta
    gc = (maxc - g) / safe_delta
    bc = (maxc - b) / safe_delta
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta == 0, zero, torch.remainder(h / 6.0, 1.0))
    return torch.stack([h, s, maxc], dim=-1)


def _hsv_to_rgb_arith(h, s, v) -> torch.Tensor:
    """Arithmetic HSV → RGB (no six-way gather), (...) each → (..., 3)."""

    def channel(n: float) -> torch.Tensor:
        k = torch.remainder(n + h * 6.0, 6.0)
        return v - v * s * torch.clamp(torch.minimum(k, 4.0 - k), 0.0, 1.0)

    return torch.stack([channel(5.0), channel(3.0), channel(1.0)], dim=-1)


def jitter_draws(n: int, generator: torch.Generator) -> dict[str, torch.Tensor]:
    """The random part of ``batched_color_jitter`` for ``n`` images, drawn
    from ``generator`` on its device, all (n,): ``flip_h`` and ``flip_v``
    (bool, p = 0.5) and float32 ``brightness`` ~ U[max(0, 1-b), 1+b],
    ``contrast``, ``saturation`` likewise, and ``hue`` ~ U[-h, h], with the
    amounts of ``JITTER``."""

    def uniform(lo: float, hi: float) -> torch.Tensor:
        u = torch.rand(n, generator=generator, device=generator.device,
                       dtype=torch.float32)
        return lo + (hi - lo) * u

    draws = {"flip_h": uniform(0.0, 1.0) < 0.5, "flip_v": uniform(0.0, 1.0) < 0.5}
    for name in ("brightness", "contrast", "saturation"):
        draws[name] = uniform(max(0.0, 1.0 - JITTER[name]), 1.0 + JITTER[name])
    draws["hue"] = uniform(-JITTER["hue"], JITTER["hue"])
    return draws


def apply_color_jitter(imgs: torch.Tensor, draws: dict) -> torch.Tensor:
    """The deterministic core of ``batched_color_jitter``: (N, H, W, 3)
    float images in [0, 1] → flipped and jittered, in the images' dtype,
    with ``draws`` as ``jitter_draws`` makes them (the factors are cast to
    the images' dtype, as the JAX package casts its float32 draws)."""
    shape = (-1, 1, 1, 1)
    imgs = torch.where(draws["flip_h"].view(shape), imgs.flip(2), imgs)
    imgs = torch.where(draws["flip_v"].view(shape), imgs.flip(1), imgs)

    def factor(name: str) -> torch.Tensor:
        return draws[name].to(imgs.dtype).view(shape)

    imgs = torch.clamp(imgs * factor("brightness"), 0.0, 1.0)
    f = factor("contrast")
    # the mean accumulates in float32 and is rounded once (jnp.mean)
    mean = _grayscale(imgs).float().mean(dim=(1, 2)).to(imgs.dtype).view(shape)
    imgs = torch.clamp(f * imgs + (1.0 - f) * mean, 0.0, 1.0)
    f = factor("saturation")
    gray = _grayscale(imgs)[..., None]
    imgs = torch.clamp(f * imgs + (1.0 - f) * gray, 0.0, 1.0)
    d = draws["hue"].to(imgs.dtype).view(-1, 1, 1)
    hsv = rgb_to_hsv(imgs)
    return _hsv_to_rgb_arith(torch.remainder(hsv[..., 0] + d, 1.0),
                             hsv[..., 1], hsv[..., 2])


def batched_color_jitter(imgs: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Per-image random flips and colour jitter of (N, H, W, 3) float
    images in [0, 1], drawn from ``generator`` (on the images' device)."""
    return apply_color_jitter(imgs, jitter_draws(imgs.shape[0], generator))


def preprocess_patches(
    images_uint8: torch.Tensor, *, dtype: torch.dtype = torch.float32,
    train: bool = False, generator: torch.Generator | None = None,
    draws: dict | None = None,
) -> torch.Tensor:
    """uint8 (N, H, W, 3) → normalized (N, 3, H, W) in ``channels_last``.

    The whole chain runs in ``dtype`` as in the JAX package, so a bfloat16
    model rounds its inputs where the JAX package's bfloat16 model does.
    ``train=True`` adds the per-image flips and colour jitter: ``draws``
    where given (``jitter_draws``' of the N images; a data-parallel rank's
    part of the global batch's draws), else drawn from ``generator``.
    """
    x = images_uint8.to(dtype) / torch.tensor(
        255.0, dtype=dtype, device=images_uint8.device
    )
    if train:
        if draws is not None:
            x = apply_color_jitter(x, draws)
        elif generator is None:
            raise ValueError("train=True draws its augmentation from a generator")
        else:
            x = batched_color_jitter(x, generator)
    x = normalize_imagenet(x)
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
