"""Batched patch preprocessing on the device (eval path).

Counterpart of ``multimodalbrainsurvival_tpu/ops/image.py:129-133,199-234``:
uint8 patches → ``/255`` → ImageNet normalization, in the model's compute
dtype. The JAX package keeps NHWC; here the result is NCHW in
``channels_last`` memory, which is NHWC in memory and the layout cuDNN's
fast convolutions take.

The train-mode flips and colour jitter come with the training slice.
"""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_imagenet(img: torch.Tensor) -> torch.Tensor:
    """(..., 3) channels-last float images → ImageNet-normalized."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=img.dtype, device=img.device)
    std = torch.tensor(IMAGENET_STD, dtype=img.dtype, device=img.device)
    return (img - mean) / std


def preprocess_patches(
    images_uint8: torch.Tensor, *, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """uint8 (N, H, W, 3) → normalized (N, 3, H, W) in ``channels_last``.

    The arithmetic runs in ``dtype`` as in the JAX package, so a bfloat16
    model rounds its inputs where the reference's bfloat16 model does.
    """
    x = images_uint8.to(dtype) / torch.tensor(
        255.0, dtype=dtype, device=images_uint8.device
    )
    x = normalize_imagenet(x)
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
