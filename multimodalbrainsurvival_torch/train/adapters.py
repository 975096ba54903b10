"""Model adapter between host batches and the MIL model (eval path).

Counterpart of ``multimodalbrainsurvival_tpu/train/adapters.py:104-192``
(``MILAdapter``): it knows which batch keys are device tensors, moves them
to the model's device, runs the preprocessing on the device
(``ops/image.py``) and applies the model. Train mode comes with the
training slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
from torch import nn

from multimodalbrainsurvival_torch.ops.image import preprocess_patches


@dataclass
class MILAdapter:
    """Patch-bag models (``AggregationModel`` / ``AggregationProjectModel``)."""

    model: nn.Module
    device: torch.device
    loader_kwargs: dict = field(default_factory=dict)

    sample_mask_key = "sample_mask"
    array_keys = ("patch_bag", "bag_mask", "sample_mask")
    id_keys = ("WSI", "case")

    def to_device(self, batch: dict, keys: tuple) -> dict:
        return {
            k: torch.from_numpy(np.asarray(batch[k])).to(self.device)
            for k in keys
        }

    def inputs(self, arrays: dict) -> torch.Tensor:
        """uint8 (B, bag, H, W, 3) → normalized (B, bag, 3, H, W)."""
        bags = arrays["patch_bag"]
        B, bag = bags.shape[:2]
        x = preprocess_patches(bags.reshape((B * bag,) + bags.shape[2:]),
                               dtype=self.model.resnet.dtype)
        return x.reshape((B, bag) + x.shape[1:])

    @torch.inference_mode()
    def apply(self, arrays: dict) -> torch.Tensor:
        """Eval forward: (B, num_classes) float32 outputs."""
        out, _ = self.model(self.inputs(arrays), arrays["bag_mask"])
        return out.float()

    @torch.inference_mode()
    def extract(self, arrays: dict) -> torch.Tensor:
        """(B, D) float32 bag embeddings."""
        feats, _ = self.model.extract(self.inputs(arrays), arrays["bag_mask"])
        return feats.float()
