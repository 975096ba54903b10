"""Model adapters between host batches and the MIL model (eval path).

Counterpart of ``multimodalbrainsurvival_tpu/train/adapters.py:104-251``
(``MILAdapter``, ``QuantizedMILAdapter``): they know which batch keys are
device tensors, move them to the model's device, run the preprocessing on
the device (``ops/image.py``) and apply the model. Train mode comes with the
training slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
from torch import nn

from multimodalbrainsurvival_torch.models.quantize import quantized_extract
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

    @property
    def input_dtype(self) -> torch.dtype:
        return self.model.resnet.dtype

    def inputs(self, arrays: dict) -> torch.Tensor:
        """uint8 (B, bag, H, W, 3) → normalized (B, bag, 3, H, W)."""
        bags = arrays["patch_bag"]
        B, bag = bags.shape[:2]
        x = preprocess_patches(bags.reshape((B * bag,) + bags.shape[2:]),
                               dtype=self.input_dtype)
        return x.reshape((B, bag) + x.shape[1:])

    def patch_features(self, arrays: dict) -> torch.Tensor:
        """(B, bag, D) float32 per-patch embeddings."""
        return self.model.patch_features(self.inputs(arrays))

    @torch.inference_mode()
    def apply(self, arrays: dict) -> torch.Tensor:
        """Eval forward: (B, num_classes) float32 outputs."""
        out, _ = self.model.from_feats(self.patch_features(arrays),
                                       arrays["bag_mask"])
        return out.float()

    @torch.inference_mode()
    def extract(self, arrays: dict) -> torch.Tensor:
        """(B, D) float32 bag embeddings."""
        feats, _ = self.model.extract_from_feats(self.patch_features(arrays),
                                                 arrays["bag_mask"])
        return feats.float()


@dataclass(kw_only=True)
class QuantizedMILAdapter(MILAdapter):
    """int8 (W8A8) serving variant: the per-patch ResNet runs through
    ``models/quantize.quantized_extract`` with the int8 ``qtree``; the
    aggregator and head are the float model's, in its compute dtype.
    Eval only. Preprocessing is float32, as in calibration."""

    qtree: dict
    arch: str = "resnet50"

    @property
    def input_dtype(self) -> torch.dtype:
        return torch.float32

    def patch_features(self, arrays: dict) -> torch.Tensor:
        x = self.inputs(arrays)
        B, bag = x.shape[:2]
        feats = quantized_extract(self.qtree, x.reshape((B * bag,) + x.shape[2:]),
                                  arch=self.arch)
        return feats.reshape(B, bag, -1)

    def apply(self, arrays: dict, *, train: bool = False) -> torch.Tensor:
        if train:
            raise ValueError("the int8 serving adapter is eval-only")
        return super().apply(arrays)
