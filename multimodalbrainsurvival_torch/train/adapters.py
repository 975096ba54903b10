"""Model adapters between host batches and the models.

Counterpart of ``multimodalbrainsurvival_tpu/train/adapters.py:35-69,
104-364`` (``TableAdapter``, ``MILAdapter``, ``QuantizedMILAdapter``,
``QuantTrunkMILAdapter``): they know which batch keys are device tensors,
move them to the model's device, run the preprocessing on the device
(``ops/image.py``) and apply the model. ``TableAdapter`` (the RNA MLP) and
``MILAdapter`` train and evaluate; in train mode ``MILAdapter`` adds the
flips and colour jitter when ``augment`` is on. ``QuantTrunkMILAdapter``
trains with the int8 frozen trunk; ``QuantizedMILAdapter`` serves only.

Each adapter names the device of the generator that the train loop hands
its ``apply`` (``generator_device``): the CPU for the RNA MLP's dropout
seeds, the batch's device for the augmentation's draws.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
from torch import nn

from multimodalbrainsurvival_torch.models.quantize import (
    quantized_extract,
    quantized_trunk,
)
from multimodalbrainsurvival_torch.ops.image import preprocess_patches


def to_device(batch: dict, keys: tuple, device: torch.device) -> dict:
    """The batch's numpy arrays under ``keys`` as tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(batch[k])).to(device) for k in keys}


@dataclass
class TableAdapter:
    """Feature-vector models (the RNA MLP): ``data`` (B, D) float32 in,
    ``mask`` (B,) marks the real rows of a padded batch."""

    model: nn.Module
    device: torch.device
    loader_kwargs: dict = field(default_factory=dict)

    input_key = "data"
    sample_mask_key = "mask"
    array_keys = ("data", "mask")
    id_keys = ("case",)

    def to_device(self, batch: dict, keys: tuple) -> dict:
        return to_device(batch, keys, self.device)

    @property
    def generator_device(self) -> torch.device:
        return torch.device("cpu")

    def apply(self, arrays: dict, *, train: bool = False,
              generator: torch.Generator | None = None) -> torch.Tensor:
        """(B, num_classes) float32 outputs; train mode draws its dropout
        seeds from ``generator`` and keeps the graph for the backward."""
        self.model.train(train)
        if train:
            return self.model(arrays[self.input_key], generator)
        with torch.inference_mode():
            return self.model(arrays[self.input_key])

    @torch.inference_mode()
    def extract(self, arrays: dict) -> torch.Tensor:
        """(B, D) float32 embeddings (eval mode)."""
        self.model.eval()
        return self.model.extract(arrays[self.input_key])


@dataclass
class MILAdapter:
    """Patch-bag models (``AggregationModel`` / ``AggregationProjectModel``).
    ``augment`` (default on, the reference's train transforms) adds the
    flips and colour jitter in train mode."""

    model: nn.Module
    device: torch.device
    loader_kwargs: dict = field(default_factory=dict)
    augment: bool = True

    sample_mask_key = "sample_mask"
    array_keys = ("patch_bag", "bag_mask", "sample_mask")
    id_keys = ("WSI", "case")

    def to_device(self, batch: dict, keys: tuple) -> dict:
        return to_device(batch, keys, self.device)

    @property
    def generator_device(self) -> torch.device:
        return torch.device(self.device)

    @property
    def input_dtype(self) -> torch.dtype:
        return self.model.resnet.dtype

    def inputs(self, arrays: dict, *, train: bool = False,
               generator: torch.Generator | None = None) -> torch.Tensor:
        """uint8 (B, bag, H, W, 3) → normalized (B, bag, 3, H, W); in train
        mode with ``augment`` also flipped and jittered, drawn from
        ``generator``."""
        bags = arrays["patch_bag"]
        B, bag = bags.shape[:2]
        aug = train and self.augment
        x = preprocess_patches(bags.reshape((B * bag,) + bags.shape[2:]),
                               dtype=self.input_dtype, train=aug,
                               generator=generator if aug else None)
        return x.reshape((B, bag) + x.shape[1:])

    def patch_features(self, arrays: dict, *, train: bool = False,
                       generator: torch.Generator | None = None) -> torch.Tensor:
        """(B, bag, D) float32 per-patch embeddings."""
        return self.model.patch_features(self.inputs(arrays, train=train,
                                                     generator=generator))

    def apply(self, arrays: dict, *, train: bool = False,
              generator: torch.Generator | None = None) -> torch.Tensor:
        """(B, num_classes) float32 outputs. Train mode (BatchNorm on batch
        statistics) keeps the graph for the backward and draws the
        augmentation and the aggregator's dropout from ``generator``."""
        self.model.train(train)
        if train:
            return self._forward(arrays, True, generator)
        with torch.inference_mode():
            return self._forward(arrays, False, None)

    def _forward(self, arrays, train, generator) -> torch.Tensor:
        out, _ = self.model.from_feats(
            self.patch_features(arrays, train=train, generator=generator),
            arrays["bag_mask"], generator)
        return out.float()

    @torch.inference_mode()
    def extract(self, arrays: dict) -> torch.Tensor:
        """(B, D) float32 bag embeddings (eval mode)."""
        self.model.eval()
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

    def patch_features(self, arrays: dict, *, train: bool = False,
                       generator: torch.Generator | None = None) -> torch.Tensor:
        x = self.inputs(arrays)
        B, bag = x.shape[:2]
        feats = quantized_extract(self.qtree, x.reshape((B * bag,) + x.shape[2:]),
                                  arch=self.arch)
        return feats.reshape(B, bag, -1)

    def apply(self, arrays: dict, *, train: bool = False,
              generator: torch.Generator | None = None) -> torch.Tensor:
        if train:
            raise ValueError("the int8 serving adapter is eval-only")
        return super().apply(arrays)


@dataclass(kw_only=True)
class QuantTrunkMILAdapter(MILAdapter):
    """int8 frozen-trunk training (``quantize_trunk: "int8"``, the JAX
    ``QuantTrunkMILAdapter``): the stem and the first ``trunk_stages``
    stages, frozen under the freeze ladder, run through
    ``models/quantize.quantized_trunk`` (K3 on the card) with the ``qtree``
    quantized once at train start; the trainable stages
    (``ResNet.extract_tail``), the aggregator and the head stay float, in
    train and eval mode alike. Preprocessing is float32, as in calibration.
    The frozen stages' BatchNorm statistics no longer update; the
    checkpoints keep the float model's layout."""

    qtree: dict
    trunk_stages: int
    arch: str = "resnet50"

    @property
    def input_dtype(self) -> torch.dtype:
        return torch.float32

    def patch_features(self, arrays: dict, *, train: bool = False,
                       generator: torch.Generator | None = None) -> torch.Tensor:
        x = self.inputs(arrays, train=train, generator=generator)
        B, bag = x.shape[:2]
        resnet = self.model.resnet
        fmap = quantized_trunk(self.qtree, x.reshape((B * bag,) + x.shape[2:]),
                               stages=self.trunk_stages, arch=self.arch,
                               dtype=resnet.dtype)
        return resnet.extract_tail(fmap, self.trunk_stages).reshape(B, bag, -1)
