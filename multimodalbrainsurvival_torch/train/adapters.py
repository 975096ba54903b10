"""Model adapters between host batches and the models.

Counterpart of ``multimodalbrainsurvival_tpu/train/adapters.py`` (the
table, MIL and joint adapters and their int8 variants): they know which
batch keys are device tensors, move them to the model's device, run the
preprocessing on the device (``ops/image.py``) and apply the model.
``TableAdapter`` (the RNA MLP, the early-fusion MLP), ``MILAdapter`` and
``JointAdapter`` (the bag and the case's ``rna_data``) train and evaluate;
in train mode the patch adapters add the flips and colour jitter when
``augment`` is on. ``QuantTrunkMILAdapter`` and ``QuantTrunkJointAdapter``
train with the int8 frozen trunk; ``QuantizedTableAdapter``,
``QuantizedMILAdapter`` and ``QuantizedJointAdapter`` serve only.

Each adapter names the device of the generator that the train loop hands
its ``apply`` (``generator_device``): the CPU for the RNA MLP's dropout
seeds, the batch's device for the augmentation's draws. Under a data- or
bag-parallel placement (``parallel/mesh.py``) the arrays are the rank's
part of the global batch, and the augmentation is drawn for the global
batch on every rank, each rank keeping its patches' draws.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
from torch import nn

from multimodalbrainsurvival_torch.models.quantize import (
    quantized_extract,
    quantized_mlp,
    quantized_trunk,
)
from multimodalbrainsurvival_torch.models.rna import draw_seed
from multimodalbrainsurvival_torch.ops.image import jitter_draws, preprocess_patches
from multimodalbrainsurvival_torch.parallel import mesh as parallel


def to_device(batch: dict, keys: tuple, device: torch.device) -> dict:
    """The batch's arrays under ``keys`` as tensors on ``device``: numpy
    arrays are copied there, tensors already there (the device cache's) are
    taken as they are."""
    return {k: torch.as_tensor(batch[k], device=device) for k in keys}


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


@dataclass(kw_only=True)
class QuantizedTableAdapter(TableAdapter):
    """int8 (W8A8) serving variant for the RNA MLP (JAX ``:73``): the
    encoder runs through ``models/quantize.quantized_mlp`` with ``qtree``,
    the Cox head through the float model's ``from_embedding``. Eval only."""

    qtree: dict

    def apply(self, arrays: dict, *, train: bool = False,
              generator: torch.Generator | None = None) -> torch.Tensor:
        if train:
            raise ValueError("the int8 serving adapter is eval-only")
        self.model.eval()
        with torch.inference_mode():
            return self.model.from_embedding(self.extract(arrays))

    @torch.inference_mode()
    def extract(self, arrays: dict) -> torch.Tensor:
        return quantized_mlp(self.qtree, arrays[self.input_key])


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
        draws = None
        if aug:
            # drawn for every patch of the global batch on every rank, each
            # rank keeping its own: a data- or bag-parallel run augments as
            # the world-of-one run does
            draws = {k: parallel.local_patches(v, B, bag) for k, v in jitter_draws(
                parallel.global_patch_count(B, bag), generator).items()}
        x = preprocess_patches(bags.reshape((B * bag,) + bags.shape[2:]),
                               dtype=self.input_dtype, train=aug, draws=draws)
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


class _JointInputs:
    """What a joint adapter adds to its patch adapter: the batch's
    ``rna_data`` beside the bag, and the model's dropout seed drawn before
    the step queues any work (a draw from the card's generator waits for
    the card)."""

    array_keys = ("patch_bag", "bag_mask", "sample_mask", "rna_data")

    def _forward(self, arrays, train, generator) -> torch.Tensor:
        seed = draw_seed(generator) if train else None
        feats = self.patch_features(arrays, train=train, generator=generator)
        return self.model.from_feats(feats, arrays["rna_data"], arrays["bag_mask"],
                                     seed=seed).float()

    @torch.inference_mode()
    def extract(self, arrays: dict) -> torch.Tensor:
        """(B, 4096) float32 bimodal embeddings (eval mode)."""
        self.model.eval()
        return self.model.extract_from_feats(self.patch_features(arrays),
                                             arrays["rna_data"],
                                             arrays["bag_mask"]).float()


@dataclass
class JointAdapter(_JointInputs, MILAdapter):
    """Bimodal patch-bag + RNA models (``BagHistopathologyRNAModel``, JAX
    ``:355``)."""


@dataclass(kw_only=True)
class QuantTrunkJointAdapter(_JointInputs, QuantTrunkMILAdapter):
    """int8 frozen-trunk training of the joint model (JAX ``:365``): the
    frozen ResNet prefix through K3, the trainable stages, the RNA encoder
    and the head float; zero gradients below the seam, the float
    checkpoint layout."""


@dataclass(kw_only=True)
class QuantizedJointAdapter(_JointInputs, QuantizedMILAdapter):
    """int8 (W8A8) serving of the joint model (JAX ``:380``): the per-patch
    ResNet through K3 (``qtree``), the RNA encoder through
    ``quantized_mlp`` (``qtree_rna``), the pool and head float
    (``from_all_feats``). Eval only."""

    qtree_rna: dict

    def _all_feats(self, arrays: dict) -> tuple:
        return (self.patch_features(arrays),
                quantized_mlp(self.qtree_rna, arrays["rna_data"]), arrays["bag_mask"])

    def _forward(self, arrays, train, generator) -> torch.Tensor:
        return self.model.from_all_feats(*self._all_feats(arrays)).float()

    @torch.inference_mode()
    def extract(self, arrays: dict) -> torch.Tensor:
        self.model.eval()
        return self.model.extract_from_all_feats(*self._all_feats(arrays)).float()
