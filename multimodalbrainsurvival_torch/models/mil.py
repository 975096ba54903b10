"""MIL aggregation models: bag of patches → embedding → Cox head.

Counterpart of ``multimodalbrainsurvival_tpu/models/mil.py:22-136``
(reference ``1_HistoPathology/models.py:35-88``), eval path: per-patch ResNet
embedding → aggregator → bag pool → linear head. Patches come in as
``(B, bag, C, H, W)`` with a ``(B, bag)`` mask of real patches.

The port's aggregators return the pooled ``(B, D)`` embedding themselves
(``models/aggregators.py``): the gated-attention pool is one fused kernel
that never materializes the rescaled per-patch features. A folded
Bottleneck encoder (``fold_bn: true`` serving) runs through
``models/serving.py::fused_folded_extract`` and its fused-stage kernel.

Under a bag-sharded placement (``mesh: {"shard_bag": true}``,
``parallel/mesh.py``) each rank encodes its ``bag / mp`` patches; the
models all-gather the per-patch features and the mask over ``mp`` before
the aggregator (``parallel.gather_bag``, the gradient carried back to the
local patches), so the pool (K1) and ``masked_bag_mean`` run on the whole
bag: the all-gather + all-reduce pattern of the JAX package's GSPMD
lowering (``parallel/sharding.py:9-17`` there).
"""

from __future__ import annotations

import torch
from torch import nn

from multimodalbrainsurvival_torch.models.serving import (
    fused_folded_extract,
    takes_fused_stages,
)
from multimodalbrainsurvival_torch.parallel import mesh as parallel


def masked_bag_mean(x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """Mean over the bag axis counting only real patches. x: (B, bag, D)."""
    if mask is None:
        return x.mean(dim=1)
    m = mask.to(x.dtype)[..., None]
    n = torch.clamp(m.sum(dim=1), min=1.0)
    return (x * m).sum(dim=1) / n


def patch_embeddings(resnet: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) → (N, D) float32 embeddings of ``resnet``; a folded
    Bottleneck ResNet through the fused stages."""
    if takes_fused_stages(resnet):
        return fused_folded_extract(resnet, x)
    return resnet.extract(x)


def bag_patch_features(resnet: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """(B, bag, C, H, W) → (B, bag, D) float32 per-patch embeddings of
    ``resnet`` (``patch_embeddings``)."""
    B, bag = x.shape[:2]
    return patch_embeddings(resnet, x.reshape((B * bag,) + x.shape[2:])).reshape(B, bag, -1)


class AggregationModel(nn.Module):
    def __init__(self, resnet: nn.Module, aggregator: nn.Module,
                 out_features: int = 1):
        super().__init__()
        self.resnet = resnet
        self.aggregator = aggregator
        self.fc = nn.Linear(resnet.feature_dim, out_features)

    def patch_features(self, x: torch.Tensor) -> torch.Tensor:
        """(B, bag, C, H, W) → (B, bag, D) float32 per-patch embeddings."""
        return bag_patch_features(self.resnet, x)

    def extract(self, x, mask=None):
        """(B, bag, C, H, W) → ((B, D) bag embedding, (B, bag) attention)."""
        return self.extract_from_feats(self.patch_features(x), mask)

    def extract_from_feats(self, feats, mask=None, generator=None):
        """``generator``: the aggregator's dropout draws in train mode."""
        feats, mask = parallel.gather_bag(feats, mask)
        return self.aggregator(feats, mask, generator=generator)

    def from_feats(self, feats, mask=None, generator=None):
        """(B, bag, D) per-patch features → ((B, out) head, (B, bag))."""
        pooled, attention = self.extract_from_feats(feats, mask, generator)
        return self.fc(pooled), attention

    def forward(self, x, mask=None):
        return self.from_feats(self.patch_features(x), mask)


class AggregationProjectModel(AggregationModel):
    """Adds ``project → tanh`` between the bag pool and the head
    (``models.py:59-88``); dropout is the identity in eval mode."""

    def __init__(self, resnet: nn.Module, aggregator: nn.Module,
                 out_features: int = 1, hdim: int = 200):
        super().__init__(resnet, aggregator, out_features)
        self.project = nn.Linear(resnet.feature_dim, hdim)
        self.fc = nn.Linear(hdim, out_features)

    def extract_from_feats(self, feats, mask=None, generator=None):
        pooled, attention = super().extract_from_feats(feats, mask, generator)
        return torch.tanh(self.project(pooled)), attention
