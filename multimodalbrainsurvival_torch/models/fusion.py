"""Fusion models: early (an MLP over concatenated features) and joint (the
patch bag and the RNA vector, trained end to end).

Counterpart of ``multimodalbrainsurvival_tpu/models/fusion.py``, with the
reference's module names so that a reference ``.pt`` loads as it is:

- ``EarlyFusionMLP`` (JAX ``:27``) is the reference's bare ``Sequential(
  Dropout, Linear(4096, 2048), ReLU, Dropout, Linear(2048, 200), ReLU,
  Dropout, Linear(200, 1))`` (``3_EarlyFusion/2_EarlyFusion_train.py:
  242-251``): keys ``1.*``, ``4.*``, ``7.*``. float32.
- ``BagHistopathologyRNAModel`` (JAX ``:45``; reference ``5_JointFusion/
  models.py:87-104``): the ResNet's bag features mean-pooled over the real
  patches (``masked_bag_mean``) beside the RNA encoder's embedding, 4,096
  wide, then ``final_mlp = Sequential(Dropout(0.8), Linear(4096, 1))``:
  keys ``resnet.*``, ``rna_mlp.{1,4}.*``, ``final_mlp.1.*``. The ResNet
  computes in its ``dtype`` (bf16 autocast), the RNA encoder in its own
  (the config's ``compute_dtype``), the head in float32.
- ``PatchHistopathologyRNAModel`` (JAX ``:121``): one patch and its case's
  RNA vector per sample; in the library only (no CLI uses it).

In train mode every Dropout → Linear pair (the early-fusion MLP's three,
the RNA encoder's two and the joint head) runs as one ``DropoutMatmul``
(K2a forward, K2b in the backward), with seeds ``base + i`` from one base
seed per call. The early-fusion MLP draws it from the caller's
``generator`` (``models/rna.py::draw_seed``), as ``RNAOnlyModel`` does;
the joint models take it as ``seed`` (the joint adapter draws it before
the step queues any work) and give the RNA encoder ``base`` and ``base +
1`` and the head ``base + 2``. In eval mode each Linear is ``F.linear``.
Under data parallelism each mask is taken at the rank's first row of the
global batch, and a joint model's RNA encoder sharded by
``parallel/sharding.py`` runs tensor-parallel (``dropout_linears``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from multimodalbrainsurvival_torch.models.mil import bag_patch_features, masked_bag_mean
from multimodalbrainsurvival_torch.models.rna import RNAEncoder, draw_seed, dropout_linears
from multimodalbrainsurvival_torch.parallel import mesh as parallel

#: the RNA encoder's layers take seeds base and base + 1, the head base + 2
_HEAD_SEED = 2


class EarlyFusionMLP(nn.Sequential):
    """``Dropout → Linear → ReLU → Dropout → Linear → ReLU → Dropout →
    Linear`` (float32) over the (B, 4096) concatenated features."""

    def __init__(self, in_features: int = 4096, hidden_dims: Sequence[int] = (2048, 200),
                 out_features: int = 1, dropout: float = 0.5):
        layers: list[nn.Module] = []
        dims = [in_features, *hidden_dims]
        for d_in, d_out in zip(dims[:-1], dims[1:]):
            layers += [nn.Dropout(dropout), nn.Linear(d_in, d_out), nn.ReLU()]
        layers += [nn.Dropout(dropout), nn.Linear(dims[-1], out_features)]
        super().__init__(*layers)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None
                ) -> torch.Tensor:
        base = draw_seed(generator) if self.training else None
        return dropout_linears(self, x.float(), self.training, base)


class _JointHead(nn.Module):
    """The joint models' RNA encoder and head. In train mode every method
    that reaches a dropout takes the call's base ``seed``."""

    def __init__(self, resnet: nn.Module, rna_encoder: RNAEncoder, head_dropout: float,
                 out_features: int):
        super().__init__()
        self.resnet = resnet
        self.rna_mlp = rna_encoder
        self.final_mlp = nn.Sequential(
            nn.Dropout(head_dropout),
            nn.Linear(resnet.feature_dim + rna_encoder.out_features, out_features))

    def head(self, fused: torch.Tensor, seed: int | None) -> torch.Tensor:
        """(B, 4096) fused embedding → (B, out) through Dropout → Linear."""
        return dropout_linears(self.final_mlp, fused, self.training,
                               seed + _HEAD_SEED if self.training else None)


class BagHistopathologyRNAModel(_JointHead):
    """Joint fusion: a patch bag and the case's RNA vector → Cox score,
    trainable end to end. Patches come in as ``(B, bag, C, H, W)`` with a
    ``(B, bag)`` mask of real patches."""

    def __init__(self, resnet: nn.Module, rna_encoder: RNAEncoder,
                 head_dropout: float = 0.8, out_features: int = 1):
        super().__init__(resnet, rna_encoder, head_dropout, out_features)

    def patch_features(self, x: torch.Tensor) -> torch.Tensor:
        """(B, bag, C, H, W) → (B, bag, D) float32 per-patch embeddings (a
        folded Bottleneck ResNet through the fused stages, K4)."""
        return bag_patch_features(self.resnet, x)

    def extract_from_all_feats(self, feats: torch.Tensor, rna_feats: torch.Tensor,
                               mask: torch.Tensor | None = None) -> torch.Tensor:
        """Both encoders run elsewhere (the int8 serving path): pool the
        (B, bag, D) features over the real patches and put the (B, 2048)
        RNA embedding beside them → (B, 4096). A bag-sharded batch's
        features and mask are gathered over ``mp`` first."""
        feats, mask = parallel.gather_bag(feats, mask)
        return torch.cat([masked_bag_mean(feats, mask), rna_feats.float()], dim=1)

    def from_all_feats(self, feats, rna_feats, mask=None, seed=None):
        return self.head(self.extract_from_all_feats(feats, rna_feats, mask), seed)

    def extract_from_feats(self, feats, rna, mask=None, seed=None):
        """(B, bag, D) per-patch features and the (B, genes) RNA vector →
        the (B, 4096) bimodal embedding."""
        return self.extract_from_all_feats(feats, self.rna_mlp(rna, seed=seed), mask)

    def from_feats(self, feats, rna, mask=None, seed=None):
        return self.head(self.extract_from_feats(feats, rna, mask, seed), seed)

    def _tail_feats(self, fmap: torch.Tensor, batch: int, from_stage: int) -> torch.Tensor:
        feats = self.resnet.extract_tail(fmap, from_stage)
        return feats.reshape(batch, -1, feats.shape[-1])

    def extract_from_trunk(self, fmap, rna, mask=None, seed=None, from_stage: int = 3):
        """``extract`` continued from the (B·bag, c, h, w) feature map after
        ``from_stage`` residual stages (the int8 frozen trunk's output)."""
        return self.extract_from_feats(self._tail_feats(fmap, rna.shape[0], from_stage),
                                       rna, mask, seed)

    def from_trunk(self, fmap, rna, mask=None, seed=None, from_stage: int = 3):
        return self.from_feats(self._tail_feats(fmap, rna.shape[0], from_stage), rna,
                               mask, seed)

    def extract(self, x, rna, mask=None):
        """(B, bag, C, H, W) and (B, genes) → (B, 4096) (eval mode)."""
        return self.extract_from_feats(self.patch_features(x), rna, mask)

    def forward(self, x, rna, mask=None, seed=None):
        return self.from_feats(self.patch_features(x), rna, mask, seed)


class PatchHistopathologyRNAModel(_JointHead):
    """Per-patch joint fusion: one (B, C, H, W) patch and its case's RNA
    vector → score."""

    def __init__(self, resnet: nn.Module, rna_encoder: RNAEncoder,
                 head_dropout: float = 0.8, out_features: int = 1):
        super().__init__(resnet, rna_encoder, head_dropout, out_features)

    def forward(self, patch, rna, seed=None):
        fused = torch.cat([self.resnet.extract(patch), self.rna_mlp(rna, seed=seed)], dim=1)
        return self.head(fused, seed)
