"""The folded ResNet's serving forward through the fused-stage kernel (K4).

Counterpart of ``fused_folded_extract`` in the JAX package's
``models/serving.py`` (retired in commit ``183b10c``). It computes what
``ResNet(fold_bn=True).extract`` computes, but every stride-1 bottleneck
chain of the stages in ``fused_stages`` goes through
``kernels/fused_stage.py::fused_bottleneck_stage``: all of layer1 (its
projection block 0 included) and layer2's blocks 1 onwards. The stem,
layer2's stride-2 block 0, the other stages and the pooling stay on the
stock folded modules (cuDNN on the card).

Only Bottleneck ResNets (50/101/152) have such chains; a BasicBlock ResNet
(18/34) keeps its stock folded blocks. ``takes_fused_stages`` is that
dispatch on the architecture: ``AggregationModel.patch_features`` sends a
folded Bottleneck encoder here, and everything else to ``extract``.

The kernel's weights are packed once per model, dtype and device, and
packed again only when a parameter is replaced or changed in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from multimodalbrainsurvival_torch.kernels.fused_stage import (
    fused_bottleneck_stage,
    pack_bottleneck,
)
from multimodalbrainsurvival_torch.models.resnet import Bottleneck, ResNet

#: the stages whose stride-1 chains go through K4: the 56×56 and 28×28
#: stages with the fat activations (the retired JAX default)
DEFAULT_FUSED_STAGES = ("layer1", "layer2")


def takes_fused_stages(resnet: ResNet) -> bool:
    """A folded Bottleneck ResNet serves through ``fused_folded_extract``."""
    return resnet.fold_bn and resnet.block_cls is Bottleneck


def _packed_chain(resnet: ResNet, blocks, stage: str, start: int,
                  dtype: torch.dtype) -> list:
    params = [p for blk in blocks[start:] for p in blk.parameters()]
    key = (stage, start, dtype, params[0].device)
    stamp = tuple((p.data_ptr(), p._version) for p in params)
    cache = resnet.__dict__.setdefault("_fused_stage_packs", {})
    hit = cache.get(key)
    if hit is None or hit[0] != stamp:
        hit = (stamp, [pack_bottleneck(blk, dtype) for blk in blocks[start:]])
        cache[key] = hit
    return hit[1]


def fused_folded_extract(resnet: ResNet, x: torch.Tensor,
                         fused_stages: tuple = DEFAULT_FUSED_STAGES) -> torch.Tensor:
    """(N, C, H, W) → (N, feature_dim) float32 embedding of a ``fold_bn``
    Bottleneck ResNet, its stride-1 chains in ``fused_stages`` through K4."""
    if not takes_fused_stages(resnet):
        raise ValueError("fused_folded_extract takes a fold_bn=True Bottleneck "
                         "ResNet (50/101/152)")
    resnet.check_input(x)
    dtype = resnet.dtype
    with torch.autocast(x.device.type, dtype=torch.bfloat16,
                        enabled=dtype == torch.bfloat16):
        y = F.relu(resnet.conv1(x))
        y = F.max_pool2d(y, 3, 2, 1)
        for i in range(resnet.n_stages):
            stage = f"layer{i + 1}"
            blocks = getattr(resnet, stage)
            if stage not in fused_stages:
                y = blocks(y)
                continue
            # layer1 is stride 1 throughout; a later stage's block 0 has
            # stride 2 and stays on the stock module
            start = 0 if blocks[0].conv2.stride == (1, 1) else 1
            for blk in blocks[:start]:
                y = blk(y)
            y = fused_bottleneck_stage(
                y.contiguous(memory_format=torch.channels_last),
                _packed_chain(resnet, blocks, stage, start, y.dtype))
        y = y.mean(dim=(2, 3))
    return y.float()
