"""The folded ResNet's serving forward through the fused-stage kernel (K4).

Counterpart of ``fused_folded_extract`` in the JAX package's
``models/serving.py`` (retired in commit ``183b10c``). It computes what
``ResNet(fold_bn=True).extract`` computes, but every stride-1 bottleneck
chain of the stages in ``fused_stages`` goes through
``kernels/fused_stage.py::fused_bottleneck_stage``: all of layer1 (its
projection block 0 included) and layer2's blocks 1 onwards. The stem,
layer2's stride-2 block 0, the other stages and the pooling stay on the
stock folded modules (cuDNN on the card).

On the card, the convolutions left on cuDNN run as cuDNN's fused
convolution + bias + ReLU (``torch.cudnn_convolution_relu``) and, for each
block's last one, convolution + residual + bias + ReLU
(``torch.cudnn_convolution_add_relu``; a projection's bias joins the last
conv's): the stock modules add each folded bias in a separate elementwise
pass, then ReLU and the residual add in more. These are cuDNN convolutions
that the JAX package leaves to XLA. They take cuDNN's TF32 setting as the
stock convolutions do, so float32 stays full precision under
``device.configure_precision``; in bfloat16 each call rounds once where the
stock modules round after the bias and after the add. On the CPU, which has
no such calls, the stock modules run.

Only Bottleneck ResNets (50/101/152) have such chains; a BasicBlock ResNet
(18/34) keeps its stock folded blocks. ``takes_fused_stages`` is that
dispatch on the architecture: ``AggregationModel.patch_features`` sends a
folded Bottleneck encoder here, and everything else to ``extract``.

The kernel's weights are packed once per model, dtype and device, and
packed again only when a parameter is replaced or changed in place. Within
``kernels/ops.py::exporting()`` (an exported serving program) they are
packed inside the program and K4 is reached through its custom op.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from multimodalbrainsurvival_torch.kernels import ops
from multimodalbrainsurvival_torch.kernels.fused_stage import pack_bottleneck
from multimodalbrainsurvival_torch.models.resnet import Bottleneck, ResNet

#: the stages whose stride-1 chains go through K4: the 56×56 and 28×28
#: stages with the fat activations (the retired JAX default)
DEFAULT_FUSED_STAGES = ("layer1", "layer2")


def takes_fused_stages(resnet: ResNet) -> bool:
    """A folded Bottleneck ResNet serves through ``fused_folded_extract``."""
    return resnet.fold_bn and resnet.block_cls is Bottleneck


def _packed_chain(resnet: ResNet, blocks, stage: str, start: int,
                  dtype: torch.dtype) -> list:
    if ops.is_exporting():  # packed inside the program, no cache
        return [pack_bottleneck(blk, dtype) for blk in blocks[start:]]
    params = [p for blk in blocks[start:] for p in blk.parameters()]
    key = (stage, start, dtype, params[0].device)
    stamp = tuple((p.data_ptr(), p._version) for p in params)
    cache = resnet.__dict__.setdefault("_fused_stage_packs", {})
    hit = cache.get(key)
    if hit is None or hit[0] != stamp:
        hit = (stamp, [pack_bottleneck(blk, dtype) for blk in blocks[start:]])
        cache[key] = hit
    return hit[1]


def _cudnn_weights(resnet: ResNet, dtype: torch.dtype) -> dict:
    """The folded convs' weights and biases in ``dtype``, channels_last,
    cached like the packed chains: {conv module: (weight, bias)}."""
    convs = [m for m in resnet.modules() if isinstance(m, torch.nn.Conv2d)]
    if ops.is_exporting():
        return {c: (c.weight.to(dtype).contiguous(memory_format=torch.channels_last),
                    c.bias.to(dtype)) for c in convs}
    params = [p for c in convs for p in c.parameters()]
    key = ("cudnn", dtype, params[0].device)
    stamp = tuple((p.data_ptr(), p._version) for p in params)
    cache = resnet.__dict__.setdefault("_fused_stage_packs", {})
    hit = cache.get(key)
    if hit is None or hit[0] != stamp:
        weights = {c: (c.weight.detach().to(dtype).contiguous(
                           memory_format=torch.channels_last),
                       c.bias.detach().to(dtype)) for c in convs}
        hit = (stamp, weights)
        cache[key] = hit
    return hit[1]


def _conv_relu(x, conv, wb):
    return torch.cudnn_convolution_relu(x, wb[0], wb[1], conv.stride, conv.padding,
                                        conv.dilation, conv.groups)


def _cudnn_bottleneck(blk: Bottleneck, x: torch.Tensor, weights: dict) -> torch.Tensor:
    """A folded Bottleneck as three fused cuDNN calls (and the projection's
    convolution, its bias moved into the last call's)."""
    y = _conv_relu(x, blk.conv1, weights[blk.conv1])
    y = _conv_relu(y, blk.conv2, weights[blk.conv2])
    w3, b3 = weights[blk.conv3]
    if blk.downsample is None:
        r = x
    else:
        down = blk.downsample[0]
        wd, bd = weights[down]
        r = F.conv2d(x, wd, None, down.stride)
        b3 = b3 + bd
    c3 = blk.conv3
    return torch.cudnn_convolution_add_relu(y, w3, r, 1.0, b3, c3.stride, c3.padding,
                                            c3.dilation, c3.groups)


def fused_folded_extract(resnet: ResNet, x: torch.Tensor,
                         fused_stages: tuple = DEFAULT_FUSED_STAGES) -> torch.Tensor:
    """(N, C, H, W) → (N, feature_dim) float32 embedding of a ``fold_bn``
    Bottleneck ResNet, its stride-1 chains in ``fused_stages`` through K4."""
    if not takes_fused_stages(resnet):
        raise ValueError("fused_folded_extract takes a fold_bn=True Bottleneck "
                         "ResNet (50/101/152)")
    resnet.check_input(x)
    dtype = resnet.dtype
    cudnn = x.is_cuda
    weights = _cudnn_weights(resnet, dtype) if cudnn else None

    def block(blk, y):
        return _cudnn_bottleneck(blk, y, weights) if cudnn else blk(y)

    with torch.autocast(x.device.type, dtype=torch.bfloat16,
                        enabled=dtype == torch.bfloat16):
        if cudnn:
            y = _conv_relu(x.to(dtype), resnet.conv1, weights[resnet.conv1])
        else:
            y = F.relu(resnet.conv1(x))
        y = F.max_pool2d(y, 3, 2, 1)
        for i in range(resnet.n_stages):
            stage = f"layer{i + 1}"
            blocks = getattr(resnet, stage)
            if stage not in fused_stages:
                for blk in blocks:
                    y = block(blk, y)
                continue
            # layer1 is stride 1 throughout; a later stage's block 0 has
            # stride 2 and stays on cuDNN
            start = 0 if blocks[0].conv2.stride == (1, 1) else 1
            for blk in blocks[:start]:
                y = block(blk, y)
            y = ops.fused_bottleneck_stage(
                y.contiguous(memory_format=torch.channels_last),
                _packed_chain(resnet, blocks, stage, start, y.dtype))
        y = y.mean(dim=(2, 3))
    return y.float()
