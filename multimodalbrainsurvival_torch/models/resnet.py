"""ResNet-18/34/50/101/152 patch encoders, written by hand.

Counterpart of ``multimodalbrainsurvival_tpu/models/resnet.py:50-419``
(reference ``1_HistoPathology/resnet.py``). Parameter names are
torchvision's (``conv1``, ``bn1``, ``layer1.0.conv1``,
``layer1.0.downsample.0/1``, ``fc``), so a reference or torchvision
``state_dict`` loads unchanged.

Paddings are those of the JAX model: the stem 7×7/2 pads 3, every 3×3 pads
1 (the stride sits on the 3×3, torchvision v1.5), the 3×3/2 max-pool pads 1,
and the 1×1 stride-2 downsample pads nothing (flax's ``SAME`` for a 1×1
kernel is zero padding at every size, even or odd).

BatchNorm is torch's own (eps 1e-5, momentum 0.1): batch statistics in
train mode, running statistics in eval mode, as the JAX package's
``TorchBatchNorm`` (``models/resnet.py:50-115``); under data or bag
parallelism its train-mode statistics span the global batch
(``SyncedBatchNorm2d``). Two training keys of the JAX package:

- ``freeze_bn``: every BatchNorm normalizes with its running statistics in
  train mode too, and never updates them (``FrozenStatsBatchNorm2d``; the
  affine still trains), the JAX ``freeze_bn`` (``:119-143``);
- ``remat``: per-block activation checkpointing (``torch.utils.checkpoint``)
  in the stages it names, ``True`` for all or a list of 1-based stage
  numbers (JAX ``:292-350``). The recomputation in the backward uses the
  batch statistics again, and the running ones are put back after it, so
  they are updated once.
  An integer raises: the JAX package reads any truthy int as "all stages",
  a defect the port does not copy.

With ``fold_bn`` every BatchNorm is folded into the preceding convolution's
weight and bias (``models/folding.py``) and the norms are identities; the
MIL models serve a folded Bottleneck encoder through ``models/serving.py``
(the fused-stage kernel for layer1 and layer2), not through ``extract``.
``extract_tail`` continues ``extract`` from the feature map after a number
of stages: the seam of the int8 frozen trunk (``models/quantize.py``).
``ResNetProject`` puts a tanh projection on the embedding.

``dtype=torch.bfloat16`` runs the encoder under autocast: convolutions in
bfloat16, BatchNorm statistics and arithmetic in float32, as the JAX model's
``dtype`` field does. ``extract`` always returns float32.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from multimodalbrainsurvival_torch.parallel import mesh as parallel

BN_EPS = 1e-5


class FrozenStatsBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm that normalizes with its running statistics in train mode
    too and never updates them (``freeze_bn``); weight and bias still
    train. Its ``state_dict`` is ``BatchNorm2d``'s."""

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                            self.bias, False, 0.0, self.eps)


class SyncedBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (its ``state_dict`` too) whose train-mode
    statistics span the ranks that hold distinct patches under a data- or
    bag-parallel placement (``parallel.bn_group()``: ``dp``, or the whole
    world with ``shard_bag``), as the JAX ``TorchBatchNorm`` takes them over
    the logically global batch. One implementation on the CPU and the card
    (``torch.nn.SyncBatchNorm`` refuses CPU tensors): per-channel sums,
    then sums of squared deviations, each all-reduced (float32, two passes);
    the biased variance normalizes and the unbiased one, with the global
    count, goes into ``running_var``. The backward all-reduces the same
    sums' gradients (``parallel.sum_partials``), and ``remat``'s
    recomputation issues the same collectives on every rank. Without a
    group, and in eval mode, it is ``nn.BatchNorm2d``.
    ``synced_forward(x, None)`` is the synced arithmetic in a world of one
    (the reference a multi-rank run is held against)."""

    def forward(self, x):
        group = parallel.bn_group() if self.training else None
        if group is None:
            return super().forward(x)
        return self.synced_forward(x, group)

    def synced_forward(self, x, group):
        """Train-mode statistics over ``group`` (this process alone at
        None), in the synced arithmetic."""
        x32 = x.float()
        n_local = x32.numel() // x32.shape[1]
        n = n_local * parallel.group_size(group)
        shape = (1, -1, 1, 1)
        mean = parallel.sum_partials(x32.sum((0, 2, 3)), group) / n
        centred = x32 - mean.view(shape)
        var = parallel.sum_partials((centred * centred).sum((0, 2, 3)), group) / n
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(mean.detach(), alpha=m)
            self.running_var.mul_(1 - m).add_(var.detach() * (n / max(n - 1, 1)), alpha=m)
            self.num_batches_tracked.add_(1)
        y = centred * torch.rsqrt(var + self.eps).view(shape)
        return (y * self.weight.view(shape) + self.bias.view(shape)).to(x.dtype)


def _norm(fold_bn: bool, channels: int, freeze_bn: bool = False) -> nn.Module:
    if fold_bn:
        return nn.Identity()
    cls = FrozenStatsBatchNorm2d if freeze_bn else SyncedBatchNorm2d
    return cls(channels, eps=BN_EPS)


def remat_stages(remat, n_stages: int) -> frozenset[int]:
    """The config's ``remat`` → the 1-based stage numbers to checkpoint:
    ``True`` / ``False`` for all / none, or a list of stage numbers."""
    if isinstance(remat, bool):
        return frozenset(range(1, n_stages + 1)) if remat else frozenset()
    if isinstance(remat, (int, float, str)):
        raise ValueError(
            f"remat must be true, false or a list of 1-based stage numbers "
            f"such as [1, 2], got {remat!r}")
    stages = frozenset(int(s) for s in remat)
    bad = sorted(s for s in stages if not 1 <= s <= n_stages)
    if bad:
        raise ValueError(f"remat stages {bad} out of range 1..{n_stages}")
    return stages


@contextlib.contextmanager
def _stats_kept(block: nn.Module):
    """A block's recomputation under ``remat``: its BatchNorms normalize with
    the batch statistics, as in the forward, and their running statistics
    (and batch count) are put back afterwards, so the batch is counted
    once."""
    saved = [(b, b.clone()) for m in block.modules()
             if isinstance(m, nn.BatchNorm2d) for b in m.buffers()]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, value in saved:
                b.copy_(value)


def _conv(cin, cout, k, stride=1, padding=0, bias=False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding, bias=bias)


class BasicBlock(nn.Module):
    """3x3 + 3x3 residual block (ResNet-18/34). Expansion 1."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 fold_bn: bool = False, freeze_bn: bool = False):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride, 1, bias=fold_bn)
        self.bn1 = _norm(fold_bn, planes, freeze_bn)
        self.conv2 = _conv(planes, planes, 3, 1, 1, bias=fold_bn)
        self.bn2 = _norm(fold_bn, planes, freeze_bn)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                _conv(inplanes, planes, 1, stride, bias=fold_bn),
                _norm(fold_bn, planes, freeze_bn),
            )

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class Bottleneck(nn.Module):
    """1x1 → 3x3 → 1x1 residual block (ResNet-50/101/152). Expansion 4."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 fold_bn: bool = False, freeze_bn: bool = False):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = _conv(inplanes, planes, 1, bias=fold_bn)
        self.bn1 = _norm(fold_bn, planes, freeze_bn)
        self.conv2 = _conv(planes, planes, 3, stride, 1, bias=fold_bn)
        self.bn2 = _norm(fold_bn, planes, freeze_bn)
        self.conv3 = _conv(planes, out, 1, bias=fold_bn)
        self.bn3 = _norm(fold_bn, out, freeze_bn)
        self.downsample = None
        if stride != 1 or inplanes != out:
            self.downsample = nn.Sequential(
                _conv(inplanes, out, 1, stride, bias=fold_bn),
                _norm(fold_bn, out, freeze_bn),
            )

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class ResNet(nn.Module):
    """NCHW (``channels_last``) ResNet with a classification head and an
    ``extract`` embedding path; ``feature_dim`` = 512 × expansion."""

    def __init__(
        self,
        stage_sizes: Sequence[int],
        block_cls: type,
        num_classes: int | None = 1000,
        in_channels: int = 3,
        num_filters: int = 64,
        dtype: torch.dtype = torch.float32,
        fold_bn: bool = False,
        freeze_bn: bool = False,
        remat=False,
    ):
        super().__init__()
        self.in_channels = in_channels
        self.dtype = dtype
        self.block_cls = block_cls
        self.fold_bn = fold_bn
        self.feature_dim = num_filters * 8 * block_cls.expansion
        self.conv1 = _conv(in_channels, num_filters, 7, 2, 3, bias=fold_bn)
        self.bn1 = _norm(fold_bn, num_filters, freeze_bn)
        inplanes = num_filters
        for i, n_blocks in enumerate(stage_sizes):
            planes = num_filters * 2**i
            blocks = []
            for j in range(n_blocks):
                stride = 2 if (i > 0 and j == 0) else 1
                blocks.append(block_cls(inplanes, planes, stride, fold_bn, freeze_bn))
                inplanes = planes * block_cls.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self.n_stages = len(stage_sizes)
        self.remat_stages = remat_stages(remat, self.n_stages)
        # the MIL models never call the classifier (``num_classes=None``),
        # like the JAX MIL model, which never materializes its params
        self.fc = (nn.Linear(self.feature_dim, num_classes)
                   if num_classes is not None else None)

    def check_input(self, x: torch.Tensor) -> None:
        if x.shape[1] != self.in_channels:
            raise ValueError(
                f"{type(self).__name__} was built for in_channels="
                f"{self.in_channels} but got input with {x.shape[1]} "
                f"channels (shape {tuple(x.shape)})"
            )

    def extract(self, x: torch.Tensor) -> torch.Tensor:
        """(N, C, H, W) → (N, feature_dim) float32 pre-FC pooled embedding
        (reference ``forward_extract``, ``resnet.py:151-165``)."""
        self.check_input(x)
        with self._autocast(x):
            y = F.relu(self.bn1(self.conv1(x)))
            y = F.max_pool2d(y, 3, 2, 1)
        return self.extract_tail(y, 0)

    def _autocast(self, x: torch.Tensor):
        return torch.autocast(x.device.type, dtype=torch.bfloat16,
                              enabled=self.dtype == torch.bfloat16)

    def extract_tail(self, y: torch.Tensor, from_stage: int = 0) -> torch.Tensor:
        """Continue ``extract`` from the (N, C, h, w) feature map after
        ``from_stage`` residual stages (0: the max-pooled stem output) →
        (N, feature_dim) float32 (JAX ``extract_tail``, ``:400-419``).
        Stages named by ``remat`` checkpoint each block when a gradient is
        being recorded."""
        remat = torch.is_grad_enabled() and bool(self.remat_stages)
        with self._autocast(y):
            for i in range(from_stage, self.n_stages):
                for block in getattr(self, f"layer{i + 1}"):
                    if remat and i + 1 in self.remat_stages:
                        y = checkpoint(
                            block, y, use_reentrant=False,
                            context_fn=lambda b=block: (contextlib.nullcontext(),
                                                        _stats_kept(b)))
                    else:
                        y = block(y)
            y = y.mean(dim=(2, 3))
        return y.float()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(self.extract(x))


class ResNetProject(nn.Module):
    """ResNet embedding → ``project`` (Linear to ``hdim``) → tanh, the JAX
    package's ``ResNetProject`` (``models/resnet.py:421-433``; reference
    ``resnet.py:317-337``). Keys: ``resnet.*`` and ``project.{weight,
    bias}``."""

    def __init__(self, resnet: ResNet, hdim: int = 200):
        super().__init__()
        self.resnet = resnet
        self.project = nn.Linear(resnet.feature_dim, hdim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.project(self.resnet.extract(x)))


def resnet18(**kw) -> ResNet:
    return ResNet((2, 2, 2, 2), BasicBlock, **kw)


def resnet34(**kw) -> ResNet:
    return ResNet((3, 4, 6, 3), BasicBlock, **kw)


def resnet50(**kw) -> ResNet:
    return ResNet((3, 4, 6, 3), Bottleneck, **kw)


def resnet101(**kw) -> ResNet:
    return ResNet((3, 4, 23, 3), Bottleneck, **kw)


def resnet152(**kw) -> ResNet:
    return ResNet((3, 8, 36, 3), Bottleneck, **kw)


def rnfour(depth: str = "resnet50", **kw) -> ResNet:
    """4-channel input variant (reference ``RNfour``, ``resnet.py:167-240``;
    JAX ``models/resnet.py:456-459``); the pretrained conv1 surgery is
    ``convert.adapt_conv1_channels``."""
    return RESNET_CONSTRUCTORS[depth](in_channels=4, **kw)


def rnone(depth: str = "resnet50", **kw) -> ResNet:
    """1-channel input variant (reference ``RNone``, ``resnet.py:242-315``;
    JAX ``models/resnet.py:462-464``)."""
    return RESNET_CONSTRUCTORS[depth](in_channels=1, **kw)


RESNET_CONSTRUCTORS = {
    "resnet18": resnet18,
    "resnet34": resnet34,
    "resnet50": resnet50,
    "resnet101": resnet101,
    "resnet152": resnet152,
}
