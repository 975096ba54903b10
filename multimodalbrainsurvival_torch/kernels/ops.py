"""The port's kernels as ``torch.library`` custom ops, for exported programs.

``torch.export`` cannot trace a ``ctypes`` call, so an exported serving
program (``artifact.py``) reaches K1, K3 and K4 through these ops
(namespace ``mmbs``):

- ``attention_pool(x, weight, v, mask) -> (pooled, attention)`` (K1);
- ``qconv_requant(x, w, scale, bias, stride, padding, relu)``,
  ``qconv_residual_requant(x, w, scale, bias, r_q, s_t, s_r, s_out, stride,
  padding)`` and ``stem_requant_pool(y, bias, s)`` (K3's three entries);
- ``fused_bottleneck_block(x, w1, b1, w2, b2, w3, b3, wd, bd)`` (K4, one
  block: a ``PackedBlock`` crosses the op boundary as its tensors).

It also gives ``aten::cudnn_convolution_relu`` and
``aten::cudnn_convolution_add_relu`` (the folded encoder's fused cuDNN
calls, ``models/serving.py``) the Meta kernels they lack, so that a folded
program traces on the card.

Each op's implementation calls the dispatching wrapper (a CPU tensor goes
to the plain version; a CUDA tensor launches the kernel or raises), so the
wrappers' launch counters count every call of a loaded program. Each
``register_fake`` gives the output's shape, dtype and layout from the
inputs' sizes alone: the wrappers' alignment and range checks read concrete
sizes, which would fix a program's symbolic batch and bag, so they run in
the implementation only.

The model code takes these ops only inside ``exporting()``; eager calls go
to the wrappers directly, as before. Importing this module registers the
ops, so ``artifact.load_artifact`` and ``cli/serve.py`` import it before
``torch.export.load``. Nothing is built when it is imported.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from multimodalbrainsurvival_torch.kernels import attention_pool as _k1
from multimodalbrainsurvival_torch.kernels import fused_stage as _k4
from multimodalbrainsurvival_torch.kernels import qmm_requant as _k3

_exporting = False


@contextlib.contextmanager
def exporting():
    """Within this context the model code calls the kernels as custom ops
    (for ``torch.export``), not through their wrappers."""
    global _exporting
    prior, _exporting = _exporting, True
    try:
        yield
    finally:
        _exporting = prior


def is_exporting() -> bool:
    return _exporting


@torch.library.custom_op("mmbs::attention_pool", mutates_args=())
def attention_pool(x: torch.Tensor, weight: torch.Tensor, v: torch.Tensor,
                   mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    pooled, attn = _k1.attention_pool(x, weight, v, mask)
    return pooled, attn


@attention_pool.register_fake
def _(x, weight, v, mask):
    B, bag, D = x.shape
    return (x.new_empty((B, D), dtype=torch.float32),
            x.new_empty((B, bag), dtype=torch.float32))


def _conv_out(n: int, k: int, stride: int, padding: int):
    return (n + 2 * padding - k) // stride + 1


@torch.library.custom_op("mmbs::qconv_requant", mutates_args=())
def qconv_requant(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  stride: int, padding: int, relu: bool) -> torch.Tensor:
    return _k3.qconv_requant(x, w, scale, bias, stride=stride, padding=padding, relu=relu)


@qconv_requant.register_fake
def _(x, w, scale, bias, stride, padding, relu):
    B, H, W, _ = x.shape
    N, kh, kw, _ = w.shape
    return x.new_empty((B, _conv_out(H, kh, stride, padding),
                        _conv_out(W, kw, stride, padding), N), dtype=torch.int8)


@torch.library.custom_op("mmbs::qconv_residual_requant", mutates_args=())
def qconv_residual_requant(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                           bias: torch.Tensor, r_q: torch.Tensor, s_t: torch.Tensor,
                           s_r: torch.Tensor, s_out: torch.Tensor, stride: int,
                           padding: int) -> torch.Tensor:
    return _k3.qconv_residual_requant(x, w, scale, bias, r_q, s_t, s_r, s_out,
                                      stride=stride, padding=padding)


@qconv_residual_requant.register_fake
def _(x, w, scale, bias, r_q, s_t, s_r, s_out, stride, padding):
    return torch.empty_like(r_q)


@torch.library.custom_op("mmbs::stem_requant_pool", mutates_args=())
def stem_requant_pool(y: torch.Tensor, bias: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return _k3.stem_requant_pool(y, bias, s)


@stem_requant_pool.register_fake
def _(y, bias, s):
    B, C, H, W = y.shape
    return y.new_empty((B, (H - 1) // 2 + 1, (W - 1) // 2 + 1, C), dtype=torch.int8)


@torch.library.custom_op("mmbs::fused_bottleneck_block", mutates_args=())
def fused_bottleneck_block(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                           w2: torch.Tensor, b2: torch.Tensor, w3: torch.Tensor,
                           b3: torch.Tensor, wd: torch.Tensor | None,
                           bd: torch.Tensor | None) -> torch.Tensor:
    # a fresh tensor: a custom op's output may not alias its input
    return _k4.fused_bottleneck_stage(x, [_k4.PackedBlock(w1, b1, w2, b2, w3, b3, wd, bd)])


@fused_bottleneck_block.register_fake
def _(x, w1, b1, w2, b2, w3, b3, wd, bd):
    B, _, H, W = x.shape
    return x.new_empty((B, w3.shape[0], H, W)).contiguous(memory_format=torch.channels_last)


def _cudnn_conv_meta(x, weight, bias, stride, padding, dilation, groups):
    y = F.conv2d(x, weight, bias, stride, padding, dilation, groups)
    if x.is_contiguous(memory_format=torch.channels_last):
        return y.contiguous(memory_format=torch.channels_last)
    return y


def _cudnn_conv_add_meta(x, weight, z, alpha, bias, stride, padding, dilation, groups):
    return _cudnn_conv_meta(x, weight, bias, stride, padding, dilation, groups)


# the folded encoder's fused cuDNN calls (models/serving.py) have no shape
# function of their own, so torch.export could not trace them
_aten = torch.library.Library("aten", "IMPL")
for _name, _meta in (("cudnn_convolution_relu", _cudnn_conv_meta),
                     ("cudnn_convolution_add_relu", _cudnn_conv_add_meta)):
    if not torch._C._dispatch_has_kernel_for_dispatch_key(f"aten::{_name}", "Meta"):
        _aten.impl(_name, _meta, "Meta")


def fused_bottleneck_stage(x: torch.Tensor, blocks) -> torch.Tensor:
    """K4 over a chain of ``PackedBlock``s: through the wrapper, or block
    by block through the op within ``exporting()``."""
    if not _exporting:
        return _k4.fused_bottleneck_stage(x, blocks)
    for blk in blocks:
        x = fused_bottleneck_block(x, *blk)
    return x
