"""MIL bag aggregators: identity and gated tanh attention.

Counterpart of ``multimodalbrainsurvival_tpu/models/aggregators.py:30-73,
123-146`` (reference ``1_HistoPathology/models.py:13-33``). Bags are padded
to ``bag_size``; ``mask`` (B, bag) marks real patches.

Each aggregator maps ``(B, bag, D)`` features to the pooled ``(B, D)`` bag
embedding and the ``(B, bag)`` attention weights. The JAX aggregators return
the per-patch features and leave the masked mean to the model; the pooled
result is the same (``masked_bag_mean`` of the rescaled features), and here
the attention pool is the fused kernel ``kernels/attention_pool.py``.

The transformer aggregator comes with a later slice (ROADMAP.md).
"""

from __future__ import annotations

import torch
from torch import nn

from multimodalbrainsurvival_torch.kernels.attention_pool import pool
from multimodalbrainsurvival_torch.models.mil import masked_bag_mean


class IdentityAggregator(nn.Module):
    """Pass-through: uniform weights over real patches, masked bag mean."""

    def forward(self, x, mask=None):
        B, bag, _ = x.shape
        if mask is None:
            weights = torch.ones((B, bag), dtype=x.dtype, device=x.device)
        else:
            weights = mask.to(x.dtype)
        return masked_bag_mean(x, mask), weights


class TanhAttention(nn.Module):
    """Gated tanh attention (reference ``TanhAttention``, models.py:22-33):
    ``w = softmax_bag(tanh(x W^T) · v)`` over real patches, pooled to
    ``Σ_t w_t x_t`` (the reference's rescale by the bag size followed by the
    bag mean).

    Parameters ``linear.weight`` (D, D) and ``vector`` (D,) carry the
    reference's names. ``dtype`` is the dtype the projection reads its
    inputs in (bfloat16 in a bfloat16 model); products and sums are float32.
    The casts to ``dtype`` are differentiable: the gradient reaches the
    float32 features, ``linear.weight`` and ``vector``.
    """

    def __init__(self, dim: int = 2048, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.linear = nn.Linear(dim, dim, bias=False)
        self.vector = nn.Parameter(torch.zeros(dim))

    def forward(self, x, mask=None):
        B, bag, _ = x.shape
        if mask is None:
            mask = torch.ones((B, bag), dtype=torch.bool, device=x.device)
        return pool(
            x.to(self.dtype).contiguous(),
            self.linear.weight.to(self.dtype).contiguous(),
            self.vector,
            mask.bool().contiguous(),
        )


def make_aggregator(name: str, dim: int = 2048, *,
                    dtype: torch.dtype = torch.float32) -> nn.Module:
    """Config-string factory (``2_HistoPath_train.py:462-468``)."""
    if name == "identity":
        return IdentityAggregator()
    if name == "attention":
        return TanhAttention(dim=dim, dtype=dtype)
    if name == "transformer":
        raise NotImplementedError(
            "the transformer aggregator is not ported yet (ROADMAP.md, "
            "queue 1, item 1)"
        )
    raise ValueError(f"Unknown aggregator: {name!r}")
