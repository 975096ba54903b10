"""MIL bag aggregators: identity, gated tanh attention, transformer.

Counterpart of ``multimodalbrainsurvival_tpu/models/aggregators.py:30-146``
(reference ``1_HistoPathology/models.py:13-33``). Bags are padded to
``bag_size``; ``mask`` (B, bag) marks real patches.

Each aggregator maps ``(B, bag, D)`` features to the pooled ``(B, D)`` bag
embedding and the ``(B, bag)`` attention weights. The JAX aggregators return
the per-patch features and leave the masked mean to the model; the pooled
result is the same (``masked_bag_mean`` of the rescaled features), and here
the attention pool is the fused kernel ``kernels/attention_pool.py``. In
train mode an aggregator draws its dropout from the ``generator`` it is
given (the train loop's); the others take it and draw nothing. Under a
bag-sharded placement an aggregator sees the whole bag (the models gather
it, ``models/mil.py``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from multimodalbrainsurvival_torch.kernels import ops
from multimodalbrainsurvival_torch.kernels.attention_pool import pool
from multimodalbrainsurvival_torch.models.mil import masked_bag_mean
from multimodalbrainsurvival_torch.parallel import mesh as parallel


class IdentityAggregator(nn.Module):
    """Pass-through: uniform weights over real patches, masked bag mean."""

    def forward(self, x, mask=None, generator=None):
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

    def forward(self, x, mask=None, generator=None):
        B, bag, _ = x.shape
        if mask is None:
            mask = torch.ones((B, bag), dtype=torch.bool, device=x.device)
        # an exported program reaches K1 through its custom op
        fn = ops.attention_pool if ops.is_exporting() else pool
        return fn(
            x.to(self.dtype).contiguous(),
            self.linear.weight.to(self.dtype).contiguous(),
            self.vector,
            mask.bool().contiguous(),
        )


class FlaxLayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: eps 1e-6, the statistics in float32 as
    ``E[x^2] - E[x]^2`` clipped at 0, the result in ``dtype``."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
        y = (xf - mean) * (torch.rsqrt(var + 1e-6) * self.weight) + self.bias
        return y.to(self.dtype)


def _linear(x, layer: nn.Linear, dtype: torch.dtype):
    """flax ``nn.Dense`` with ``dtype``: input, kernel and bias in
    ``dtype``."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def _dropout(x, rate: float, generator):
    """flax ``nn.Dropout`` on all of ``x``: kept values scaled by
    ``1 / (1 - rate)``, the mask drawn from ``generator`` (for the global
    batch under data parallelism, this rank's rows kept)."""
    keep = parallel.draw_rows(x.shape, lambda shape: torch.rand(
        shape, generator=generator, device=x.device)) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class FlaxAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention`` in self-attention:
    ``q``, ``k``, ``v`` and ``o`` projections with biases, q scaled by
    ``1 / sqrt(head_dim)``, masked logits set to ``finfo(dtype).min`` (a
    row with no real key gets uniform weights, not NaN), and the dropout
    mask of ``broadcast_dropout``: one ``(bag, bag)`` mask on the weights,
    shared by every bag and head."""

    def __init__(self, dim: int, num_heads: int, dropout: float, dtype: torch.dtype):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} is not a multiple of num_heads {num_heads}")
        self.num_heads, self.dropout, self.dtype = num_heads, dropout, dtype
        self.q, self.k, self.v, self.o = (nn.Linear(dim, dim) for _ in range(4))

    def forward(self, z, mask=None, generator=None):
        B, bag, D = z.shape
        H, dt = self.num_heads, self.dtype
        hd = D // H

        def heads(layer):
            return _linear(z, layer, dt).view(B, bag, H, hd).transpose(1, 2)

        q = heads(self.q) / torch.tensor(float(hd)).sqrt().to(dt)
        logits = q @ heads(self.k).transpose(-1, -2)  # (B, H, bag, bag)
        if mask is not None:
            logits = torch.where(mask[:, None, None, :], logits,
                                 torch.finfo(dt).min)
        w = torch.softmax(logits, dim=-1).to(dt)
        if self.training and self.dropout > 0.0:
            keep_prob = 1.0 - self.dropout
            keep = torch.rand((bag, bag), generator=generator, device=z.device) < keep_prob
            w = w * (keep.to(dt) / torch.tensor(keep_prob, dtype=dt))
        out = (w @ heads(self.v)).transpose(1, 2).reshape(B, bag, D)
        return _linear(out, self.o, dt)


class EncoderLayer(nn.Module):
    """One pre-LN block: ``y + attn(ln1(y))``, then ``y + mlp2(drop(gelu(
    mlp1(ln2(y)))))`` with flax's tanh-approximate GELU."""

    def __init__(self, dim: int, num_heads: int, mlp_dim: int, dropout: float,
                 dtype: torch.dtype):
        super().__init__()
        self.dropout, self.dtype = dropout, dtype
        self.ln1 = FlaxLayerNorm(dim, dtype)
        self.attn = FlaxAttention(dim, num_heads, dropout, dtype)
        self.ln2 = FlaxLayerNorm(dim, dtype)
        self.mlp1 = nn.Linear(dim, mlp_dim)
        self.mlp2 = nn.Linear(mlp_dim, dim)

    def forward(self, y, mask=None, generator=None):
        y = y + self.attn(self.ln1(y), mask, generator)
        z = F.gelu(_linear(self.ln2(y), self.mlp1, self.dtype), approximate="tanh")
        if self.training and self.dropout > 0.0:
            z = _dropout(z, self.dropout, generator)
        return y + _linear(z, self.mlp2, self.dtype)


class TransformerAggregator(nn.Module):
    """Pre-LN transformer encoder over the bag's patch tokens, the JAX
    package's ``TransformerAggregator`` (``aggregators.py:76-120``; the
    reference names a ``TransformerEncoder`` it never defines,
    ``2_HistoPath_train.py:467``), matched to flax, not to
    ``nn.TransformerEncoderLayer``. Its output is zeroed at the pads and
    pooled by the masked bag mean; the weights are the mask.

    Parameters (``layers.{i}.``): ``ln1``, ``attn.{q,k,v,o}``, ``ln2``,
    ``mlp1``, ``mlp2``, the flax tree's ``ln1_i``, ``attn_i/{query,key,
    value,out}``, ``ln2_i``, ``mlp1_i`` and ``mlp2_i``
    (``models/convert.py``). Linears start as flax's (LeCun normal
    kernels, zero biases). Products run in ``dtype``, the LayerNorm
    statistics in float32."""

    def __init__(self, num_layers: int = 2, dim: int = 2048, num_heads: int = 8,
                 mlp_dim: int = 2048, dropout: float = 0.2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.layers = nn.ModuleList(
            EncoderLayer(dim, num_heads, mlp_dim, dropout, dtype)
            for _ in range(num_layers))
        for m in self.modules():
            if isinstance(m, nn.Linear):
                # flax lecun_normal: a normal truncated at 2 sigma, rescaled
                std = math.sqrt(1.0 / m.in_features) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std)
                nn.init.zeros_(m.bias)

    def forward(self, x, mask=None, generator=None):
        B, bag, _ = x.shape
        y = x.to(self.dtype)
        m = None if mask is None else mask.bool()
        for layer in self.layers:
            y = layer(y, m, generator)
        y = y.float()
        if m is None:
            return y.mean(dim=1), torch.ones((B, bag), device=x.device)
        weights = m.float()
        return masked_bag_mean(y * weights[..., None], m), weights


def make_aggregator(name: str, dim: int = 2048, *, hdim: int = 2048,
                    transformer_layers: int = 2, dropout: float = 0.2,
                    dtype: torch.dtype = torch.float32) -> nn.Module:
    """Config-string factory (``2_HistoPath_train.py:462-468``); ``hdim``
    is the transformer's MLP width, ``aggregator_hdim``."""
    if name == "identity":
        return IdentityAggregator()
    if name == "attention":
        return TanhAttention(dim=dim, dtype=dtype)
    if name == "transformer":
        return TransformerAggregator(num_layers=transformer_layers, dim=dim,
                                     mlp_dim=hdim, dropout=dropout, dtype=dtype)
    raise ValueError(f"Unknown aggregator: {name!r}")
