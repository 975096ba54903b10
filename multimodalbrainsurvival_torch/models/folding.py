"""BatchNorm folding for the serving path (``fold_bn: true``).

Counterpart of ``multimodalbrainsurvival_tpu/models/folding.py``, on a
``state_dict`` instead of a flax variable tree. For every conv→BN pair

    s       = gamma / sqrt(var + eps)
    weight' = weight * s            (broadcast over the output channel)
    bias'   = beta - mean * s

after which the BN disappears: the model built with ``fold_bn=True`` has
biased convolutions and identity norms.
"""

from __future__ import annotations

import torch

BN_EPS = 1e-5

_BN_LEAVES = ("weight", "bias", "running_mean", "running_var",
              "num_batches_tracked")


def _bn_scope(conv_scope: str) -> str | None:
    head, _, leaf = conv_scope.rpartition(".")
    if conv_scope.endswith("downsample.0"):
        return conv_scope[:-1] + "1"
    if leaf in ("conv1", "conv2", "conv3"):
        return f"{head}.bn{leaf[-1]}" if head else f"bn{leaf[-1]}"
    return None


def fold_resnet_state_dict(state: dict[str, torch.Tensor]) -> dict:
    """``state_dict`` of a stock model → that of the same model built with
    ``fold_bn=True``. Keys that are not part of a conv→BN pair (aggregator,
    heads) pass through untouched."""
    out: dict[str, torch.Tensor] = {}
    absorbed: set[str] = set()
    for key, value in state.items():
        scope = key[: -len(".weight")] if key.endswith(".weight") else None
        bn = _bn_scope(scope) if scope is not None and value.ndim == 4 else None
        if bn is None or f"{bn}.running_var" not in state:
            continue
        s = state[f"{bn}.weight"] / torch.sqrt(state[f"{bn}.running_var"] + BN_EPS)
        out[key] = value * s[:, None, None, None]
        out[f"{scope}.bias"] = state[f"{bn}.bias"] - state[f"{bn}.running_mean"] * s
        absorbed.update(f"{bn}.{leaf}" for leaf in _BN_LEAVES)
    for key, value in state.items():
        if key not in out and key not in absorbed:
            out[key] = value
    return out
