"""Check a reference PyTorch checkpoint's keys and write it as the port's ``.pt``.

Counterpart of the JAX CLI ``multimodalbrainsurvival_tpu/cli/convert_checkpoint.py``,
which turns a reference ``.pt`` into an Orbax directory. The port reads
reference ``.pt`` files as they are (``models/convert.py::
load_reference_state_dict``), so here the conversion is a check: the
checkpoint's state_dict (bare or under ``"state_dict"``) must load, key for
key and shape for shape, into the port's model of ``--arch``, built from
what the keys say (the ResNet's depth, the aggregator, the widths):

- ``histo``: ``AggregationModel`` / ``AggregationProjectModel``
  (``1_HistoPathology``); the ResNet's own 1000-class classifier
  (``resnet.fc.*``) is dropped;
- ``rna``: ``RNAOnlyModel`` (``2_GeneExpression``);
- ``joint``: ``BagHistopathologyRNAModel`` (``5_JointFusion``);
- ``resnet``: a bare encoder (for ``pretrained_path``); its ``fc.*`` is
  dropped, and ``--in_channels 1`` or ``4`` adapts its conv1 to a
  1- or 4-channel input (``models/convert.py::adapt_conv1_channels``,
  the ``rnone`` / ``rnfour`` encoders).

The checked state_dict is written to ``--output`` with ``torch.save``. No
device work; ``--device`` follows every entry point's rule (``cuda`` by
default, which raises without a card).

    python -m multimodalbrainsurvival_torch.cli.convert_checkpoint \\
        --torch_path model_dict_best.pt --arch histo --output model.pt --device cpu
"""

from __future__ import annotations

import argparse
import os
import re
from collections.abc import Mapping

import numpy as np
import torch

from multimodalbrainsurvival_torch.models import (
    RESNET_CONSTRUCTORS,
    AggregationModel,
    AggregationProjectModel,
    BagHistopathologyRNAModel,
    RNAEncoder,
    RNAOnlyModel,
    make_aggregator,
)
from multimodalbrainsurvival_torch.device import resolve_device
from multimodalbrainsurvival_torch.models.convert import adapt_conv1_channels

#: layer3's block count → the ResNet (Bottleneck ones have a conv3)
_DEPTHS = {(False, 2): "resnet18", (False, 6): "resnet34", (True, 6): "resnet50",
           (True, 23): "resnet101", (True, 36): "resnet152"}
ARCHS = ("histo", "rna", "joint", "resnet")


def load_state(path: str) -> dict[str, torch.Tensor]:
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, Mapping) and "state_dict" in state:
        state = state["state_dict"]
    return dict(state)


def infer_resnet(state: dict, prefix: str) -> torch.nn.Module:
    """The encoder the keys under ``prefix`` describe (no classifier)."""
    blocks = {int(m.group(1)) for k in state
              if (m := re.match(rf"{re.escape(prefix)}layer3\.(\d+)\.", k))}
    bottleneck = f"{prefix}layer1.0.conv3.weight" in state
    name = _DEPTHS.get((bottleneck, len(blocks)))
    if name is None:
        raise ValueError(f"no ResNet has {len(blocks)} layer3 blocks "
                         f"({'bottleneck' if bottleneck else 'basic'})")
    in_channels = state[f"{prefix}conv1.weight"].shape[1]
    return RESNET_CONSTRUCTORS[name](num_classes=None, in_channels=in_channels)


def _rna_encoder(state: dict) -> RNAEncoder:
    w1, w4 = state["rna_mlp.1.weight"], state["rna_mlp.4.weight"]
    return RNAEncoder(w1.shape[1], (w1.shape[0], w4.shape[0]))


def build_for(arch: str, state: dict) -> torch.nn.Module:
    """The port's model of ``arch`` shaped as ``state``'s keys say."""
    if arch == "resnet":
        return infer_resnet(state, "")
    if arch == "rna":
        return RNAOnlyModel(_rna_encoder(state), state["final_mlp.0.weight"].shape[0])
    resnet = infer_resnet(state, "resnet.")
    if arch == "joint":
        return BagHistopathologyRNAModel(resnet, _rna_encoder(state),
                                         out_features=state["final_mlp.1.weight"].shape[0])
    if "aggregator.linear.weight" in state:
        aggregator = make_aggregator("attention", dim=resnet.feature_dim)
    elif any(k.startswith("aggregator.layers.") for k in state):
        layers = {int(k.split(".")[2]) for k in state if k.startswith("aggregator.layers.")}
        hdim = state["aggregator.layers.0.mlp1.weight"].shape[0]
        aggregator = make_aggregator("transformer", dim=resnet.feature_dim, hdim=hdim,
                                     transformer_layers=len(layers))
    else:
        aggregator = make_aggregator("identity")
    out = state["fc.weight"].shape[0]
    if "project.weight" in state:
        return AggregationProjectModel(resnet, aggregator, out, state["project.weight"].shape[0])
    return AggregationModel(resnet, aggregator, out)


def convert(torch_path: str, arch: str, output: str,
            in_channels: int = 3) -> dict[str, torch.Tensor]:
    """Check ``torch_path`` against ``arch`` and write the port's ``.pt``
    (for ``resnet``, its conv1 adapted to ``in_channels``); returns the
    state_dict written."""
    state = load_state(torch_path)
    drop = "fc." if arch == "resnet" else "resnet.fc."
    state = {k: v for k, v in state.items() if not k.startswith(drop)}
    if arch == "resnet" and "conv1.weight" in state:
        w = state["conv1.weight"]
        state["conv1.weight"] = torch.from_numpy(np.ascontiguousarray(
            adapt_conv1_channels(w.numpy(), in_channels))).to(w.dtype)
    try:
        model = build_for(arch, state)
    except (KeyError, ValueError) as e:
        raise ValueError(f"{torch_path} is not a {arch} checkpoint: {e}") from e
    missing, unexpected = model.load_state_dict(state, strict=False)
    if missing or unexpected:
        raise ValueError(f"{torch_path} is not a {arch} checkpoint: missing keys "
                         f"{missing[:8]}, unexpected keys {unexpected[:8]}")
    out_dir = os.path.dirname(output)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    torch.save(state, output)
    n = sum(v.numel() for v in state.values())
    print(f"converted {arch} checkpoint ({n:,} values) -> {output}")
    return state


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--torch_path", required=True, help=".pt/.pth state_dict")
    p.add_argument("--arch", choices=ARCHS, required=True)
    p.add_argument("--output", required=True, help="the port's .pt to write")
    p.add_argument("--in_channels", type=int, default=3,
                   help="conv1 surgery target for arch=resnet (1/3/4)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    a = p.parse_args(argv)
    resolve_device(a.device)
    convert(a.torch_path, a.arch, a.output, a.in_channels)


if __name__ == "__main__":
    main()
