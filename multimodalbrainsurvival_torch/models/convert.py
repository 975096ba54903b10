"""Weights between the JAX package, the reference and the port.

The port's ``state_dict`` keys are the reference's own (torchvision ResNet
names under ``resnet.``, ``aggregator.linear.weight``, ``aggregator.vector``,
``fc.*``), so a reference-trained ``.pt`` loads as it is
(``load_reference_state_dict``), and ``flax_mil_to_torch`` is the inverse of
the JAX package's ``torch_mil_to_flax``
(``multimodalbrainsurvival_tpu/models/convert.py:153-172``):

  ``params/resnet/conv1/kernel`` (HWIO)      → ``resnet.conv1.weight`` (OIHW)
  ``params/resnet/bn1/{scale,bias}``         → ``resnet.bn1.{weight,bias}``
  ``batch_stats/resnet/bn1/{mean,var}``      → ``resnet.bn1.running_{mean,var}``
  ``layer{i}_{j}/downsample_{conv,bn}``      → ``layer{i}.{j}.downsample.{0,1}``
  Dense ``kernel`` (in, out)                 → ``weight`` (out, in)
  ``aggregator/linear/kernel``, ``vector``   → ``aggregator.linear.weight``, ``aggregator.vector``
  ``project/{kernel,bias}`` (``ResNetProject``) → ``project.{weight,bias}``

The transformer aggregator's tree (``TransformerAggregator``; the reference
never defined one, so these names are the port's own):

  ``aggregator/ln{1,2}_{i}/{scale,bias}``     → ``aggregator.layers.{i}.ln{1,2}.{weight,bias}``
  ``aggregator/attn_{i}/{query,key,value}``   → ``aggregator.layers.{i}.attn.{q,k,v}``:
      ``kernel`` (D, H, hd) → ``weight`` = ``reshape(D, H*hd).T``; ``bias`` (H, hd) flattened
  ``aggregator/attn_{i}/out``                 → ``aggregator.layers.{i}.attn.o``:
      ``kernel`` (H, hd, D) → ``weight`` = ``reshape(H*hd, D).T``
  ``aggregator/mlp{1,2}_{i}/{kernel,bias}``   → ``aggregator.layers.{i}.mlp{1,2}.{weight,bias}``

A LayerNorm ``scale`` becomes a ``weight`` with no ``num_batches_tracked``
beside it (a BatchNorm's gets one), so the tree loads strictly.

``flax_folded_to_torch`` carries a folded tree across (the JAX package's
``models/folding.py::fold_resnet_variables`` output: each conv a ``kernel``
and a ``bias``, no BatchNorm) to the ``state_dict`` of the port's model built
with ``fold_bn=True``, whose convolutions carry the bias
(``layer1.0.conv1.bias``, ``layer1.0.downsample.0.bias``).

``flax_rna_to_torch`` is the inverse of ``torch_rna_to_flax``
(``multimodalbrainsurvival_tpu/models/convert.py:175-190``): ``encoder/
dense_0``, ``encoder/dense_1`` and ``final`` → ``rna_mlp.1``, ``rna_mlp.4``
and ``final_mlp.0`` (the reference's ``RNAOnlyModel`` keys).

``flax_feature_to_torch`` and ``flax_joint_to_torch`` are the inverses of
``torch_feature_to_flax`` and ``torch_joint_to_flax`` (``models/convert.py:
193-224`` of the JAX package): ``dense_0``, ``dense_1``, ``head`` → the
bare Sequential's ``1``, ``4``, ``7``; the joint tree's ``resnet`` (params
and ``batch_stats``) → ``resnet.*``, ``rna_encoder/dense_{0,1}`` →
``rna_mlp.{1,4}``, ``final`` → ``final_mlp.1``.

``flax_mlp_qtree_to_torch`` carries the JAX package's int8 MLP tree
(``quantize_mlp``: ``{"layers": [{k (in, out) int8, ws, b}]}``) into the
port's (``models/quantize.py::pack_int8_linear``: ``k`` in the
``nn.Linear`` layout, zero-padded to multiples of 8).

``flax_qtree_to_torch`` carries the JAX package's int8 serving tree
(``models/quantize.py::quantize_resnet``) into the port's layout
(``multimodalbrainsurvival_torch/models/quantize.py``): the same keys, HWIO
int8 kernels → (O, kh, kw, I), scalar scales → 0-dim float32 tensors.
"""

from __future__ import annotations

from typing import Any, Mapping

import re

import numpy as np
import torch

_SCOPE_RENAMES = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1",
                  "query": "q", "key": "k", "value": "v", "out": "o"}
_STAT_RENAMES = {"mean": "running_mean", "var": "running_var"}
# the transformer aggregator's per-layer scopes: ln1_0 → layers.0.ln1
_TRANSFORMER_SCOPE = re.compile(r"(ln1|ln2|attn|mlp1|mlp2)_(\d+)")


def _torch_scope(path: tuple[str, ...]) -> str:
    parts = []
    for p in path:
        if p.startswith("layer") and "_" in p:  # flax layer{i}_{j}
            parts.append(p.replace("_", "."))
        elif m := _TRANSFORMER_SCOPE.fullmatch(p):
            parts.append(f"layers.{m[2]}.{m[1]}")
        else:
            parts.append(_SCOPE_RENAMES.get(p, p))
    return ".".join(parts)


def _torch_kernel(path: tuple[str, ...], value: np.ndarray) -> np.ndarray:
    """A flax kernel → the torch weight: HWIO conv → OIHW; Dense (in, out)
    → (out, in); an attention projection's 3-d kernel flattened over its
    heads first (``out`` is (H, hd, D), the others (D, H, hd))."""
    if value.ndim == 4:
        return value.transpose(3, 2, 0, 1)
    if value.ndim == 3:
        shape = (-1, value.shape[-1]) if path[-2] == "out" else (value.shape[0], -1)
        return value.reshape(shape).T
    return value.T


def _flatten(tree: Mapping[str, Any], path=()) -> list[tuple[tuple, Any]]:
    out = []
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.extend(_flatten(v, path + (k,)))
        else:
            out.append((path + (k,), v))
    return out


def flax_mil_to_torch(params: Mapping, batch_stats: Mapping | None = None
                      ) -> dict[str, torch.Tensor]:
    """The JAX package's MIL variables (numpy leaves) → the port's
    ``state_dict`` (``AggregationModel`` / ``AggregationProjectModel``, with
    any aggregator; or ``ResNetProject``)."""
    state: dict[str, torch.Tensor] = {}
    for path, value in _flatten(params):
        value = np.asarray(value)
        scope, leaf = _torch_scope(path[:-1]), path[-1]
        if leaf == "kernel":
            value = _torch_kernel(path, value)
            leaf = "weight"
        elif leaf == "bias" and value.ndim == 2:  # an attention projection's (H, hd)
            value = value.reshape(-1)
        elif leaf == "scale":
            leaf = "weight"
            if not _TRANSFORMER_SCOPE.fullmatch(path[-2]):  # a BatchNorm
                state[f"{scope}.num_batches_tracked"] = torch.tensor(0)
        key = f"{scope}.{leaf}" if scope else leaf
        state[key] = torch.tensor(np.asarray(value, np.float32))
    for path, value in _flatten(batch_stats or {}):
        key = f"{_torch_scope(path[:-1])}.{_STAT_RENAMES[path[-1]]}"
        state[key] = torch.tensor(np.asarray(value, np.float32))
    return state


def flax_folded_to_torch(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX package's folded variables (numpy leaves; a MIL tree or a
    bare ResNet's, with or without the ``{"params": ...}`` level) → the
    port's ``state_dict`` of the same model with ``fold_bn=True``. Raises
    on a tree that still holds a BatchNorm: the folded model has no place
    for its numbers."""
    params = params.get("params", params)
    for path, _ in _flatten(params):
        if any(p.startswith("bn") or p == "downsample_bn" for p in path):
            raise ValueError(f"{'/'.join(path)}: not a folded tree (a BatchNorm "
                             "remains; fold it with fold_resnet_variables)")
    return flax_mil_to_torch(params)


_RNA_LINEARS = {("encoder", "dense_0"): "rna_mlp.1",
                ("encoder", "dense_1"): "rna_mlp.4",
                ("final",): "final_mlp.0"}


def flax_rna_to_torch(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX package's ``RNAOnlyModel`` params (numpy leaves) → the
    port's ``state_dict``."""
    return _linears_to_torch(params, _RNA_LINEARS)


def _linears_to_torch(params: Mapping, names: Mapping[tuple, str]) -> dict[str, torch.Tensor]:
    """flax Dense params at each path of ``names`` → ``<name>.weight``
    (out, in) and ``<name>.bias``."""
    state: dict[str, torch.Tensor] = {}
    for path, name in names.items():
        dense = params
        for key in path:
            dense = dense[key]
        state[f"{name}.weight"] = torch.tensor(np.asarray(dense["kernel"], np.float32).T)
        state[f"{name}.bias"] = torch.tensor(np.asarray(dense["bias"], np.float32))
    return state


def flax_feature_to_torch(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX package's ``EarlyFusionMLP`` params (numpy leaves) → the
    port's (and the reference's) ``state_dict``."""
    return _linears_to_torch(params, {("dense_0",): "1", ("dense_1",): "4",
                                      ("head",): "7"})


def flax_joint_to_torch(params: Mapping, batch_stats: Mapping | None = None
                        ) -> dict[str, torch.Tensor]:
    """The JAX package's ``BagHistopathologyRNAModel`` variables (numpy
    leaves) → the port's ``state_dict``."""
    state = flax_mil_to_torch({"resnet": params["resnet"]},
                              {"resnet": (batch_stats or {}).get("resnet", {})})
    state.update(_linears_to_torch(params, {
        ("rna_encoder", "dense_0"): "rna_mlp.1", ("rna_encoder", "dense_1"): "rna_mlp.4",
        ("final",): "final_mlp.1"}))
    return state


def flax_mlp_qtree_to_torch(qtree: Mapping) -> dict:
    """The JAX package's int8 MLP qtree (numpy leaves) → the port's."""
    from multimodalbrainsurvival_torch.models.quantize import pack_int8_linear

    return {"layers": [
        pack_int8_linear(torch.from_numpy(np.ascontiguousarray(np.asarray(lp["k"]).T)),
                         torch.tensor(np.asarray(lp["ws"], np.float32)),
                         torch.tensor(np.asarray(lp["b"], np.float32)))
        for lp in qtree["layers"]]}


def _qconv_to_torch(cp: Mapping) -> dict[str, torch.Tensor]:
    k = np.asarray(cp["k"])
    if k.dtype != np.int8 or k.ndim != 4:
        raise ValueError(f"expected an HWIO int8 kernel, got {k.dtype} {k.shape}")
    return {
        "k": torch.from_numpy(np.ascontiguousarray(k.transpose(3, 0, 1, 2))),
        "ws": torch.tensor(np.asarray(cp["ws"], np.float32)),
        "b": torch.tensor(np.asarray(cp["b"], np.float32)),
    }


def flax_qtree_to_torch(qtree: Mapping) -> dict:
    """The JAX package's int8 ResNet qtree (numpy leaves) → the port's:
    ``conv1`` and ``layerX_j.{conv1,conv2,conv3,downsample_conv}`` as
    ``{"k": (O, kh, kw, I) int8, "ws", "b"}``, ``scales`` as 0-dim float32
    tensors."""
    out: dict = {}
    for key, value in qtree.items():
        if key == "scales":
            out[key] = {site: torch.tensor(np.float32(v)) for site, v in value.items()}
        elif key == "conv1":
            out[key] = _qconv_to_torch(value)
        else:
            out[key] = {name: _qconv_to_torch(cp) for name, cp in value.items()}
    return out


def adapt_conv1_channels(weight_oihw: np.ndarray, in_channels: int, *,
                         rng: np.random.Generator | None = None) -> np.ndarray:
    """The reference's conv1 surgery for non-RGB inputs on an OIHW weight
    (JAX ``models/convert.py:46-78`` on HWIO; reference
    ``resnet.py:378-428``):

    - 1 channel (``RNone``): the mean over the RGB kernels;
    - 4 channels (``RNfour``): RGB kept and a 4th channel from N(0, 0.001),
      the JAX package's draw: ``rng.normal(0, 0.001, size=(h, w, 1, o))``
      from ``default_rng(0)`` unless ``rng`` is given, transposed to
      ``(o, 1, h, w)``, so both stacks' conv1 are equal;
    - the weight's own channel count: unchanged.
    """
    o, c, h, w = weight_oihw.shape
    if in_channels == c:
        return weight_oihw
    if in_channels == 1:
        return weight_oihw.mean(axis=1, keepdims=True)
    if in_channels == 4:
        if rng is None:
            rng = np.random.default_rng(0)
        extra = rng.normal(0.0, 0.001, size=(h, w, 1, o)).astype(weight_oihw.dtype)
        return np.concatenate([weight_oihw, extra.transpose(3, 2, 0, 1)], axis=1)
    raise ValueError(f"Cannot adapt conv1 from {c} to {in_channels} channels")


def load_reference_state_dict(path: str) -> dict[str, torch.Tensor]:
    """A reference (or port) MIL ``.pt`` → the port's ``state_dict``.

    Accepts a bare ``state_dict`` or one wrapped under ``"state_dict"``; the
    ResNet's own 1000-class classifier (``resnet.fc.*``) is dropped, since
    the MIL path never calls it.
    """
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, Mapping) and "state_dict" in state:
        state = state["state_dict"]
    return {k: v for k, v in state.items() if not k.startswith("resnet.fc.")}
