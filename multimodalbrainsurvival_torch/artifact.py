"""Serving artifacts: a trained model as one ``torch.export`` program.

Counterpart of ``multimodalbrainsurvival_tpu/serving.py:41-379``. The whole
serving computation (uint8 patches → normalization → the float, folded or
int8 encoder → aggregator or fusion tail → head) is exported with its
weights in ``<dir>/serving.pt2`` beside ``<dir>/meta.json``, for each model
family:

- ``mil_serving``: ``(patch_bag uint8 (b, g, H, W, C), bag_mask float32
  (b, g))`` → ``embedding``, ``scores``, ``attention``;
- ``rna_serving`` / ``feature_serving``: ``(data float32 (b, F))`` →
  ``scores`` (and the RNA MLP's ``embedding``);
- ``joint_serving``: ``(patch_bag, bag_mask, rna_data float32 (b, R))`` →
  ``embedding``, ``scores``.

The batch ``b`` and bag ``g`` are symbolic (``torch.export.Dim``), so one
program serves every size. The program reaches the port's kernels through
their custom ops (``kernels/ops.py``: K1 for the attention pool, K4 on a
folded Bottleneck encoder, K3 on an int8 one); the wrappers' checks run
when it is called, not when it is traced. int8 scales are calibrated
before the export, on real data. A program exported with CUDA weights runs
on CUDA: ``meta.json`` says so in ``platforms`` (``["cuda"]`` or
``["cpu"]``), beside ``torch_version``; its other keys, the
``calling_convention`` strings among them, are the JAX package's.
``load_artifact`` needs no model code of this package, only the ops.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import torch
from torch import nn

from multimodalbrainsurvival_torch.kernels import ops
from multimodalbrainsurvival_torch.models.mil import patch_embeddings
from multimodalbrainsurvival_torch.models.quantize import quantized_extract, quantized_mlp
from multimodalbrainsurvival_torch.ops.image import preprocess_patches

ARTIFACT_FILE = "serving.pt2"
META_FILE = "meta.json"
#: the example sizes traced (neither 0 nor 1, which torch.export fixes)
EXAMPLE_BATCH, EXAMPLE_BAG = 2, 3


class _QTree(nn.Module):
    """A qtree's tensors as buffers (saved with the program), its nested
    dict rebuilt by ``tree()``."""

    def __init__(self, qtree: dict):
        super().__init__()
        self._paths = []

        def walk(node, path):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, path + (k,))
            elif isinstance(node, list):
                for i, v in enumerate(node):
                    walk(v, path + (i,))
            else:
                self.register_buffer(f"q{len(self._paths)}", node)
                self._paths.append(path)

        walk(qtree, ())
        self._layout = qtree

    def tree(self) -> dict:
        index = {path: i for i, path in enumerate(self._paths)}

        def build(node, path):
            if isinstance(node, dict):
                return {k: build(v, path + (k,)) for k, v in node.items()}
            if isinstance(node, list):
                return [build(v, path + (i,)) for i, v in enumerate(node)]
            return getattr(self, f"q{index[path]}")

        return build(self._layout, ())


def _features(model, qtree: _QTree | None, arch: str, patch_bag, dtype):
    """(b, g, H, W, C) uint8 → (b, g, D) float32 per-patch embeddings."""
    B, bag = patch_bag.shape[:2]
    flat = patch_bag.reshape((B * bag,) + patch_bag.shape[2:])
    if qtree is not None:
        x = preprocess_patches(flat, dtype=torch.float32)
        feats = quantized_extract(qtree.tree(), x, arch=arch)
    else:
        feats = patch_embeddings(model.resnet, preprocess_patches(flat, dtype=dtype))
    return feats.reshape(B, bag, -1)


class MILServing(nn.Module):
    """An ``AggregationModel``'s serving computation (JAX
    ``_mil_serving_fn``); ``qtree``: the int8 encoder's."""

    def __init__(self, model: nn.Module, qtree: dict | None = None, arch: str = "resnet50"):
        super().__init__()
        self.model = model.eval()
        self.qtree = _QTree(qtree) if qtree is not None else None
        self.arch = arch

    def forward(self, patch_bag: torch.Tensor, bag_mask: torch.Tensor) -> dict:
        feats = _features(self.model, self.qtree, self.arch, patch_bag,
                          self.model.resnet.dtype)
        emb, attention = self.model.extract_from_feats(feats, bag_mask != 0)
        return {"embedding": emb.float(), "scores": self.model.fc(emb.float()).float(),
                "attention": attention.float()}


class TableServing(nn.Module):
    """The RNA MLP (scores and its embedding) or the early-fusion MLP
    (scores) (JAX ``_table_serving_fn``); ``qtree``: the int8 RNA
    encoder's, under the float head."""

    def __init__(self, model: nn.Module, qtree: dict | None = None):
        super().__init__()
        self.model = model.eval()
        self.qtree = _QTree(qtree) if qtree is not None else None

    def forward(self, data: torch.Tensor) -> dict:
        if self.qtree is not None:
            emb = quantized_mlp(self.qtree.tree(), data)
            return {"scores": self.model.from_embedding(emb).float(),
                    "embedding": emb.float()}
        if hasattr(self.model, "extract"):
            emb = self.model.extract(data)
            return {"scores": self.model.from_embedding(emb).float(),
                    "embedding": emb.float()}
        return {"scores": self.model(data).float()}


class JointServing(nn.Module):
    """``BagHistopathologyRNAModel``'s serving computation (JAX
    ``_joint_serving_fn``): float, or int8 with both encoders' qtrees."""

    def __init__(self, model: nn.Module, qtree: dict | None = None,
                 qtree_rna: dict | None = None, arch: str = "resnet50"):
        super().__init__()
        self.model = model.eval()
        self.qtree = _QTree(qtree) if qtree is not None else None
        self.qtree_rna = _QTree(qtree_rna) if qtree_rna is not None else None
        self.arch = arch

    def forward(self, patch_bag, bag_mask, rna_data) -> dict:
        feats = _features(self.model, self.qtree, self.arch, patch_bag,
                          self.model.resnet.dtype)
        mask = bag_mask != 0
        if self.qtree_rna is not None:
            rna = quantized_mlp(self.qtree_rna.tree(), rna_data)
            emb = self.model.extract_from_all_feats(feats, rna, mask)
        else:
            emb = self.model.extract_from_feats(feats, rna_data, mask)
        return {"embedding": emb.float(), "scores": self.model.head(emb, None).float()}


def _device_of(module: nn.Module) -> torch.device:
    return next(module.parameters()).device


def _export(module: nn.Module, example: tuple, dynamic: tuple, out_dir: str,
            meta: dict, extra_meta: dict | None) -> dict:
    """Trace ``module`` (kernels as custom ops), save the program and
    ``meta.json``; returns the metadata."""
    with torch.no_grad(), ops.exporting():
        program = torch.export.export(module, example, dynamic_shapes=dynamic)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, ARTIFACT_FILE)
    torch.export.save(program, path)
    device = _device_of(module)
    meta = {
        "artifact": ARTIFACT_FILE,
        **meta,
        "platforms": [device.type],
        "torch_version": torch.__version__,
        "size_bytes": os.path.getsize(path),
    }
    meta.update(extra_meta or {})
    with open(os.path.join(out_dir, META_FILE), "w") as f:
        json.dump(meta, f, indent=2)
    return meta


def _bag_example(img_size: int, in_channels: int, device) -> tuple:
    return (torch.zeros((EXAMPLE_BATCH, EXAMPLE_BAG, img_size, img_size, in_channels),
                        dtype=torch.uint8, device=device),
            torch.ones((EXAMPLE_BATCH, EXAMPLE_BAG), dtype=torch.float32, device=device))


def export_mil_artifact(model: nn.Module, out_dir: str, *, img_size: int,
                        qtree: dict | None = None, in_channels: int = 3,
                        arch: str = "resnet50", extra_meta: dict | None = None) -> dict:
    """Export an ``AggregationModel`` (on its device; int8 with ``qtree``)
    to ``out_dir``; returns its metadata."""
    module = MILServing(model, qtree, arch)
    b, g = torch.export.Dim("b"), torch.export.Dim("g")
    return _export(module, _bag_example(img_size, in_channels, _device_of(model)),
                   ({0: b, 1: g}, {0: b, 1: g}), out_dir, {
        "kind": "mil_serving",
        "arch": arch,
        "img_size": img_size,
        "in_channels": in_channels,
        "quantize": "int8" if qtree is not None else "",
        "calling_convention": {
            "args": [
                f"patch_bag uint8 (b, g, {img_size}, {img_size}, {in_channels})",
                "bag_mask float32 (b, g) — 1.0 real patch, 0.0 pad",
            ],
            "returns": "dict(embedding (b, D) f32, scores (b, C) f32, attention (b, g) f32)",
        },
    }, extra_meta)


def export_table_artifact(model: nn.Module, out_dir: str, *, in_features: int,
                          kind: str = "table_serving", qtree: dict | None = None,
                          extra_meta: dict | None = None) -> dict:
    """Export the RNA MLP or the early-fusion MLP (``kind``
    ``rna_serving`` / ``feature_serving``)."""
    module = TableServing(model, qtree)
    example = (torch.zeros((EXAMPLE_BATCH, in_features), dtype=torch.float32,
                           device=_device_of(model)),)
    returns = "dict(scores (b, C) f32"
    if qtree is not None or hasattr(model, "extract"):
        returns += ", embedding (b, D) f32"
    return _export(module, example, ({0: torch.export.Dim("b")},), out_dir, {
        "kind": kind,
        "in_features": in_features,
        "quantize": "int8" if qtree is not None else "",
        "calling_convention": {"args": [f"data float32 (b, {in_features})"],
                               "returns": returns + ")"},
    }, extra_meta)


def export_joint_artifact(model: nn.Module, out_dir: str, *, img_size: int,
                          rna_features: int, qtree: dict | None = None,
                          qtree_rna: dict | None = None, in_channels: int = 3,
                          arch: str = "resnet50", extra_meta: dict | None = None) -> dict:
    """Export a ``BagHistopathologyRNAModel`` (int8 with both qtrees)."""
    module = JointServing(model, qtree, qtree_rna, arch)
    device = _device_of(model)
    b, g = torch.export.Dim("b"), torch.export.Dim("g")
    example = (*_bag_example(img_size, in_channels, device),
               torch.zeros((EXAMPLE_BATCH, rna_features), dtype=torch.float32, device=device))
    return _export(module, example, ({0: b, 1: g}, {0: b, 1: g}, {0: b}), out_dir, {
        "kind": "joint_serving",
        "arch": arch,
        "img_size": img_size,
        "in_channels": in_channels,
        "rna_features": rna_features,
        "quantize": "int8" if qtree is not None else "",
        "calling_convention": {
            "args": [
                f"patch_bag uint8 (b, g, {img_size}, {img_size}, {in_channels})",
                "bag_mask float32 (b, g) — 1.0 real patch, 0.0 pad",
                f"rna_data float32 (b, {rna_features})",
            ],
            "returns": "dict(embedding (b, D) f32, scores (b, C) f32)",
        },
    }, extra_meta)


@dataclass
class ExportedServing:
    """A loaded artifact: ``call(*args)`` with tensors as
    ``meta["calling_convention"]`` says → a dict of float32 tensors."""

    program: torch.export.ExportedProgram
    meta: dict

    def __post_init__(self):
        self._module = self.program.module()

    def call(self, *args) -> dict:
        with torch.inference_mode():
            return self._module(*args)


def load_artifact(path: str) -> ExportedServing:
    """Load an artifact directory written by one of the ``export_*``
    functions (the kernels' custom ops are registered by this module's
    import of ``kernels/ops.py``)."""
    with open(os.path.join(path, META_FILE)) as f:
        meta = json.load(f)
    program = torch.export.load(os.path.join(path, meta["artifact"]))
    return ExportedServing(program=program, meta=meta)
