"""Export a trained model as a self-contained serving artifact.

Parity with the JAX CLI ``multimodalbrainsurvival_tpu/cli/export_model.py``:
the model in ``model_path`` (a reference-keyed ``.pt``), with its
preprocessing, encoders (float, ``fold_bn: true`` or ``quantize:
"int8"``), aggregator or fusion tail and head, becomes one
shape-polymorphic ``torch.export`` program under ``export_path``
(``artifact.py``: ``serving.pt2`` and ``meta.json``), loadable with
``multimodalbrainsurvival_torch.artifact.load_artifact`` and served by
``cli/serve.py``. The program is traced on ``--device`` (``cuda`` by
default, which raises without a card) and runs there.

Config keys: ``model_path``, ``export_path``, ``export_kind`` (``"mil"``
by default, ``"rna"``, ``"feature"`` or ``"joint"``) and the model keys
of the matching serving CLI (``model_name``, ``aggregator``,
``compute_dtype``, ``img_size``, ``fold_bn``, ``quantize``). An int8
ResNet is calibrated on the first train batch, so the data keys must name
the cohort as for the serving CLIs; the table and joint kinds read the
train CSV for the input width.

    python -m multimodalbrainsurvival_torch.cli.export_model --config cfg.json
"""

from __future__ import annotations

import functools

from multimodalbrainsurvival_torch import artifact
from multimodalbrainsurvival_torch.cli._common import (
    build_datasets,
    load_config,
    load_mil_model,
    make_parser,
    quantize_mode,
    serving_adapter,
    single_device_serving,
)
from multimodalbrainsurvival_torch.cli.feature_train import build_feature_model
from multimodalbrainsurvival_torch.cli.joint_train import build_joint_datasets, build_joint_model
from multimodalbrainsurvival_torch.cli.rna_train import rna_serving_adapter
from multimodalbrainsurvival_torch.data import FeatureTableDataset, RNATableDataset
from multimodalbrainsurvival_torch.device import resolve_device
from multimodalbrainsurvival_torch.models.convert import load_reference_state_dict
from multimodalbrainsurvival_torch.train.adapters import JointAdapter


def _fold(config) -> bool:
    return bool(config.get("fold_bn", False)) or bool(quantize_mode(config))


def export_mil(config, device, quick: bool, out_dir: str) -> dict:
    if quantize_mode(config):  # calibrated on the first train batch
        adapter = serving_adapter(config, device, build_datasets(config, quick))
        model, qtree = adapter.model, adapter.qtree
    else:
        model, qtree = load_mil_model(config, device), None
    return artifact.export_mil_artifact(
        model, out_dir, img_size=config.img_size, qtree=qtree, arch=config.model_name,
        extra_meta={"model_path": str(config.get("model_path", "")),
                    "aggregator": str(config.aggregator), "fold_bn": _fold(config)})


def export_joint(config, device, quick: bool, out_dir: str) -> dict:
    datasets = build_joint_datasets(config, quick)
    rna_dim = datasets["train"].rna_dim
    build = functools.partial(build_joint_model, in_features=rna_dim)
    adapter = serving_adapter(config, device, datasets, build, JointAdapter)
    return artifact.export_joint_artifact(
        adapter.model, out_dir, img_size=config.img_size, rna_features=rna_dim,
        qtree=getattr(adapter, "qtree", None), qtree_rna=getattr(adapter, "qtree_rna", None),
        arch=config.model_name,
        extra_meta={"model_path": str(config.get("model_path", "")),
                    "fold_bn": _fold(config)})


def export_table(config, device, kind: str, out_dir: str) -> dict:
    if kind == "rna":
        width = RNATableDataset(config["train_csv_path"]).feature_dim
        adapter = rna_serving_adapter(config, device, width)
        model, qtree = adapter.model, getattr(adapter, "qtree", None)
    else:
        width = FeatureTableDataset(config["train_csv_path"]).feature_dim
        model = build_feature_model(config, in_features=width)
        model.load_state_dict(load_reference_state_dict(config["model_path"]))
        model, qtree = model.to(device).eval(), None
    return artifact.export_table_artifact(
        model, out_dir, in_features=width, kind=f"{kind}_serving", qtree=qtree,
        extra_meta={"model_path": str(config.get("model_path", ""))})


def main(argv=None):
    args = make_parser(__doc__).parse_args(argv)
    device = resolve_device(args.device)
    with single_device_serving(device) as serving:
        if not serving:
            return
        config, _ = load_config(args)
        out_dir = config.get("export_path") or ""
        if not out_dir:
            raise SystemExit("export_model requires an 'export_path' config key")
        kind = str(config.get("export_kind", "mil") or "mil").lower()
        if kind == "mil":
            meta = export_mil(config, device, bool(args.quick), out_dir)
        elif kind == "joint":
            meta = export_joint(config, device, bool(args.quick), out_dir)
        elif kind in ("rna", "feature"):
            if kind == "feature" and quantize_mode(config):
                raise SystemExit("quantize=int8 applies to the ResNet and RNA serving paths, "
                                 "not export_kind='feature'")
            meta = export_table(config, device, kind, out_dir)
        else:
            raise SystemExit(f"unknown export_kind: {kind!r} "
                             "(expected mil / rna / feature / joint)")
        print(f"exported {meta['kind']} artifact ({meta['size_bytes'] / 1e6:.1f} MB, platforms "
              f"{'+'.join(meta['platforms'])}, quantize={meta['quantize'] or 'no'}) to {out_dir}")


if __name__ == "__main__":
    main()
