"""Histopathology MIL model and dataset constructors for the serving CLIs.

Counterpart of ``multimodalbrainsurvival_tpu/cli/histo_train.py:45-145``:
``build_mil_model`` and ``build_datasets``. The training entry point
itself comes with the training slice (ROADMAP.md, queue 1, item 3), and
so does the device cache.
"""

from __future__ import annotations

from multimodalbrainsurvival_torch.data import PatchBagDataset
from multimodalbrainsurvival_torch.device import compute_dtype
from multimodalbrainsurvival_torch.models import (
    RESNET_CONSTRUCTORS,
    AggregationModel,
    make_aggregator,
)


def build_mil_model(config, fold_bn: bool = False) -> AggregationModel:
    """The config's MIL model: ResNet encoder (without its classifier) →
    aggregator → ``num_classes`` head, in the config's ``compute_dtype``."""
    dtype = compute_dtype(config.compute_dtype)
    resnet = RESNET_CONSTRUCTORS[config.model_name](
        num_classes=None, dtype=dtype, fold_bn=fold_bn
    )
    aggregator = make_aggregator(config.aggregator, dim=resnet.feature_dim,
                                 dtype=dtype)
    return AggregationModel(resnet, aggregator, out_features=config.num_classes)


def build_datasets(config, quick: bool) -> dict[str, PatchBagDataset]:
    max_train = config.get("max_patch_per_wsi_train", 1000)
    max_val = config.get("max_patch_per_wsi_val", 1000)
    if quick:
        max_train = max_val = 20  # 2_HistoPath_train.py:495-497
    common = dict(
        patch_data_path=config["data_path"],
        img_size=config.img_size,
        keep_remainder=bool(config.get("keep_bag_remainder", False)),
    )
    return {
        "train": PatchBagDataset(
            csv_path=config["train_csv_path"],
            bag_size=config.get("train_bag_size", 1),
            max_patches_total=max_train, **common,
        ),
        "val": PatchBagDataset(
            csv_path=config["val_csv_path"],
            bag_size=config.get("val_bag_size", 1),
            max_patches_total=max_val, **common,
        ),
        "test": PatchBagDataset(
            csv_path=config["test_csv_path"],
            bag_size=config.get("val_bag_size", 1),
            max_patches_total=max_val, **common,
        ),
    }
