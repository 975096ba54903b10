"""Shared CLI scaffolding mirroring the reference scripts' command line.

Counterpart of ``multimodalbrainsurvival_tpu/cli/_common.py``. Every entry
point is ``python -m multimodalbrainsurvival_torch.cli.<name> --config
cfg.json [--seed N] [--quick 0/1] [--device cuda|cpu]``; the device is
``cuda`` unless ``--device cpu`` is given, and a run without a card raises.
The config's ``use_cuda`` key is not read: the device comes from
``--device`` alone. ``--seed`` seeds training: the initial weights and the
dropout seeds and augmentation draws (serving draws no random numbers).
``--log 1`` makes the train CLIs write their scalars to
``<summary_path>/<date>_<flag>/metrics.jsonl`` (``summary_path`` defaults to
``<checkpoint_path>/summary``); the serving CLIs accept ``--log`` and write
nothing, as the JAX ones do.

Training runs keep the reference layout: checkpoints under
``<checkpoint_path>/models/<flag>/``, score frames under
``<checkpoint_path>/outputs/<flag>/``.
"""

from __future__ import annotations

import argparse
import datetime
import itertools
import os

import numpy as np
import torch

from multimodalbrainsurvival_torch.config import Config
from multimodalbrainsurvival_torch.data import PatchBagDataset
from multimodalbrainsurvival_torch.device import compute_dtype
from multimodalbrainsurvival_torch.models import (
    RESNET_CONSTRUCTORS,
    AggregationModel,
    make_aggregator,
)
from multimodalbrainsurvival_torch.models.convert import load_reference_state_dict
from multimodalbrainsurvival_torch.models.folding import fold_resnet_state_dict
from multimodalbrainsurvival_torch.models.quantize import (
    quantize_mil_resnet,
    quantize_trunk_for_training,
)
from multimodalbrainsurvival_torch.train.adapters import (
    MILAdapter,
    QuantizedMILAdapter,
    QuantTrunkMILAdapter,
)
from multimodalbrainsurvival_torch.train.optim import (
    TrainOptimizer,
    relative_lr_schedule,
    wrap_optimizer,
)
from multimodalbrainsurvival_torch.utils.logging import MetricWriter


def make_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--config", type=str, default="config.json",
                   help="configuration json file")
    p.add_argument("--quick", type=int, default=0,
                   help="use small datasets to check that the script runs")
    p.add_argument("--log", type=int, default=0,
                   help="0 = do not use a summary writer")
    p.add_argument("--seed", type=int, default=1111,
                   help="seed of training's initial weights and dropout "
                        "(serving draws no random numbers)")
    p.add_argument("--save_images", type=int, default=0,
                   help="accepted for reference CLI parity (unused)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def load_config(args) -> tuple[Config, str]:
    """Returns (config, flag); the flag defaults to a timestamp, as in the
    reference."""
    config = Config.from_json(args.config)
    unknown = config.unknown_keys()
    if unknown:
        print(f"config: ignoring unrecognized keys: {', '.join(unknown)}")
    ignored = config.ignored_keys()
    if ignored:
        print(f"config: ignoring keys with no meaning in the port: {', '.join(ignored)}")
    config.check_ported()
    flag = config.get("flag", "") or "train_{date:%Y-%m-%d_%H:%M:%S}".format(
        date=datetime.datetime.now()
    )
    return config, flag


def experiment_dirs(config: Config, flag: str) -> tuple[str, str]:
    """``(<checkpoint_path>/models/<flag>, <checkpoint_path>/outputs/<flag>)``,
    the first created."""
    checkpoint_path = config.get("checkpoint_path", "checkpoints/")
    save_dir = os.path.join(checkpoint_path, "models", flag)
    output_dir = os.path.join(checkpoint_path, "outputs", flag)
    os.makedirs(save_dir, exist_ok=True)
    return save_dir, output_dir


def make_writer(log: bool, config: Config, flag: str) -> MetricWriter | None:
    """A ``MetricWriter`` on ``<summary_path>/<date>_<flag>/`` that has
    logged the config, or None without ``--log`` (the JAX ``make_writer``;
    ``summary_path`` defaults to ``<checkpoint_path>/summary`` as at the
    JAX ``cli/_common.py:106``)."""
    if not log:
        return None
    checkpoint_path = config.get("checkpoint_path", "checkpoints/")
    summary = config.get("summary_path", os.path.join(checkpoint_path, "summary"))
    d = os.path.join(
        summary, datetime.datetime.now().strftime("%Y-%m-%d_%H:%M:%S") + f"_{flag}")
    writer = MetricWriter(d)
    writer.text("config", dict(config.raw))
    return writer


def maybe_restore(model: torch.nn.Module, config: Config, keys: tuple[str, ...]) -> None:
    """Warm start: load each reference-keyed ``.pt`` the config names under
    ``keys``, in order (``2_HistoPath_train.py:531-537``)."""
    for key in keys:
        path = config.get(key, "")
        if path:
            model.load_state_dict(load_reference_state_dict(path))
            print("Loaded model from checkpoint for finetuning")


def tune_optimizer(optimizer: torch.optim.Optimizer, config: Config, n_train: int,
                   *, num_epochs: int, batch_size: int) -> TrainOptimizer:
    """The config's whole-model optimizer knobs around the groups
    (``cli/_common.py:184-229`` of the JAX package): ``lr_schedule``
    ("constant" | "cosine" | "linear" | "step") over
    ``ceil(n_train / batch_size) · num_epochs`` steps with ``warmup_steps``,
    ``lr_min_factor``, ``lr_step_every_epochs`` + ``lr_step_gamma``; and
    ``grad_clip_norm``."""
    kind = str(config.get("lr_schedule", "constant"))
    warmup = int(config.get("warmup_steps", 0))
    clip = config.get("grad_clip_norm")
    steps_per_epoch = max(1, -(-int(n_train) // int(batch_size)))
    schedule = None
    if kind != "constant" or warmup > 0:
        schedule = relative_lr_schedule(
            kind,
            total_steps=steps_per_epoch * int(num_epochs),
            warmup_steps=warmup,
            min_factor=float(config.get("lr_min_factor", 0.0)),
            step_every=int(config.get("lr_step_every_epochs", 0)) * steps_per_epoch,
            step_gamma=float(config.get("lr_step_gamma", 0.1)),
        )
    return wrap_optimizer(optimizer, schedule=schedule,
                          grad_clip_norm=float(clip) if clip is not None else None)


def early_stop_kwargs(config: Config) -> dict:
    """TrainSettings kwargs of the opt-in early stopping."""
    return {
        "early_stop_patience": int(config.get("early_stop_patience", 0)),
        "early_stop_min_delta": float(config.get("early_stop_min_delta", 0.0)),
    }


def savescore_name(prefix: str, dataset: str, flag: str) -> str:
    """Reference naming: ``<prefix>_<split>[_<flag>]_df.csv``, the flag
    appended only for cross-validation runs (``'cv' in flag``)."""
    if "cv" in flag:
        return f"{prefix}_{dataset}_{flag}_df.csv"
    return f"{prefix}_{dataset}_df.csv"


def extract_features_frames(cases: list[str], feats: np.ndarray):
    """Per-case mean features, cases in order of first appearance
    (``4_HistoPath_extractfeatures.py:80-88``)."""
    order: dict[str, int] = {}
    inverse = np.array([order.setdefault(c, len(order)) for c in cases], np.intp)
    sums = np.zeros((len(order), feats.shape[1]), np.float64)
    np.add.at(sums, inverse, feats)
    counts = np.bincount(inverse, minlength=len(order))
    return list(order), (sums / counts[:, None]).astype(feats.dtype)


def quantize_mode(config: Config) -> str:
    """Validated ``quantize`` config value: ``""`` (float serving, default)
    or ``"int8"`` (W8A8 ResNet, ``models/quantize.py``). int8 implies
    ``fold_bn``: the int8 weights are built from the folded kernels."""
    quant = str(config.get("quantize", "") or "").lower()
    if quant not in ("", "int8"):
        raise ValueError(f"unsupported quantize mode: {quant!r}")
    return quant


def build_mil_model(config, fold_bn: bool = False) -> AggregationModel:
    """The config's MIL model: ResNet encoder (without its classifier) →
    aggregator → ``num_classes`` head, in the config's ``compute_dtype``,
    with its ``remat`` and ``freeze_bn`` training keys."""
    dtype = compute_dtype(config.compute_dtype)
    resnet = RESNET_CONSTRUCTORS[config.model_name](
        num_classes=None, dtype=dtype, fold_bn=fold_bn,
        freeze_bn=bool(config.get("freeze_bn", False)),
        remat=config.get("remat", False) or False,
    )
    aggregator = make_aggregator(config.aggregator, dim=resnet.feature_dim,
                                 dtype=dtype)
    return AggregationModel(resnet, aggregator, out_features=config.num_classes)


def build_datasets(config, quick: bool) -> dict[str, PatchBagDataset]:
    if config.get("cache_patches_on_device", False):
        raise NotImplementedError(
            "cache_patches_on_device is not ported yet (ROADMAP.md, queue 1, "
            "item 11); the port reads every batch from the host")
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


def load_mil_model(config: Config, device: torch.device) -> AggregationModel:
    """Build the MIL model, load ``model_path`` (a reference-keyed ``.pt``),
    fold BatchNorm when ``fold_bn: true`` or ``quantize: "int8"``, and place
    it on ``device`` in eval mode with ``channels_last`` convolution
    weights. Checkpoints are always stored unfolded."""
    fold = bool(config.get("fold_bn", False)) or bool(quantize_mode(config))
    state = load_reference_state_dict(config["model_path"])
    model = build_mil_model(config)
    model.load_state_dict(state)
    if fold:
        model = build_mil_model(config, fold_bn=True)
        model.load_state_dict(fold_resnet_state_dict(state))
        print("folded BatchNorm into conv weights for serving")
    return model.to(device, memory_format=torch.channels_last).eval()


def quantize_serving(config: Config, adapter: MILAdapter, probe: dict
                     ) -> QuantizedMILAdapter:
    """Swap a float MIL serving adapter for the int8 (W8A8) one: calibrate
    the activation ranges on the probe batch and quantize the folded ResNet
    weights. Deviates from reference numerics by int8 rounding (per-sample
    embedding cosine > 0.995), opt-in for that reason."""
    qtree = quantize_mil_resnet(adapter.model.resnet, [probe["patch_bag"]],
                                arch=config.model_name)
    print("quantized ResNet to int8 (W8A8) for serving")
    return QuantizedMILAdapter(
        model=adapter.model, device=adapter.device,
        loader_kwargs=adapter.loader_kwargs, qtree=qtree,
        arch=config.model_name,
    )


def serving_adapter(config: Config, device: torch.device, datasets: dict
                    ) -> MILAdapter:
    """The serving CLIs' adapter: the float model, or with ``quantize:
    "int8"`` its int8 encoder calibrated on the first train batch."""
    adapter = MILAdapter(
        model=load_mil_model(config, device),
        device=device,
        loader_kwargs={"num_threads": int(config.get("num_workers", 8)) or 1},
    )
    if not quantize_mode(config):
        return adapter
    batches = datasets["train"].batches(config.batch_size, **adapter.loader_kwargs)
    probe = next(batches)
    batches.close()
    return quantize_serving(config, adapter, probe)


def quantize_trunk_training(config: Config, adapter: MILAdapter, datasets: dict,
                            batch_size: int, seed: int) -> MILAdapter:
    """With ``quantize_trunk: "int8"``, swap a float MIL training adapter
    for the int8 frozen-trunk one (JAX ``cli/_common.py:416-496``, its MIL
    branch; the joint branch comes with fusion, ROADMAP.md item 5).

    The freeze ladder trains the first ``n_layers_to_train`` of ``fc,
    layer4, …``, so the stem and ``min(4, 5 - max(n, 1))`` residual stages
    below them run forward-only every step; that prefix is folded,
    calibrated and quantized once, here, on the JAX CLI's calibration set:
    its probe batch (the first train batch) and the first two train
    batches. Without the key the adapter is returned as it is."""
    mode = str(config.get("quantize_trunk", "") or "")
    if not mode:
        return adapter
    if mode != "int8":
        raise ValueError(f"quantize_trunk: unknown mode {mode!r} (supported: 'int8')")
    n = config.n_layers_to_train
    trunk_stages = min(4, 5 - max(n, 1))
    if trunk_stages < 1:
        raise ValueError(
            "quantize_trunk requires n_layers_to_train <= 4: the frozen prefix "
            f"must cover at least conv1 and layer1 (got n_layers_to_train={n})")
    batches = datasets["train"].batches(batch_size, **adapter.loader_kwargs)
    try:
        first_two = [b["patch_bag"] for b in itertools.islice(batches, 2)]
    finally:
        batches.close()
    cal_bags = first_two[:1] + first_two
    qtree = quantize_trunk_for_training(adapter.model.resnet, cal_bags,
                                        arch=config.model_name,
                                        augment=adapter.augment, seed=seed)
    print(f"quantize_trunk: int8 frozen prefix = stem + {trunk_stages} stage(s); "
          "the trainable tail stays float")
    return QuantTrunkMILAdapter(
        model=adapter.model, device=adapter.device,
        loader_kwargs=adapter.loader_kwargs, augment=adapter.augment,
        qtree=qtree, trunk_stages=trunk_stages, arch=config.model_name,
    )
