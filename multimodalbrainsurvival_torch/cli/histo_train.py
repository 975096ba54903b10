"""Histopathology MIL training CLI, the flagship pipeline.

Parity with ``1_HistoPathology/2_HistoPath_train.py`` and the JAX CLI
``multimodalbrainsurvival_tpu/cli/histo_train.py``: Cox training of the MIL
model (ResNet encoder → aggregator → head) under the reference's freeze
ladder (``:544-551``: the first ``n_layers_to_train`` of ``fc, layer4, …,
conv1`` plus the aggregator train, one Adam group at ``lr``), with the
reference's train-time flips and colour jitter on the card (``augment``,
default on), each slide's patches re-permuted every epoch, and the best
model by val loss from epoch 1 on (``:378``). Configs like
``ExampleConfigs/config_ffpe_train.json`` load verbatim; ``--quick 1`` caps
the patches per slide at 20 (``:495-497``).

Writes ``<checkpoint_path>/models/<flag>/{model_last,model_dict_best,
train_state}.pt`` and ``<checkpoint_path>/outputs/<flag>/<split>_output_
{last,best}.csv``; with ``--log 1`` also ``<summary_path>/<date>_<flag>/
metrics.jsonl``. ``histo_savescore`` and ``histo_extractfeatures`` serve
the ``.pt`` files as they are.

Keys beside the reference's: ``pretrained_path`` (a local torch ``.pt`` of
an ImageNet ResNet, read with ``pretrained: true``; nothing is downloaded),
``restore_path`` / ``model_path`` (warm start from a reference-keyed
``.pt``), ``remat`` and ``freeze_bn`` (``models/resnet.py``),
``quantize_trunk: "int8"`` (the frozen prefix through K3,
``cli/_common.py::quantize_trunk_training``), and the optimizer and early
stopping knobs of ``rna_train``. ``cache_patches_on_device`` is not ported
yet (ROADMAP.md, queue 1, item 11) and raises.

Usage: ``python -m multimodalbrainsurvival_torch.cli.histo_train --config
cfg.json [--device cpu]``
"""

from __future__ import annotations

import torch

from multimodalbrainsurvival_torch.cli._common import (
    build_datasets,
    build_mil_model,
    early_stop_kwargs,
    experiment_dirs,
    load_config,
    make_parser,
    make_writer,
    maybe_restore,
    quantize_trunk_training,
    tune_optimizer,
)
from multimodalbrainsurvival_torch.device import resolve_device
from multimodalbrainsurvival_torch.models import AggregationModel
from multimodalbrainsurvival_torch.models.convert import load_reference_state_dict
from multimodalbrainsurvival_torch.train import TrainSettings, train_model
from multimodalbrainsurvival_torch.train.adapters import MILAdapter
from multimodalbrainsurvival_torch.train.optim import (
    build_grouped_optimizer,
    mil_freeze_ladder,
)


def load_pretrained(model: AggregationModel, config) -> None:
    """ImageNet warm start of the encoder from ``pretrained_path``, a local
    torch ``.pt`` of a ResNet ``state_dict`` (torchvision keys, or the MIL
    model's ``resnet.``-prefixed ones), read when ``pretrained`` is true:
    the reference's model-zoo load (``resnet.py:366-376``) without the
    download. The ResNet's 1000-class head is dropped: the MIL model never
    calls it."""
    path = config.get("pretrained_path", "")
    if config.get("pretrained") and path:
        state = {k.removeprefix("resnet."): v
                 for k, v in load_reference_state_dict(path).items()}
        model.resnet.load_state_dict(
            {k: v for k, v in state.items() if not k.startswith("fc.")})
        print(f"Loaded pretrained ResNet weights from {path}")
    elif config.get("pretrained"):
        print("pretrained=true but no 'pretrained_path' given; using random init "
              "(nothing is downloaded)")


def main(argv=None):
    args = make_parser(__doc__).parse_args(argv)
    device = resolve_device(args.device)
    config, flag = load_config(args)
    save_dir, output_dir = experiment_dirs(config, flag)

    datasets = build_datasets(config, bool(args.quick))
    print("loaded datasets")
    torch.manual_seed(args.seed)
    model = build_mil_model(config)
    load_pretrained(model, config)
    maybe_restore(model, config, keys=("restore_path", "model_path"))
    model.to(device, memory_format=torch.channels_last)
    adapter = MILAdapter(
        model=model, device=device,
        loader_kwargs={"num_threads": int(config.get("num_workers", 8)) or 1},
        # `augment: false` turns off the train-time flips and colour jitter
        # (the reference hard-codes them, 2_HistoPath_train.py:474-481)
        augment=bool(config.get("augment", True)),
    )
    settings = TrainSettings(
        num_epochs=config.num_epochs,
        task=config.task,
        batch_size=config.batch_size,
        save_dir=save_dir,
        output_dir=output_dir,
        seed=args.seed,
        log_interval=config.log_interval,
        reference_parity=config.reference_parity,
        resume=bool(config.get("resume", False)),
        accumulate_steps=int(config.get("accumulate_steps", 1)),
        # the histo script alone keeps no best model at epoch 0
        # (2_HistoPath_train.py:378 `and epoch > 0`)
        best_from_epoch=1,
        **early_stop_kwargs(config),
    )
    adapter = quantize_trunk_training(config, adapter, datasets, settings.batch_size,
                                      args.seed)
    optimizer = tune_optimizer(
        build_grouped_optimizer(
            model, [("train", mil_freeze_ladder(config.n_layers_to_train),
                     float(config["lr"]))],
            config.weight_decay),
        config, len(datasets["train"]),
        num_epochs=settings.num_epochs, batch_size=settings.batch_size,
    )
    writer = make_writer(args.log, config, flag)
    try:
        train_model(adapter, datasets, optimizer, settings, writer=writer)
    finally:
        if writer is not None:
            writer.close()


if __name__ == "__main__":
    main()
