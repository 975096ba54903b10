"""RNA pipeline training CLI.

Parity with ``2_GeneExpression/1_GeneExpress_train.py`` and the JAX CLI
``multimodalbrainsurvival_tpu/cli/rna_train.py``: Cox training of the
12,778 → 4,096 → 2,048 MLP encoder + linear head in float32, with two Adam
parameter groups (``lr_rna`` for the encoder ``rna_mlp``, ``lr_mlp`` for
the head ``final_mlp``; ``:303-305``); configs like
``ExampleConfigs/config_rna_train.json`` are accepted verbatim. In train
mode both Dropout → Linear pairs run through the K2 kernels
(``kernels/dropout_matmul.py``).

Writes ``<checkpoint_path>/models/<flag>/{model_last,model_dict_best,
train_state}.pt`` and ``<checkpoint_path>/outputs/<flag>/<split>_output_
{last,best}.csv``; with ``--log 1`` also ``<summary_path>/<date>_<flag>/
metrics.jsonl``, the JAX CLI's tags and steps. A SIGTERM saves the full
train state to ``train_state.pt.preempt`` and exits with status 143;
``resume: true`` continues exactly.

Usage: ``python -m multimodalbrainsurvival_torch.cli.rna_train --config
cfg.json [--device cpu]``
"""

from __future__ import annotations

import torch

from multimodalbrainsurvival_torch.cli._common import (
    early_stop_kwargs,
    experiment_dirs,
    load_config,
    make_device_put,
    make_parser,
    make_writer,
    maybe_restore,
    observability_kwargs,
    quantize_mode,
    quantize_rna_serving,
    run_train,
    tune_optimizer,
)
from multimodalbrainsurvival_torch.config import Config
from multimodalbrainsurvival_torch.data import RNATableDataset
from multimodalbrainsurvival_torch.device import resolve_device
from multimodalbrainsurvival_torch.models import RNAEncoder, RNAOnlyModel
from multimodalbrainsurvival_torch.models.convert import load_reference_state_dict
from multimodalbrainsurvival_torch.models.rna import RNA_GENES
from multimodalbrainsurvival_torch.train import TrainSettings, train_model
from multimodalbrainsurvival_torch.train.adapters import TableAdapter
from multimodalbrainsurvival_torch.train.optim import build_grouped_optimizer


def build_rna_model(config: Config | None = None,
                    in_features: int = RNA_GENES) -> RNAOnlyModel:
    """12778 → 4096 → 2048 → 1 (the reference's widths; ``in_features`` is
    the CSV's ``rna_`` column count). ``dropout`` (default 0.5, the
    reference's ``nn.Dropout()``) is an extension of the JAX package that
    the cross-stack parity runs set to 0."""
    p = 0.5 if config is None else float(config.get("dropout", 0.5))
    return RNAOnlyModel(RNAEncoder(in_features, (4096, 2048), dropout=p))


def build_rna_datasets(config: Config) -> dict[str, RNATableDataset]:
    return {split: RNATableDataset(config[f"{split}_csv_path"])
            for split in ("train", "val", "test")}


def build_rna_optimizer(model: RNAOnlyModel, config: Config) -> torch.optim.Adam:
    return build_grouped_optimizer(
        model,
        [("rna", "rna_mlp.", float(config["lr_rna"])),
         ("mlp", "final_mlp.", float(config["lr_mlp"]))],
        config.weight_decay,
    )


def load_rna_model(config: Config, device: torch.device,
                   in_features: int) -> RNAOnlyModel:
    """The serving CLIs' model: ``model_path`` (a reference-keyed ``.pt``)
    on ``device``, in eval mode, float32."""
    model = build_rna_model(config, in_features)
    model.load_state_dict(load_reference_state_dict(config["model_path"]))
    return model.to(device).eval()


def rna_serving_adapter(config: Config, device: torch.device,
                        in_features: int) -> TableAdapter:
    """The serving CLIs' adapter: the float model, or with ``quantize:
    "int8"`` its int8 encoder (``quantize_rna_serving``)."""
    adapter = TableAdapter(model=load_rna_model(config, device, in_features),
                           device=device)
    return quantize_rna_serving(adapter) if quantize_mode(config) else adapter


def main(argv=None):
    args = make_parser(__doc__).parse_args(argv)
    device = resolve_device(args.device)
    config, flag = load_config(args)
    put, device, flag = make_device_put(config, device, flag)
    save_dir, output_dir = experiment_dirs(config, flag)

    datasets = build_rna_datasets(config)
    print("loaded datasets")
    torch.manual_seed(args.seed)
    model = build_rna_model(config, datasets["train"].feature_dim)
    maybe_restore(model, config, keys=("restore_path",))
    model.to(device)
    adapter = TableAdapter(model=model, device=device)
    settings = TrainSettings(
        num_epochs=1 if args.quick else config.num_epochs,
        task="survival_prediction",
        batch_size=config.batch_size,
        save_dir=save_dir,
        output_dir=output_dir,
        seed=args.seed,
        log_interval=config.log_interval,
        reference_parity=config.reference_parity,
        resume=bool(config.get("resume", False)),
        emergency_checkpoint=bool(config.get("emergency_checkpoint", True)),
        accumulate_steps=int(config.get("accumulate_steps", 1)),
        # parity: the reference weights the LOGGED running loss by the
        # batch's event count (1_GeneExpress_train.py:166-171)
        running_loss_weight="events" if config.reference_parity else "samples",
        **early_stop_kwargs(config),
        **observability_kwargs(config, save_dir),
        device_put_fn=put,
        preempt_sync_every=int(config.get("preempt_sync_every", 8)),
    )
    optimizer = tune_optimizer(
        build_rna_optimizer(model, config), config, len(datasets["train"]),
        num_epochs=settings.num_epochs, batch_size=settings.batch_size,
    )
    writer = make_writer(args.log, config, flag, put)
    try:
        run_train(train_model, adapter, datasets, optimizer, settings, writer=writer)
    finally:
        if writer is not None:
            writer.close()


if __name__ == "__main__":
    main()
