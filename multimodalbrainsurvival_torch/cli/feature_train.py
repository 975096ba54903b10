"""Early-fusion training CLI.

Parity with ``3_EarlyFusion/2_EarlyFusion_train.py`` and the JAX CLI
``multimodalbrainsurvival_tpu/cli/feature_train.py``: Cox training of the
4,096 → 2,048 → 200 → 1 MLP (``models/fusion.py::EarlyFusionMLP``) over the
concatenated per-case features (the CSV's ``feature_`` columns), one Adam
group at ``lr`` (``config_feature_train.json``). Under ``reference_parity``
(the default) train and val are evaluated once before the first epoch
(logged as epoch -1) and the logged running loss is weighted by the
batch's event count, as the reference script does. In train mode the three
Dropout → Linear pairs run through the K2 kernels
(``kernels/dropout_matmul.py``); ``dropout`` (default 0.5) sets their rate.

Writes ``<checkpoint_path>/models/<flag>/{model_last,model_dict_best,
train_state}.pt`` and ``<checkpoint_path>/outputs/<flag>/<split>_output_
{last,best}.csv``; ``--quick 1`` trains one epoch. A SIGTERM saves the full
train state to ``train_state.pt.preempt`` and exits with status 143;
``resume: true`` continues exactly.

Usage: ``python -m multimodalbrainsurvival_torch.cli.feature_train --config
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
    run_train,
    tune_optimizer,
)
from multimodalbrainsurvival_torch.config import Config
from multimodalbrainsurvival_torch.data import FeatureTableDataset
from multimodalbrainsurvival_torch.device import resolve_device
from multimodalbrainsurvival_torch.models import EarlyFusionMLP
from multimodalbrainsurvival_torch.train import TrainSettings, train_model
from multimodalbrainsurvival_torch.train.adapters import TableAdapter
from multimodalbrainsurvival_torch.train.optim import build_grouped_optimizer


def build_feature_model(config: Config | None = None,
                        in_features: int = 4096) -> EarlyFusionMLP:
    """4096 → 2048 → 200 → 1 (``in_features``: the CSV's ``feature_``
    column count); ``dropout`` (default 0.5, the reference's
    ``nn.Dropout()``) is the JAX package's extension."""
    p = 0.5 if config is None else float(config.get("dropout", 0.5))
    return EarlyFusionMLP(in_features, (2048, 200), dropout=p)


def build_feature_datasets(config: Config) -> dict[str, FeatureTableDataset]:
    return {split: FeatureTableDataset(config[f"{split}_csv_path"])
            for split in ("train", "val", "test")}


def main(argv=None):
    args = make_parser(__doc__).parse_args(argv)
    device = resolve_device(args.device)
    config, flag = load_config(args)
    put, device, flag = make_device_put(config, device, flag)
    save_dir, output_dir = experiment_dirs(config, flag)

    datasets = build_feature_datasets(config)
    torch.manual_seed(args.seed)
    model = build_feature_model(config, datasets["train"].feature_dim)
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
        # parity: the printed trace starts with an epoch -1 eval
        # (2_EarlyFusion_train.py:311-312), and the LOGGED running loss is
        # weighted by the batch's event count (:161-166)
        pre_training_eval=config.reference_parity,
        running_loss_weight="events" if config.reference_parity else "samples",
        **early_stop_kwargs(config),
        **observability_kwargs(config, save_dir),
        device_put_fn=put,
        preempt_sync_every=int(config.get("preempt_sync_every", 8)),
    )
    optimizer = tune_optimizer(
        build_grouped_optimizer(model, [("all", "", float(config["lr"]))],
                                config.weight_decay),
        config, len(datasets["train"]),
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
