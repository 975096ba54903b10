"""Joint fusion training CLI: the patch bag and the RNA vector, end to end.

Parity with ``5_JointFusion/1_JointFusion_train.py`` and the JAX CLI
``multimodalbrainsurvival_tpu/cli/joint_train.py``: the ResNet's bag
embedding (mean over the real patches) beside the RNA MLP's, then
Dropout(0.8) → Linear(4096, 1) (``models/fusion.py::
BagHistopathologyRNAModel``), three Adam groups ``histo`` / ``rna`` /
``mlp`` at ``lr_histo`` / ``lr_rna`` / ``lr_mlp`` (``:413-416``), the
joint freeze ladder inside ``histo`` (``:386-401``: the first
``n_layers_to_train`` of ``resnet.fc`` (which the encoder does not hold),
``resnet.layer4``, …, ``resnet.conv1``; ``train/optim.py::JOINT_LADDER``),
the RNA encoder and the head always trained. The ResNet and the RNA
encoder compute in ``compute_dtype``, the head in float32. In train mode
the RNA encoder's two Dropout → Linear pairs (bf16 under ``compute_dtype:
"bfloat16"``) and the head's run through the K2 kernels; ``dropout``
overrides both the encoder's 0.5 and the head's 0.8. Configs like
``ExampleConfigs/config_joint_train.json`` load verbatim; ``--quick 1``
caps the patches per slide at 20 (``:357-359``).

Writes ``<checkpoint_path>/models/<flag>/{model_last,model_dict_best,
train_state}.pt`` and the per-slide ``<checkpoint_path>/outputs/<flag>/
<split>_output_{last,best}.csv``; ``joint_savescore`` serves the ``.pt``
files as they are. Keys beside the reference's, as ``histo_train`` reads
them: ``pretrained_path``, ``restore_path`` / ``model_path``, ``augment``,
``remat``, ``freeze_bn``, ``quantize_trunk: "int8"`` (the frozen ResNet
prefix through K3), ``resume``, the optimizer and early-stopping knobs;
a SIGTERM saves the full train state and exits with status 143.
``cache_patches_on_device: true`` holds the splits' patches and RNA
vectors on the card, and ``profile_steps`` / ``profile_dir`` /
``debug_checkify`` capture a trace or check each step, as in
``histo_train``.

Usage: ``python -m multimodalbrainsurvival_torch.cli.joint_train --config
cfg.json [--device cpu]``
"""

from __future__ import annotations

import torch

from multimodalbrainsurvival_torch.cli._common import (
    build_datasets,
    cache_datasets,
    early_stop_kwargs,
    experiment_dirs,
    load_config,
    make_device_put,
    make_parser,
    make_writer,
    maybe_restore,
    observability_kwargs,
    quantize_trunk_training,
    run_train,
    tune_optimizer,
)
from multimodalbrainsurvival_torch.cli.histo_train import load_pretrained
from multimodalbrainsurvival_torch.config import Config
from multimodalbrainsurvival_torch.data import PatchBagRNADataset
from multimodalbrainsurvival_torch.device import compute_dtype, resolve_device
from multimodalbrainsurvival_torch.models import (
    RESNET_CONSTRUCTORS,
    BagHistopathologyRNAModel,
    RNAEncoder,
)
from multimodalbrainsurvival_torch.models.rna import RNA_GENES
from multimodalbrainsurvival_torch.train import TrainSettings, train_model
from multimodalbrainsurvival_torch.train.adapters import JointAdapter
from multimodalbrainsurvival_torch.train.optim import (
    JOINT_LADDER,
    build_grouped_optimizer,
    path_prefix_match,
)


def build_joint_model(config: Config, fold_bn: bool = False,
                      in_features: int = RNA_GENES) -> BagHistopathologyRNAModel:
    """ResNet (``model_name``, no classifier) ⊕ RNA encoder (``in_features``
    → 4,096 → 2,048) → Dropout → Linear(·, ``num_classes``), in the
    config's ``compute_dtype``, with its ``remat`` and ``freeze_bn`` keys."""
    dtype = compute_dtype(config.compute_dtype)
    resnet = RESNET_CONSTRUCTORS[config.model_name](
        num_classes=None, dtype=dtype, fold_bn=fold_bn,
        freeze_bn=bool(config.get("freeze_bn", False)),
        remat=config.get("remat", False) or False,
    )
    # `dropout` overrides BOTH reference rates: the encoder's 0.5 and the
    # head's 0.8 (1_JointFusion_train.py:314-323)
    p = config.get("dropout", None)
    return BagHistopathologyRNAModel(
        resnet,
        RNAEncoder(in_features, (4096, 2048), dropout=0.5 if p is None else float(p),
                   dtype=dtype),
        head_dropout=0.8 if p is None else float(p),
        out_features=config.num_classes,
    )


def build_joint_datasets(config: Config, quick: bool) -> dict[str, PatchBagRNADataset]:
    return build_datasets(config, quick, PatchBagRNADataset)


def build_joint_optimizer(model: BagHistopathologyRNAModel,
                          config: Config) -> torch.optim.Adam:
    """The three groups (``:413-416``); the ladder's frozen parameters get
    ``requires_grad=False``."""
    ladder = JOINT_LADDER[: max(0, config.n_layers_to_train)]
    return build_grouped_optimizer(
        model,
        [("histo", path_prefix_match(*ladder), float(config["lr_histo"])),
         ("rna", "rna_mlp.", float(config["lr_rna"])),
         ("mlp", "final_mlp.", float(config["lr_mlp"]))],
        config.weight_decay,
    )


def main(argv=None):
    args = make_parser(__doc__).parse_args(argv)
    device = resolve_device(args.device)
    config, flag = load_config(args)
    put, device, flag = make_device_put(config, device, flag)
    save_dir, output_dir = experiment_dirs(config, flag)

    datasets = cache_datasets(config, build_joint_datasets(config, bool(args.quick)),
                              device, put)
    print("loaded datasets")
    torch.manual_seed(args.seed)
    model = build_joint_model(config, in_features=datasets["train"].rna_dim)
    load_pretrained(model, config)
    maybe_restore(model, config, keys=("restore_path", "model_path"))
    model.to(device, memory_format=torch.channels_last)
    adapter = JointAdapter(
        model=model, device=device,
        loader_kwargs={"num_threads": int(config.get("num_workers", 8)) or 1},
        augment=bool(config.get("augment", True)),
    )
    settings = TrainSettings(
        num_epochs=config.num_epochs,
        task=config.task,
        num_classes=config.num_classes,
        batch_size=config.batch_size,
        save_dir=save_dir,
        output_dir=output_dir,
        seed=args.seed,
        log_interval=config.log_interval,
        reference_parity=config.reference_parity,
        resume=bool(config.get("resume", False)),
        emergency_checkpoint=bool(config.get("emergency_checkpoint", True)),
        accumulate_steps=int(config.get("accumulate_steps", 1)),
        **early_stop_kwargs(config),
        **observability_kwargs(config, save_dir),
        device_put_fn=put,
        preempt_sync_every=int(config.get("preempt_sync_every", 8)),
    )
    adapter = quantize_trunk_training(config, adapter, datasets, settings.batch_size,
                                      args.seed, put)
    optimizer = tune_optimizer(
        build_joint_optimizer(model, config), config, len(datasets["train"]),
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
