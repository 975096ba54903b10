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
``<checkpoint_path>/outputs/<flag>/``. The train CLIs call ``train_model``
through ``run_train``: a SIGTERM saves the full state to
``train_state.pt.preempt`` and the CLI exits with status 143
(``PREEMPTED_EXIT_CODE``); the same command with ``resume: true``
continues exactly.

``mesh: {"dp": D, "mp": M, "shard_bag": bool, "distributed": bool}`` runs
the train CLIs and ``histo_extractfeatures`` data- and bag-parallel over
``D x M`` processes, one per device, started by ``python -m
torch.distributed.run --nproc_per_node N -m
multimodalbrainsurvival_torch.cli.<name> --config cfg.json``
(``make_device_put``, ``parallel/mesh.py``); the world must be ``D x M``
processes. Rank 0 alone writes frames, checkpoints and the metric log.
``distributed: true`` needs a ``flag`` (the JAX rule for multi-host runs);
without it a mesh run takes rank 0's timestamp flag, so every rank writes
under one ``save_dir``. The other entry points that place batches over the
mesh are the ``slide_*`` CLIs, ``cv_run`` and ``sweep``; under a mesh the
int8 calibrations run on rank 0 and every rank takes its qtree
(``rank_zero_tree``). The single-device serving CLIs (``histo_savescore``,
``rna_savescore``, ``rna_extractfeatures``, ``feature_savescore``,
``joint_savescore``, ``export_model``) ignore ``mesh``, as their JAX twins
do; started in a world of several ranks, rank 0 serves and the others wait
for it (``single_device_serving``).
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import itertools
import os
import sys

import numpy as np
import torch

from multimodalbrainsurvival_torch.config import Config
from multimodalbrainsurvival_torch.data import PatchBagDataset
from multimodalbrainsurvival_torch.data.device_cache import (
    DEFAULT_MAX_BYTES,
    maybe_cache_datasets,
)
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
    quantize_rna_encoder,
    quantize_trunk_for_training,
)
from multimodalbrainsurvival_torch.parallel.mesh import (
    BatchPut,
    batch_device_put,
    initialize_from_env,
    make_mesh,
    whole_patch_bag,
    world_barrier,
    world_rank,
)
from multimodalbrainsurvival_torch.train import TrainingPreempted
from multimodalbrainsurvival_torch.train.adapters import (
    JointAdapter,
    MILAdapter,
    QuantizedJointAdapter,
    QuantizedMILAdapter,
    QuantizedTableAdapter,
    QuantTrunkJointAdapter,
    QuantTrunkMILAdapter,
    TableAdapter,
)
from multimodalbrainsurvival_torch.train.optim import (
    TrainOptimizer,
    relative_lr_schedule,
    wrap_optimizer,
)
from multimodalbrainsurvival_torch.utils.logging import MetricWriter


def make_parser(description: str, device: bool = True) -> argparse.ArgumentParser:
    """The reference scripts' flags; ``device=False`` for a CLI that does no
    device work (``validate_data``), which then takes no ``--device``."""
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
    if device:
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
    if (config.get("mesh") or {}).get("distributed") and not config.get("flag"):
        raise SystemExit("distributed runs need an explicit 'flag' in the config "
                         "(the timestamp fallback differs across hosts)")
    flag = config.get("flag", "") or "train_{date:%Y-%m-%d_%H:%M:%S}".format(
        date=datetime.datetime.now()
    )
    return config, flag


def make_device_put(config: Config, device: torch.device, flag: str
                    ) -> tuple[BatchPut | None, torch.device, str]:
    """``(put, device, flag)`` of the config's ``mesh`` (JAX
    ``cli/_common.py:267-302``): the process group joined from the
    launcher's variables, the ``dp x mp`` mesh over it (raising, with the
    launcher command, where the world has another size), the rank's device
    and, for a run without ``distributed``, rank 0's flag. Without a mesh,
    or for a mesh of one device, ``(None, device, flag)``."""
    spec = config.get("mesh") or {}
    if not spec:
        return None, device, flag
    initialize_from_env(device)
    mesh = make_mesh(int(spec.get("dp", 0)) or None, int(spec.get("mp", 1)), device=device)
    put = batch_device_put(mesh, shard_bag=bool(spec.get("shard_bag", False)))
    if put is None:
        return None, device, flag
    if not spec.get("distributed"):
        flag = mesh.broadcast_object(flag)
    print(f"rank {mesh.rank}: mesh {mesh.shape}"
          + (" with the bag sharded over mp" if put.shard_bag else "")
          + f" over {mesh.backend}, on {mesh.device}", flush=True)
    return put, mesh.device, flag


@contextlib.contextmanager
def single_device_serving(device: torch.device):
    """The single-device serving CLIs' world rule: they serve on one device
    whatever ``mesh`` says, as their JAX twins do, so in a
    ``torch.distributed`` world of more than one rank (the launcher's, or
    one that ``cv_run`` runs them in) rank 0 serves and the other ranks wait
    for it at a barrier: no two ranks write one frame. Yields whether this
    process serves (True without a world)."""
    initialize_from_env(device)
    rank = world_rank()
    if rank is None:
        yield True
        return
    try:
        yield rank == 0
    finally:
        world_barrier(device)


def rank_zero_tree(put: BatchPut | None, make, device: torch.device):
    """``make()`` (an int8 calibration's tree of tensors) made on rank 0 of
    ``put``'s mesh and sent to every rank, on ``device``: each rank's float
    pass could round an abs-max otherwise, and the ranks would serve or
    train with other scales. Without a placement, ``make()``."""
    if put is None:
        return make()
    return put.mesh.broadcast_tree(make() if put.mesh.rank == 0 else None, device)


def experiment_dirs(config: Config, flag: str) -> tuple[str, str]:
    """``(<checkpoint_path>/models/<flag>, <checkpoint_path>/outputs/<flag>)``,
    the first created."""
    checkpoint_path = config.get("checkpoint_path", "checkpoints/")
    save_dir = os.path.join(checkpoint_path, "models", flag)
    output_dir = os.path.join(checkpoint_path, "outputs", flag)
    os.makedirs(save_dir, exist_ok=True)
    return save_dir, output_dir


def make_writer(log: bool, config: Config, flag: str,
                put: BatchPut | None = None) -> MetricWriter | None:
    """A ``MetricWriter`` on ``<summary_path>/<date>_<flag>/`` that has
    logged the config, or None without ``--log`` or on a rank other than 0
    of a mesh run (the JAX ``make_writer``; ``summary_path`` defaults to
    ``<checkpoint_path>/summary`` as at the JAX ``cli/_common.py:106``)."""
    if not log or (put is not None and put.mesh.rank != 0):
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


#: Exit status of a preempted train run (128 + SIGTERM, the shell's
#: convention): a scheduler keyed on exit codes must not take an unfinished
#: run for a finished one.
PREEMPTED_EXIT_CODE = 143


def run_train(train_model_fn, *args, **kwargs):
    """``train_model_fn(*args, **kwargs)``, with a preemption turned into
    an orderly exit with status ``PREEMPTED_EXIT_CODE`` (JAX
    ``cli/_common.py:158-181``): the loop has already saved the full state,
    and the writer, if any, is closed here, since the exit skips the
    caller's own close."""
    try:
        return train_model_fn(*args, **kwargs)
    except TrainingPreempted as e:
        print(f"exiting after preemption (status {PREEMPTED_EXIT_CODE}): {e}",
              flush=True)
        writer = kwargs.get("writer")
        if writer is not None:
            writer.close()
        sys.exit(PREEMPTED_EXIT_CODE)


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


def observability_kwargs(config: Config, save_dir: str) -> dict:
    """TrainSettings kwargs of the trace and step-checking keys (JAX
    ``cli/_common.py:232-255``): ``profile_steps`` (a ``torch.profiler``
    trace, CPU and CUDA, of that many train steps after warmup),
    ``profile_dir`` (where it lands; ``<save_dir>/torch_trace`` by default)
    and ``debug_checkify`` (each step under autograd's anomaly mode, its
    loss checked: a NaN raises naming where it came from)."""
    return {
        "profile_steps": int(config.get("profile_steps", 0)),
        "profile_dir": str(config.get("profile_dir", "")
                           or os.path.join(save_dir, "torch_trace")),
        "debug_checkify": bool(config.get("debug_checkify", False)),
    }


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
    or ``"int8"`` (W8A8 ResNet and RNA MLP, ``models/quantize.py``). For a
    ResNet int8 implies ``fold_bn``: the int8 weights are built from the
    folded kernels."""
    quant = str(config.get("quantize", "") or "").lower()
    if quant not in ("", "int8"):
        raise ValueError(f"unsupported quantize mode: {quant!r}")
    return quant


def build_mil_model(config, fold_bn: bool = False) -> AggregationModel:
    """The config's MIL model: ResNet encoder (without its classifier) →
    aggregator (the transformer's MLP width ``aggregator_hdim`` and depth
    ``transformer_layers``) → ``num_classes`` head, in the config's
    ``compute_dtype``, with its ``remat`` and ``freeze_bn`` training keys."""
    dtype = compute_dtype(config.compute_dtype)
    resnet = RESNET_CONSTRUCTORS[config.model_name](
        num_classes=None, dtype=dtype, fold_bn=fold_bn,
        freeze_bn=bool(config.get("freeze_bn", False)),
        remat=config.get("remat", False) or False,
    )
    aggregator = make_aggregator(
        config.aggregator, dim=resnet.feature_dim, hdim=config.aggregator_hdim,
        transformer_layers=int(config.get("transformer_layers", 2)), dtype=dtype)
    return AggregationModel(resnet, aggregator, out_features=config.num_classes)


def build_datasets(config, quick: bool, dataset_cls: type = PatchBagDataset
                   ) -> dict[str, PatchBagDataset]:
    """The three splits' patch-bag datasets (``dataset_cls``: the joint
    CLIs' ``PatchBagRNADataset`` adds each case's RNA vector); ``--quick``
    caps the patches per slide at 20."""
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
        "train": dataset_cls(
            csv_path=config["train_csv_path"],
            bag_size=config.get("train_bag_size", 1),
            max_patches_total=max_train, **common,
        ),
        "val": dataset_cls(
            csv_path=config["val_csv_path"],
            bag_size=config.get("val_bag_size", 1),
            max_patches_total=max_val, **common,
        ),
        "test": dataset_cls(
            csv_path=config["test_csv_path"],
            bag_size=config.get("val_bag_size", 1),
            max_patches_total=max_val, **common,
        ),
    }


def cache_datasets(config: Config, datasets: dict, device: torch.device,
                   put: BatchPut | None = None) -> dict:
    """With ``cache_patches_on_device: true`` the train CLIs' splits held on
    ``device`` under one budget of ``cache_max_bytes_per_device`` a rank
    (12 GiB by default), block-sharded over ``put``'s mesh
    (``data/device_cache.py``), as the JAX ``cli/histo_train.py:133-143``
    and ``cli/joint_train.py:115-125`` hold them; else as they are."""
    return maybe_cache_datasets(
        datasets, bool(config.get("cache_patches_on_device", False)), device=device,
        max_bytes=int(config.get("cache_max_bytes_per_device", DEFAULT_MAX_BYTES)),
        num_threads=int(config.get("num_workers", 8)) or 1, put=put)


def load_mil_model(config: Config, device: torch.device,
                   build=build_mil_model) -> torch.nn.Module:
    """Build the MIL model (or the model ``build(config, fold_bn=...)``
    makes: the joint CLIs'), load ``model_path`` (a reference-keyed
    ``.pt``), fold BatchNorm when ``fold_bn: true`` or ``quantize:
    "int8"``, and place it on ``device`` in eval mode with ``channels_last``
    convolution weights. Checkpoints are always stored unfolded."""
    fold = bool(config.get("fold_bn", False)) or bool(quantize_mode(config))
    state = load_reference_state_dict(config["model_path"])
    model = build(config)
    model.load_state_dict(state)
    if fold:
        model = build(config, fold_bn=True)
        model.load_state_dict(fold_resnet_state_dict(state))
        print("folded BatchNorm into conv weights for serving")
    return model.to(device, memory_format=torch.channels_last).eval()


def quantize_serving(config: Config, adapter: MILAdapter, probe,
                     put: BatchPut | None = None) -> QuantizedMILAdapter:
    """Swap a float MIL or joint serving adapter for the int8 (W8A8) one:
    calibrate the activation ranges on the batch ``probe()`` reads and
    quantize the folded ResNet weights (on rank 0 of ``put``'s mesh, the
    qtree sent to every rank); for the joint model also the RNA encoder
    (``quantize_rna_encoder``, dynamic activation scales: nothing to
    calibrate). Deviates from reference numerics by int8 rounding
    (per-sample embedding cosine > 0.995), opt-in for that reason."""
    qtree = rank_zero_tree(put, lambda: quantize_mil_resnet(
        adapter.model.resnet, [probe()["patch_bag"]], arch=config.model_name),
        adapter.device)
    common = dict(model=adapter.model, device=adapter.device,
                  loader_kwargs=adapter.loader_kwargs, qtree=qtree,
                  arch=config.model_name)
    if isinstance(adapter, JointAdapter):
        print("quantized ResNet + RNA encoder to int8 (W8A8) for serving")
        return QuantizedJointAdapter(qtree_rna=quantize_rna_encoder(adapter.model.rna_mlp),
                                     **common)
    print("quantized ResNet to int8 (W8A8) for serving")
    return QuantizedMILAdapter(**common)


def quantize_rna_serving(adapter: TableAdapter) -> QuantizedTableAdapter:
    """Swap the float RNA serving adapter for the int8 (W8A8) one (JAX
    ``cli/_common.py:388-413``): the encoder's Linear layers quantized, the
    activation scales dynamic per row (nothing to calibrate), the Cox head
    float. Opt-in (``quantize: "int8"``), as for the ResNet paths."""
    print("quantized RNA encoder to int8 (W8A8) for serving")
    return QuantizedTableAdapter(model=adapter.model, device=adapter.device,
                                 loader_kwargs=adapter.loader_kwargs,
                                 qtree=quantize_rna_encoder(adapter.model.rna_mlp))


def serving_adapter(config: Config, device: torch.device, datasets: dict,
                    build=build_mil_model, adapter_cls: type = MILAdapter,
                    put: BatchPut | None = None) -> MILAdapter:
    """The serving CLIs' adapter: the float model (``build``'s, MIL by
    default, in ``adapter_cls``), or with ``quantize: "int8"`` its int8
    encoders, the ResNet's calibrated on the first train batch (by rank 0
    of ``put``'s mesh)."""
    adapter = adapter_cls(
        model=load_mil_model(config, device, build),
        device=device,
        loader_kwargs={"num_threads": int(config.get("num_workers", 8)) or 1},
    )
    if not quantize_mode(config):
        return adapter

    def probe():
        batches = datasets["train"].batches(config.batch_size, **adapter.loader_kwargs)
        try:
            return next(batches)
        finally:
            batches.close()

    return quantize_serving(config, adapter, probe, put)


def quantize_trunk_training(config: Config, adapter: MILAdapter, datasets: dict,
                            batch_size: int, seed: int,
                            put: BatchPut | None = None) -> MILAdapter:
    """With ``quantize_trunk: "int8"``, swap a float MIL or joint training
    adapter for the int8 frozen-trunk one (JAX ``cli/_common.py:416-496``).

    Both freeze ladders train the first ``n_layers_to_train`` of ``fc,
    layer4, …``, so the stem and ``min(4, 5 - max(n, 1))`` residual stages
    below them run forward-only every step; that prefix is folded,
    calibrated and quantized once, here, on the JAX CLI's calibration set:
    its probe batch (the first train batch) and the first two train
    batches. Under ``put``'s mesh rank 0 calibrates and every rank takes its
    qtree, so every rank trains one model. Without the key the adapter is
    returned as it is."""
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

    # every rank reads them: the mesh-sharded cache's batches are collective
    batches = datasets["train"].batches(batch_size, **adapter.loader_kwargs)
    try:
        first_two = [whole_patch_bag(b, put) for b in itertools.islice(batches, 2)]
    finally:
        batches.close()
    qtree = rank_zero_tree(put, lambda: quantize_trunk_for_training(
        adapter.model.resnet, first_two[:1] + first_two, arch=config.model_name,
        augment=adapter.augment, seed=seed), adapter.device)
    print(f"quantize_trunk: int8 frozen prefix = stem + {trunk_stages} stage(s); "
          "the trainable tail stays float")
    cls = QuantTrunkJointAdapter if isinstance(adapter, JointAdapter) else QuantTrunkMILAdapter
    return cls(
        model=adapter.model, device=adapter.device,
        loader_kwargs=adapter.loader_kwargs, augment=adapter.augment,
        qtree=qtree, trunk_stages=trunk_stages, arch=config.model_name,
    )
