"""Data and bag parallelism of the patch CLIs (``histo_train``,
``joint_train``, ``histo_extractfeatures``) in gloo worlds of 2 processes
on the CPU, against the port's world-of-one runs and, without dropout and
augmentation, against the JAX package on a virtual mesh of the same shape.
This module runs the histo jobs, ``tests/test_torch_parallel_joint.py``
the joint ones, each in a world of its own, on this module's cohort.

A world runs its module's jobs in order (``_torch_parallel_worker.py``):
the two train CLIs under ``mesh: {"dp": 2}`` and ``{"dp": 1, "mp": 2,
"shard_bag": true}`` with augmentation on (``histo_train`` with BatchNorm
in train mode, synced over the ranks with distinct patches; ``joint_train``
with its dropout at 0.5 and its BatchNorm statistics held, ``freeze_bn``),
both again with augmentation and dropout off, and ``histo_extractfeatures``
under ``{"dp": 2}``. The cohort is tiny (ResNet-18, 16-px patches that
differ in colour, gradient and noise, 4 cases of bags of 2, batches of 4).
The world-of-one runs, the witness and the JAX steps are made in the test
process while the world works.

Tolerances: the loss at ``rtol=1e-5``, gradients at the JAX test's
``rtol=1e-4, atol=1e-5 x`` the largest gradient, compared before Adam's
step (for train-mode BatchNorm with the absolute part raised to a measured
rounding floor: ``test_first_step_and_bn_statistics_match_the_world_of_one``
says why); the synced running statistics after the epoch at ``rtol=1e-4,
atol=1e-6``; the extracted features at ``rtol=1e-5, atol=1e-6``.
"""

import json
import os
import shutil

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from multimodalbrainsurvival_torch.cli import histo_extractfeatures
from multimodalbrainsurvival_torch.cli._common import build_datasets, build_mil_model
from multimodalbrainsurvival_torch.cli.joint_train import build_joint_model
from multimodalbrainsurvival_torch.config import Config
from multimodalbrainsurvival_torch.models.convert import flax_mil_to_torch
from tests import _torch_parallel_worker as worker
from tests.test_torch_parallel_rna import _assert_grads_close, _write_json

IMG, GENES, SEED = 16, 16, 1111
WSIS = [f"P{i}" for i in range(4)]
DP = {"dp": 2}
BAG = {"dp": 1, "mp": 2, "shard_bag": True}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _patches(root, wsi, n, seed):
    """``make_patch_dir``'s layout with patches that differ in colour,
    gradient and noise (uniform noise patches give a deep BatchNorm nearly
    equal inputs, whose normalization then amplifies rounding)."""
    d = os.path.join(root, wsi)
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:IMG, 0:IMG] / IMG
    with open(os.path.join(d, "loc.txt"), "w") as loc:
        loc.write(f"slide_id {wsi}\nid x y patch_level patch_size_read patch_size_output\n")
        for j in range(n):
            slope = rng.uniform(-120, 120, (2, 3))
            img = (rng.uniform(0, 255, 3) + yy[..., None] * slope[0] + xx[..., None] * slope[1]
                   + rng.normal(0, rng.uniform(5, 40), (IMG, IMG, 3)))
            cv2.imwrite(os.path.join(d, f"{wsi}_patch_{j}.png"),
                        np.clip(img, 0, 255).astype(np.uint8)[:, :, ::-1])
            loc.write(f"{j} {j * IMG} 0 0 {IMG} {IMG}\n")


def _cohort(tmp):
    root = str(tmp / "patches")
    for i, w in enumerate(WSIS):
        _patches(root, w, 4, seed=60 + i)
    rng = np.random.default_rng(9)
    df = pd.DataFrame({"case": [f"c{i}" for i in range(4)],
                       "survival_months": rng.uniform(1, 120, 4).round(4),
                       "vital_status": [1, 0, 1, 1],
                       "wsi_file_name": [f"{w}.svs" for w in WSIS]})
    for g in range(GENES):
        df[f"rna_{g}"] = rng.normal(size=4).astype(np.float32)
    df.to_csv(tmp / "cohort.csv", index=False)


def _config(tmp, name, **overrides):
    cfg = {
        "model_name": "resnet18", "num_classes": 1, "batch_size": 4, "img_size": IMG,
        "data_path": str(tmp / "patches"), "train_csv_path": str(tmp / "cohort.csv"),
        "val_csv_path": str(tmp / "cohort.csv"), "test_csv_path": str(tmp / "cohort.csv"),
        "num_workers": 1, "num_epochs": 1, "train_bag_size": 2, "val_bag_size": 2,
        "max_patch_per_wsi_train": 4, "max_patch_per_wsi_val": 2,
        "aggregator": "attention", "aggregator_hdim": 512,
        "task": "survival_prediction", "flag": name, "n_layers_to_train": 3,
        "lr": 1e-5, "lr_histo": 1e-5, "lr_rna": 1e-5, "lr_mlp": 1e-5,
        "weight_decay": 1e-4, "augment": True, "dropout": 0.5, "log_interval": 1,
        "checkpoint_path": str(tmp / "out") + "/", "output_path": str(tmp / name),
        "restore_path": "",
        "model_path": str(tmp / ("joint.pt" if name.startswith("joint") else "mil.pt")),
    }
    cfg.update(overrides)
    return _write_json(tmp / f"{name}.json", cfg)


def _argv(cfg):
    return ["--config", cfg, "--device", "cpu", "--seed", str(SEED)]


#: the world's jobs: name → (cli, config overrides)
JOBS = {
    "histo_dp": ("histo_train", {"mesh": DP}),
    "histo_bag": ("histo_train", {"mesh": BAG}),
    "histo_plain_dp": ("histo_train", {"mesh": DP, "augment": False}),
    "histo_plain_bag": ("histo_train", {"mesh": BAG, "augment": False}),
    "joint_dp": ("joint_train", {"mesh": DP, "freeze_bn": True}),
    "joint_bag": ("joint_train", {"mesh": BAG, "freeze_bn": True}),
    "joint_plain_dp": ("joint_train", {"mesh": DP, "augment": False, "dropout": 0.0}),
    "extract_dp": ("histo_extractfeatures", {"mesh": DP}),
}


def _initial_weights(tmp, name="histo_dp"):
    cfg = Config(json.loads((tmp / f"{name}.json").read_text()))
    torch.manual_seed(11)
    state = build_mil_model(cfg).state_dict()
    state["aggregator.vector"] = torch.tensor(
        np.random.default_rng(3).normal(0.0, 0.2, 512), dtype=torch.float32)
    torch.save(state, str(tmp / "mil.pt"))
    torch.manual_seed(12)
    torch.save(build_joint_model(cfg, in_features=GENES).state_dict(), str(tmp / "joint.pt"))


#: this module's jobs; ``tests/test_torch_parallel_joint.py`` runs the rest
HISTO = ("histo_dp", "histo_bag", "histo_plain_dp", "histo_plain_bag", "extract_dp")


def run_world(tmp_path_factory, names, references):
    """The cohort, the configs of ``names`` and a world of 2 that runs them,
    ``references(directory)`` meanwhile in this process (a fixture's
    generator: yields the directory, removes it after)."""
    tmp = tmp_path_factory.mktemp(f"parallel_{names[0]}")
    _cohort(tmp)
    jobs = []
    for name in names:
        cli, overrides = JOBS[name]
        jobs.append({"cli": cli, "argv": _argv(_config(tmp, name, **overrides)),
                     "grads": str(tmp / f"{name}.grads.pt")})
    _initial_weights(tmp, names[0])
    out = tmp / "codes"
    out.mkdir()
    results, _ = worker.run_world(2, _write_json(tmp / "jobs.json", jobs), str(out),
                                  str(tmp / "logs"), lambda: references(tmp))
    for rank, (code, log) in enumerate(results):
        assert code == 0, f"rank {rank} exited {code}:\n{log[-3000:]}"
    codes = [json.loads((out / f"codes{r}.json").read_text()) for r in range(2)]
    for name, pair in zip(names, zip(*codes)):
        assert pair == (0, 0), (name, pair)
    yield tmp
    # a suite run keeps its temporary files on one disk
    shutil.rmtree(tmp, ignore_errors=True)


def _references(tmp):
    _world_of_one(tmp, "histo_dp")
    _witness(tmp, "histo_dp")
    for name in ("histo_plain_dp", "histo_plain_bag"):
        _jax_histo(tmp, name)
    _extract_world_of_one(tmp)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    yield from run_world(tmp_path_factory, HISTO, _references)


_WORLD_OF_ONE: dict = {}


def _world_of_one(tmp, name, tag="w1", **overrides):
    """``name``'s run in this process, without its mesh → (first-step
    record, its flag); one run per configuration (``histo_dp`` and
    ``histo_bag`` differ in their mesh alone)."""
    cli = JOBS[name][0]
    settings = {**JOBS[name][1], "mesh": {}, **overrides}
    key = (str(tmp), cli, tag, json.dumps(settings, sort_keys=True))
    if key not in _WORLD_OF_ONE:
        flag = f"{name}_{tag}"
        record = {}
        assert worker.run_cli(cli, _argv(_config(tmp, flag, **settings)), record) == 0
        _WORLD_OF_ONE[key] = (record, flag)
    return _WORLD_OF_ONE[key]


def _running_stats(path):
    state = torch.load(str(path), weights_only=True)
    return {k: v for k, v in state.items() if "running" in k}


def _witness(tmp, name):
    """The world-of-one run with its BatchNorm in the synced arithmetic
    (``worker.synced_statistics``): the distance of its gradients from the
    plain world-of-one run's is the rounding floor of the comparison."""
    with worker.synced_statistics():
        return _world_of_one(tmp, name, tag="witness")[0]


@pytest.mark.parametrize("name", ["histo_dp", "histo_bag"])
def test_first_step_and_bn_statistics_match_the_world_of_one(world, name):
    """First-step loss and gradients (augmentation drawn for the global
    batch on every rank; the joint model's dropout masks at the rank's
    rows), and after the epoch the synced BatchNorm running statistics,
    equal the port's one-process run.

    The histo runs train BatchNorm on the batch: its statistics over 8
    patches, at 1x1 in layer4, make the ResNet's gradients and features
    move by ~1e-5 of the largest gradient when only the order of the
    statistics' sums changes (the witness, measured here), the JAX
    tolerance's own absolute scale. So their absolute tolerance is the
    larger of the JAX one and twice the witness's largest distance; a
    wrong reduction moves them by orders of magnitude more. The joint runs
    hold the ResNet's statistics (``freeze_bn``) and meet the JAX tolerance
    with a wide margin."""
    check_first_step(world, name)


def check_first_step(world, name):
    """``test_first_step_and_bn_statistics_match_the_world_of_one``'s body."""
    got = torch.load(str(world / f"{name}.grads.pt"))
    want, flag = _world_of_one(world, name)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    floor = 0.0
    if name.startswith("histo"):
        witness = _witness(world, name)["grads"]
        floor = 2 * max(float((witness[k] - want["grads"][k]).abs().max()) for k in witness)
    _assert_grads_close(got["grads"], want["grads"], floor)
    mine = _running_stats(world / "out" / "models" / name / "model_last.pt")
    ref = _running_stats(world / "out" / "models" / flag / "model_last.pt")
    for k in ref:
        np.testing.assert_allclose(mine[k].numpy(), ref[k].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def _first_batch(tmp, name, dataset_cls=None):
    cfg = Config(json.loads((tmp / f"{name}.json").read_text()))
    ds = build_datasets(cfg, False, *(() if dataset_cls is None else (dataset_cls,)))["train"]
    ds.shuffle()
    return next(ds.batches(4, shuffle=True, seed=SEED, num_threads=1))


def _jax_inputs(batch):
    from multimodalbrainsurvival_tpu.ops.image import preprocess_patches

    return preprocess_patches(jnp.asarray(batch["patch_bag"]), train=False)


def _jax_step(model, variables, args, batch, mesh=DP):
    """The JAX loss and gradients of a train-mode step with the batch placed
    on a virtual mesh of ``mesh``'s shape."""
    from multimodalbrainsurvival_tpu.ops.cox import cox_partial_likelihood_loss
    from multimodalbrainsurvival_tpu.parallel import batch_device_put, make_mesh

    put = batch_device_put(make_mesh(dp=mesh["dp"], mp=mesh.get("mp", 1)),
                           shard_bag=mesh.get("shard_bag", False))
    arrays = put({"patch_bag": _jax_inputs(batch), **{k: jnp.asarray(batch[k]) for k in (
        "bag_mask", "sample_mask", "survival_months", "vital_status", *args)}})

    def loss_fn(p, a):
        out, _ = model.apply({"params": p, "batch_stats": variables["batch_stats"]},
                             a["patch_bag"], *(a[k] for k in args), mask=a["bag_mask"],
                             train=True, mutable=["batch_stats"])
        out = out[0] if isinstance(out, tuple) else out
        return cox_partial_likelihood_loss(out[:, 0], a["survival_months"],
                                           a["vital_status"], a["sample_mask"])

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"], arrays)
    return float(loss), jax.tree.map(np.asarray, grads)


_JAX: dict = {}


def _jax_histo(tmp, name) -> tuple[float, dict]:
    """``_jax_step`` of ``name``'s MIL model and first batch (made once)."""
    from multimodalbrainsurvival_tpu.cli.histo_train import build_mil_model as jax_build
    from multimodalbrainsurvival_tpu.config import Config as JaxConfig
    from multimodalbrainsurvival_tpu.models.convert import torch_mil_to_flax

    key = (str(tmp), name)
    if key not in _JAX:
        cfg = json.loads((tmp / f"{name}.json").read_text())
        state = {k: v.numpy() for k, v in torch.load(str(tmp / "mil.pt")).items()}
        loss, grads = _jax_step(jax_build(JaxConfig(cfg)), torch_mil_to_flax(state), (),
                                _first_batch(tmp, name), cfg["mesh"])
        _JAX[key] = (loss, flax_mil_to_torch(grads))
    return _JAX[key]


@pytest.mark.parametrize("name", ["histo_plain_dp", "histo_plain_bag"])
def test_histo_without_augmentation_matches_jax(world, name):
    got = torch.load(str(world / f"{name}.grads.pt"))
    loss, want = _jax_histo(world, name)
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
    _assert_grads_close(got["grads"], {k: want[k] for k in got["grads"]})


def _extract_world_of_one(tmp) -> None:
    """``extract_dp``'s frames in this process, without a mesh (made once)."""
    if not (tmp / "extract_w1").exists():
        histo_extractfeatures.main(_argv(_config(tmp, "extract_w1")))


def test_extract_under_dp_writes_the_world_of_one_frames(world):
    _extract_world_of_one(world)
    for split in ("train", "val", "test"):
        a = np.loadtxt(world / "extract_dp" / f"pathology_features_{split}.csv", delimiter=",")
        b = np.loadtxt(world / "extract_w1" / f"pathology_features_{split}.csv", delimiter=",")
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        assert ((world / "extract_dp" / f"pathology_cases_{split}.csv").read_text()
                == (world / "extract_w1" / f"pathology_cases_{split}.csv").read_text())
