"""The int8 and folded paths under a mesh, and the single-device serving
CLIs' world rule, in a gloo world of 2 processes on the CPU.

One world runs this module's jobs in order (``_torch_parallel_worker.py``)
on ``tests/test_torch_parallel_histo.py``'s cohort: ``histo_extractfeatures``
with ``quantize: "int8"`` (K3's plain version) under ``{"dp": 2}`` and
under ``{"dp": 1, "mp": 2, "shard_bag": true}``, with ``fold_bn: true`` on
a ResNet-50 (K4's plain version) under ``{"dp": 2}``, ``histo_train`` and
``joint_train`` (BatchNorm held) with ``quantize_trunk: "int8"`` under
``{"dp": 2}`` (rank 0 calibrates, every
rank takes its qtree: rank 1 would calibrate with doubled abs-maxes,
``_torch_parallel_worker.skewed_calibration``), and the folded
``histo_savescore`` under ``{"dp":
2}`` (rank 0 serves, rank 1 waits). Here, while it works, the test
process makes the port's world-of-one runs and the JAX CLIs' frames on a
virtual mesh of 2 devices. Without a world, the int8 ``rna_savescore`` and
the folded ``histo_savescore`` under ``{"dp": 2}`` write the frames of the
same config without a mesh (the JAX CLIs never read ``mesh``).

Tolerances: against the world of one, the int8 features bit for bit (each
rank quantizes its rows with rank 0's qtree; int8 products are exact) and
the folded features at ``rtol=1e-5, atol=1e-6`` (the extract tolerance
of ``tests/test_torch_parallel_histo.py``: the convolutions see batches of
another size); the trunk run's
first step as ``tests/test_torch_parallel_histo.py`` holds a train-mode
BatchNorm run (twice the witness's distance, the JAX tolerance below it),
the joint trunk's (BatchNorm held) at the JAX tolerance.
Against the JAX package: the folded features at ``rtol=1e-4, atol=1e-6``
(``tests/test_torch_histo_cli.py``), and the int8 features at a per-case
cosine of 0.999 (each stack calibrates on its own float32 pass:
``tests/test_torch_quantize.py::test_int8_cli_frames_track_jax``).
"""

import json
import shutil

import jax
import numpy as np
import pytest
import torch

from multimodalbrainsurvival_torch.cli import histo_extractfeatures, histo_savescore
from multimodalbrainsurvival_torch.cli import rna_savescore, rna_train
from multimodalbrainsurvival_torch.cli._common import build_mil_model
from multimodalbrainsurvival_torch.config import Config
from tests import _torch_parallel_worker as worker
from tests import test_torch_parallel_histo as histo
from tests.test_torch_parallel_rna import _assert_grads_close, _write_json
from tests.test_torch_quantize import _cosines
from tests._torch_tmp import remove_module_tmp, remove_tmp_path  # noqa: F401

DP, BAG = histo.DP, histo.BAG
R50 = {"model_name": "resnet50", "aggregator_hdim": 2048}
#: the world's jobs: name → (cli, config overrides)
JOBS = {
    "int8_dp": ("histo_extractfeatures", {"mesh": DP, "quantize": "int8"}),
    "int8_bag": ("histo_extractfeatures", {"mesh": BAG, "quantize": "int8"}),
    "fold_dp": ("histo_extractfeatures", {"mesh": DP, "fold_bn": True, **R50}),
    "trunk_dp": ("histo_train", {"mesh": DP, "quantize_trunk": "int8", "augment": False}),
    "joint_trunk_dp": ("joint_train", {"mesh": DP, "quantize_trunk": "int8", "augment": False,
                                       "dropout": 0.0, "freeze_bn": True}),
    "serve_fold_dp": ("histo_savescore", {"mesh": DP, "fold_bn": True}),
}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _config(tmp, name, **overrides):
    cli, base = JOBS.get(name, (None, {}))
    cfg = {**base, **overrides}
    if cfg.get("model_name") == "resnet50":
        cfg["model_path"] = str(tmp / "r50.pt")
    return histo._config(tmp, name, **cfg)


def _world_of_one_config(tmp, name):
    return _config(tmp, f"{name}_w1", **{**JOBS[name][1], "mesh": {}})


def _weights(tmp):
    histo._initial_weights(tmp, "int8_dp")
    torch.manual_seed(13)
    cfg = Config(json.loads((tmp / "fold_dp.json").read_text()))
    torch.save(build_mil_model(cfg).state_dict(), str(tmp / "r50.pt"))


def _jax_extract(tmp, name):
    """The JAX ``histo_extractfeatures`` of ``name``'s config on a virtual
    mesh of its shape, from the same weights."""
    from multimodalbrainsurvival_tpu.cli import histo_extractfeatures as jax_extract
    from multimodalbrainsurvival_tpu.models.convert import (
        load_torch_state_dict,
        torch_mil_to_flax,
    )
    from multimodalbrainsurvival_tpu.train.checkpoint import Checkpointer

    cfg = json.loads((tmp / f"{name}.json").read_text())
    flax_dir = str(tmp / f"{name}_flax")
    Checkpointer().save(flax_dir, jax.tree.map(
        np.asarray, torch_mil_to_flax(load_torch_state_dict(cfg["model_path"]))), block=True)
    cfg.update(model_path=flax_dir, output_path=str(tmp / f"{name}_jax"))
    jax_extract.main(["--config", _write_json(tmp / f"{name}_jax.json", cfg)])


def _references(tmp):
    for name in ("int8_dp", "fold_dp", "serve_fold_dp"):
        main = {"histo_extractfeatures": histo_extractfeatures.main,
                "histo_savescore": histo_savescore.main}[JOBS[name][0]]
        main(histo._argv(_world_of_one_config(tmp, name)))
    for name in ("int8_dp", "fold_dp"):
        _jax_extract(tmp, name)
    record, joint = {}, {}
    assert worker.run_cli("histo_train", histo._argv(_world_of_one_config(tmp, "trunk_dp")),
                          record) == 0
    assert worker.run_cli("joint_train", histo._argv(
        _world_of_one_config(tmp, "joint_trunk_dp")), joint) == 0
    witness = {}
    with worker.synced_statistics():
        assert worker.run_cli("histo_train", histo._argv(
            _config(tmp, "trunk_dp_witness", **{**JOBS["trunk_dp"][1], "mesh": {}})),
            witness) == 0
    return {"trunk": record, "witness": witness, "joint_trunk": joint}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_serving")
    histo._cohort(tmp)
    # rank 1 would quantize with doubled abs-maxes (``worker.skewed_calibration``)
    # if it calibrated itself: the frames show that it takes rank 0's qtree
    jobs = [{"cli": cli, "argv": histo._argv(_config(tmp, name)),
             "grads": str(tmp / f"{name}.grads.pt"), "skew_rank": 1}
            for name, (cli, _) in JOBS.items()]
    _weights(tmp)
    out = tmp / "codes"
    out.mkdir()
    results, refs = worker.run_world(2, _write_json(tmp / "jobs.json", jobs), str(out),
                                     str(tmp / "logs"), lambda: _references(tmp))
    for rank, (code, log) in enumerate(results):
        assert code == 0, f"rank {rank} exited {code}:\n{log[-3000:]}"
    for name, pair in zip(JOBS, zip(*(json.loads((out / f"codes{r}.json").read_text())
                                     for r in range(2)))):
        assert pair == (0, 0), (name, pair)
    yield tmp, refs
    shutil.rmtree(tmp, ignore_errors=True)


def _features(directory, split):
    return np.loadtxt(directory / f"pathology_features_{split}.csv", delimiter=",", ndmin=2)


@pytest.mark.parametrize("name", ["int8_dp", "int8_bag"])
def test_int8_extract_under_a_mesh_equals_the_world_of_one(world, name):
    tmp, _ = world
    for split in ("train", "val", "test"):
        np.testing.assert_array_equal(_features(tmp / name, split),
                                      _features(tmp / "int8_dp_w1", split))
        assert ((tmp / name / f"pathology_cases_{split}.csv").read_text()
                == (tmp / "int8_dp_w1" / f"pathology_cases_{split}.csv").read_text())


@pytest.mark.parametrize("name", ["int8_dp", "fold_dp"])
def test_extract_under_dp_tracks_jax_on_a_virtual_mesh(world, name):
    tmp, _ = world
    for split in ("train", "val", "test"):
        got, want = _features(tmp / name, split), _features(tmp / f"{name}_jax", split)
        assert got.shape == want.shape
        if name.startswith("int8"):
            assert _cosines(got, want).min() >= 0.999
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_folded_extract_under_dp_equals_the_world_of_one(world):
    tmp, _ = world
    for split in ("train", "val", "test"):
        np.testing.assert_allclose(_features(tmp / "fold_dp", split),
                                   _features(tmp / "fold_dp_w1", split), rtol=1e-5, atol=1e-6)


def test_quantize_trunk_under_dp_matches_the_world_of_one(world):
    """Rank 0's qtree on both ranks: the first step's loss and gradients
    are the world-of-one run's, within twice the synced-statistics
    witness's distance (the tail's train-mode BatchNorm)."""
    tmp, refs = world
    got = torch.load(str(tmp / "trunk_dp.grads.pt"))
    want, witness = refs["trunk"], refs["witness"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    floor = 2 * max(float((witness["grads"][k] - want["grads"][k]).abs().max())
                    for k in want["grads"])
    _assert_grads_close(got["grads"], want["grads"], floor)


def test_joint_quantize_trunk_under_dp_matches_the_world_of_one(world):
    """The joint model's int8 trunk under ``{"dp": 2}`` (BatchNorm held,
    dropout 0): the first step at the JAX tolerance."""
    tmp, refs = world
    got, want = torch.load(str(tmp / "joint_trunk_dp.grads.pt")), refs["joint_trunk"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    _assert_grads_close(got["grads"], want["grads"])


def test_serving_cli_in_a_world_serves_on_rank_zero(world):
    """The folded ``histo_savescore`` started in a world of 2: rank 0 alone
    writes, the world-of-one frames."""
    tmp, _ = world
    for split in ("train", "val", "test"):
        name = f"mil.pt_pathology_{split}_df.csv"
        assert ((tmp / "serve_fold_dp" / name).read_text()
                == (tmp / "serve_fold_dp_w1" / name).read_text())
    wrote = [[line for line in (tmp / "logs" / f"rank{r}.log").read_text().splitlines()
              if line.startswith("wrote ") and "serve_fold_dp" in line] for r in range(2)]
    assert (len(wrote[0]), len(wrote[1])) == (3, 0)


def test_single_device_serving_clis_ignore_the_mesh(tmp_path):
    """F5: a shared train-and-serve config (``{"mesh": {"dp": 2}}`` with
    ``quantize: "int8"`` or ``fold_bn: true``) runs in one process and
    writes the frames of the same config without a mesh, as the JAX CLIs
    (which never read ``mesh``) do."""
    from tests import test_torch_parallel_rna as rna
    from tests.helpers import make_survival_csv

    histo._cohort(tmp_path)
    for split, n, seed in (("train", 12, 5), ("val", 6, 6), ("test", 6, 7)):
        make_survival_csv(str(tmp_path / f"{split}.csv"), [f"{split}{i}" for i in range(n)],
                          n_rna=rna.N_GENES, seed=seed)
    rna_train.main(rna._argv(rna._config(tmp_path, "rna_init", restore_path="")))
    rna_model = str(tmp_path / "out" / "models" / "rna_init" / "model_last.pt")
    runs = {
        "rna": (rna_savescore.main, lambda name, **kw: rna._config(
            tmp_path, name, model_path=rna_model, quantize="int8",
            output_path=str(tmp_path / name), **kw), "rna_{}_df.csv"),
        "histo": (histo_savescore.main, lambda name, **kw: histo._config(
            tmp_path, name, fold_bn=True, **kw), "mil.pt_pathology_{}_df.csv"),
    }
    cfg = histo._config(tmp_path, "histo_shape")
    torch.manual_seed(11)
    torch.save(build_mil_model(Config(json.loads(open(cfg).read()))).state_dict(),
               str(tmp_path / "mil.pt"))
    for stack, (main, config, frame) in runs.items():
        main(["--config", config(f"{stack}_mesh", mesh={"dp": 2}), "--device", "cpu"])
        main(["--config", config(f"{stack}_plain"), "--device", "cpu"])
        for split in ("train", "val", "test"):
            assert ((tmp_path / f"{stack}_mesh" / frame.format(split)).read_text()
                    == (tmp_path / f"{stack}_plain" / frame.format(split)).read_text())
