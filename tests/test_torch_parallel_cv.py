"""``cv_run`` and ``sweep`` in a gloo world of 2 processes on the CPU.

One world runs ``cv_run --task rna --folds 2`` and ``sweep --task rna
--halving 2`` with ``mesh: {"dp": 2}`` (every rank runs the orchestrator;
each fold's or combination's ``rna_train`` runs in-process in the world,
``rna_savescore`` on rank 0). The ``cv_run`` config has no ``flag``: rank
0's timestamp names every run. Here, while it works, the test process
runs both CLIs without a mesh, and the JAX ``cv_run``, from one seeded
``.pt`` (the JAX run from its flax conversion) at ``dropout: 0`` and LR
1e-5. The JAX run has no mesh: its ``rna_train`` under a mesh raises on a
``restore_path`` (the restored parameters stay on one device while the
batch spans two: "Received incompatible devices for jitted computation"),
and without one it starts from weights of its own. Rank 0 alone writes:
one set of fold files and summaries. Tolerances: the fold CSVs byte for
byte; frames and C-indices at ``tests/test_torch_cv_sweep.py``'s ``rtol=1e-4,
atol=1e-5`` (float32 sums over the ranks or the stacks in another order).
"""

import json
import os
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

from multimodalbrainsurvival_torch.cli import cv_run, sweep
from multimodalbrainsurvival_torch.cli.rna_train import build_rna_model
from tests import _torch_parallel_worker as worker
from tests.helpers import make_survival_csv
from tests.test_torch_cv_sweep import TOL, _assert_frames
from tests.test_torch_histo_cli import _random_state
from tests.test_torch_joint import _save_flax
from tests.test_torch_parallel_rna import _write_json

N_RNA = 16
GRID = '{"lr": [1e-5, 3e-6]}'
CV = ["--task", "rna", "--folds", "2"]
SWEEP = ["--task", "rna", "--grid", GRID, "--halving", "2"]


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cohort(tmp):
    from multimodalbrainsurvival_tpu.models.convert import torch_rna_to_flax

    make_survival_csv(str(tmp / "cohort.csv"), [f"c{i}" for i in range(16)], n_rna=N_RNA,
                      seed=3)
    make_survival_csv(str(tmp / "test.csv"), [f"t{i}" for i in range(8)], n_rna=N_RNA,
                      seed=9)
    for split, n, seed in (("train", 16, 1), ("val", 8, 2)):
        make_survival_csv(str(tmp / f"{split}.csv"), [f"{split}{i}" for i in range(n)],
                          n_rna=N_RNA, seed=seed)
    state = _random_state(build_rna_model(None, N_RNA), seed=5)
    torch.save(state, str(tmp / "init.pt"))
    _save_flax(torch_rna_to_flax({k: v.numpy() for k, v in state.items()}),
               str(tmp / "init_flax"))


def _config(tmp, name, stack="torch", **overrides):
    cfg = {"batch_size": 8, "num_epochs": 2, "lr_rna": 1e-5, "lr_mlp": 1e-5, "lr": 1e-5,
           "weight_decay": 1e-5, "dropout": 0.0, "num_workers": 1, "model_path": "",
           "test_csv_path": str(tmp / "test.csv"),
           "restore_path": str(tmp / ("init_flax" if stack == "jax" else "init.pt")),
           "checkpoint_path": str(tmp / name) + "/", "summary_path": str(tmp / name / "s")}
    cfg.update(overrides)
    return _write_json(tmp / f"{name}.json", cfg)


def _cv_config(tmp, name, stack="torch", **overrides):
    return _config(tmp, name, stack, cv_csv_path=str(tmp / "cohort.csv"), **overrides)


def _sweep_config(tmp, name, **overrides):
    return _config(tmp, name, train_csv_path=str(tmp / "train.csv"),
                   val_csv_path=str(tmp / "val.csv"), flag="sw", **overrides)


def _references(tmp):
    from multimodalbrainsurvival_tpu.cli import cv_run as jax_cv_run

    cv_run.main(["--config", _cv_config(tmp, "cv_w1", flag="cv"), "--device", "cpu"] + CV)
    sweep.main(["--config", _sweep_config(tmp, "sweep_w1"), "--device", "cpu"] + SWEEP)
    jax_cv_run.main(["--config", _cv_config(tmp, "cv_jax", "jax", flag="cv")] + CV)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_cv")
    _cohort(tmp)
    jobs = [{"cli": "cv_run", "argv": ["--config", _cv_config(tmp, "cv_dp", mesh={"dp": 2}),
                                       "--device", "cpu"] + CV},
            {"cli": "sweep", "argv": ["--config", _sweep_config(tmp, "sweep_dp",
                                                                mesh={"dp": 2}),
                                      "--device", "cpu"] + SWEEP}]
    out = tmp / "codes"
    out.mkdir()
    results, _ = worker.run_world(2, _write_json(tmp / "jobs.json", jobs), str(out),
                                  str(tmp / "logs"), lambda: _references(tmp))
    for rank, (code, log) in enumerate(results):
        assert code == 0, f"rank {rank} exited {code}:\n{log[-3000:]}"
    for r in range(2):
        assert json.loads((out / f"codes{r}.json").read_text()) == [0, 0]
    yield tmp
    shutil.rmtree(tmp, ignore_errors=True)


def _flag(tmp) -> str:
    """The world's one timestamp flag (its fold runs are ``<flag>_cv<k>``)."""
    runs = sorted(os.listdir(tmp / "cv_dp" / "outputs"))
    assert len(runs) == 2 and runs[0].endswith("_cv1") and runs[1].endswith("_cv2"), runs
    flag = runs[0][:-len("_cv1")]
    assert flag.startswith("train_") and runs[1] == f"{flag}_cv2"
    return flag


def test_cv_run_in_a_world_leaves_one_set_of_fold_files(world):
    flag = _flag(world)
    assert sorted(os.listdir(world / "cv_dp" / "models")) == [f"{flag}_cv1", f"{flag}_cv2"]
    for k in (1, 2):
        assert sorted(os.listdir(world / "cv_dp" / "cv" / f"fold{k}")) == [
            "config_savescore.json", "config_train.json", "train.csv", "val.csv"]
        for split in ("train", "val"):
            name = f"cv/fold{k}/{split}.csv"
            assert (world / "cv_dp" / name).read_bytes() == (world / "cv_w1" / name).read_bytes()
            assert (world / "cv_dp" / name).read_bytes() == (world / "cv_jax" / name).read_bytes()
    for name in ("cv_summary.csv", "cv_oof_val_df.csv", "cv_ensemble_test_df.csv"):
        assert (world / "cv_dp" / name).exists()


@pytest.mark.parametrize("reference", ["cv_w1", "cv_jax"])
@pytest.mark.parametrize("k", [1, 2])
def test_cv_fold_frames_match_the_world_of_one_and_jax(world, reference, k):
    flag = _flag(world)
    for split in ("val", "test"):
        got = world / "cv_dp" / "outputs" / f"{flag}_cv{k}" / f"rna_{split}_{flag}_cv{k}_df.csv"
        want = world / reference / "outputs" / f"cv_cv{k}" / f"rna_{split}_cv_cv{k}_df.csv"
        _assert_frames(got, want)
    got = pd.read_csv(world / "cv_dp" / "cv_summary.csv")
    want = pd.read_csv(world / reference / "cv_summary.csv")
    np.testing.assert_allclose(got[["val_CI", "test_CI"]], want[["val_CI", "test_CI"]], **TOL)
    assert list(got["n_val_rows"]) == list(want["n_val_rows"])


def test_sweep_in_a_world_ranks_alike_and_matches_the_world_of_one(world):
    """The halving rungs cut the same combination on both ranks (rank 0's
    C-indices), and the summary is the world of one's."""
    got = pd.read_csv(world / "sweep_dp" / "sweep_summary.csv")
    want = pd.read_csv(world / "sweep_w1" / "sweep_summary.csv")
    assert list(got["combo"]) == list(want["combo"])
    assert list(got["epochs_trained"]) == list(want["epochs_trained"]) == [2, 1]
    np.testing.assert_allclose(got[["val_CI", "test_CI"]], want[["val_CI", "test_CI"]], **TOL)
    best = json.loads((world / "sweep_dp" / "sweep_best_config.json").read_text())
    assert best["lr"] == json.loads(
        (world / "sweep_w1" / "sweep_best_config.json").read_text())["lr"]
