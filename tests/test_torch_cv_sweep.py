"""The port's ``cv_run`` and ``sweep`` against the JAX CLIs, on the CPU.

``assign_folds`` gives the JAX case → fold map exactly. ``cv_run --task
feature`` and ``sweep`` (full grid, ``--max_trials``, ``--halving 2``)
train the early-fusion MLP in both stacks from one seeded ``.pt`` (the
JAX runs from its flax conversion) at ``dropout: 0`` and LR 1e-5 or less:
the fold CSVs are equal byte for byte, the frames within ``rtol=1e-4,
atol=1e-5`` (float32 products summed in another order, Adam's bias
corrections in float32 in optax and float64 in torch), and the C-indices
equal. A full grid over ``num_epochs`` shows the one ranking the port
does not copy: JAX puts the longest runs first, the port ranks by the
val C-index. ``cv_run --task rna`` and ``--task histo`` (32-px patches,
ResNet-18) run on the port alone, their frames checked.
"""

import contextlib
import io
import json
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

from multimodalbrainsurvival_torch.cli import cv_run, feature_train, sweep
from multimodalbrainsurvival_tpu.cli import cv_run as jax_cv_run, sweep as jax_sweep
from tests.helpers import make_patch_dir, make_survival_csv
from tests.test_torch_histo_cli import _random_state
from tests.test_torch_joint import _save_flax

TOL = dict(rtol=1e-4, atol=1e-5)
N_FEATURE = 24
STACKS = {"jax": (jax_cv_run, jax_sweep, []), "torch": (cv_run, sweep, ["--device", "cpu"])}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _quiet(main, argv):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        main(argv)
    return out.getvalue()


def _fold_cohort(rows, seed):
    rng = np.random.default_rng(seed)
    status = rng.integers(0, 2, len(rows)).astype(float)
    status[rng.random(len(rows)) < 0.1] = np.nan
    return pd.DataFrame({"case": rows, "vital_status": status})


@pytest.mark.parametrize("k", [2, 3, 5])
@pytest.mark.parametrize("seed", [0, 7])
def test_assign_folds_matches_jax(k, seed):
    """Multi-row cases, a case whose status is missing on every row, ids
    that sort as text, each in both stacks from one seed."""
    rng = np.random.default_rng(seed)
    rows = [f"c{int(i)}" for i in rng.integers(0, 23, 60)]
    df = _fold_cohort(rows, seed)
    frame = {"case": rows, "vital_status": df["vital_status"].tolist()}
    assert cv_run.assign_folds(frame, k, seed) == jax_cv_run.assign_folds(df, k, seed)
    # no vital_status column: one stratum; numeric case ids
    ids = list(rng.integers(100, 140, 30))
    assert cv_run.assign_folds({"case": [int(i) for i in ids]}, k, seed) == \
        jax_cv_run.assign_folds(pd.DataFrame({"case": ids}), k, seed)


def test_assign_folds_errors():
    with pytest.raises(ValueError, match="cannot fill"):
        cv_run.assign_folds({"case": ["a", "b"], "vital_status": [1, 0]}, 3, 0)
    with pytest.raises(ValueError, match="'case' column"):
        cv_run.assign_folds({"x": [1]}, 2, 0)


def test_ensemble_frames_matches_jax():
    frames = [pd.DataFrame({"id": ["a", "b", "c", "d"], "score": [1.0, 2.0, 3.0, 0.5],
                            "survival_months": [10.0, 20.0, 30.0, 5.0],
                            "vital_status": [1, 0, 1, 1]}),
              pd.DataFrame({"id": ["d", "b", "a"], "score": [4.0, 5.0, -1.0],
                            "survival_months": [5.0, 20.0, 10.0], "vital_status": [1, 0, 1]}),
              pd.DataFrame({"id": ["b", "a", "d"], "score": [0.25, 7.0, 2.0],
                            "survival_months": [20.0, 10.0, 5.0], "vital_status": [0, 1, 1]})]
    want = jax_cv_run.ensemble_frames(frames)
    got = cv_run.ensemble_frames([{c: f[c].tolist() for c in f} for f in frames])
    assert list(got) == list(want.columns)
    for c in want:
        assert got[c] == want[c].tolist(), c


@pytest.fixture(scope="module")
def feature_cohort(tmp_path_factory):
    """A 14-case cohort, a fixed 6-case test split, and one seeded initial
    model in both formats."""
    from multimodalbrainsurvival_tpu.models.convert import torch_feature_to_flax

    tmp = tmp_path_factory.mktemp("cv")
    make_survival_csv(str(tmp / "cohort.csv"), [f"c{i}" for i in range(14)],
                      n_feature=N_FEATURE, seed=3)
    make_survival_csv(str(tmp / "test.csv"), [f"t{i}" for i in range(6)],
                      n_feature=N_FEATURE, seed=9)
    for split, n, seed in (("train", 12, 1), ("val", 8, 2)):
        make_survival_csv(str(tmp / f"{split}.csv"), [f"{split}{i}" for i in range(n)],
                          n_feature=N_FEATURE, seed=seed)
    state = _random_state(feature_train.build_feature_model(None, N_FEATURE), seed=5)
    torch.save(state, str(tmp / "init.pt"))
    _save_flax(torch_feature_to_flax({k: v.numpy() for k, v in state.items()}),
               str(tmp / "init_flax"))
    init = {"jax": str(tmp / "init_flax"), "torch": str(tmp / "init.pt")}
    base = {"batch_size": 4, "num_epochs": 2, "lr": 1e-5, "weight_decay": 1e-5,
            "dropout": 0.0, "flag": "ef", "num_workers": 1, "model_path": "",
            "test_csv_path": str(tmp / "test.csv")}
    yield tmp, base, init
    shutil.rmtree(tmp)  # the runs' checkpoints: the suite's disk is shared


def _write(path, cfg):
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.fixture(scope="module")
def cv_runs(feature_cohort):
    tmp, base, init = feature_cohort
    outs = {}
    for name, (cv, _, extra) in STACKS.items():
        out = tmp / f"cv_{name}"
        cfg = dict(base, cv_csv_path=str(tmp / "cohort.csv"), restore_path=init[name],
                   checkpoint_path=str(out) + "/", summary_path=str(out / "summary"))
        log = _quiet(cv.main, ["--config", _write(tmp / f"cv_{name}.json", cfg),
                               "--task", "feature", "--folds", "2"] + extra)
        outs[name] = (out, log)
    return outs


def test_cv_fold_csvs_are_the_jax_ones_byte_for_byte(cv_runs):
    (jax_out, _), (out, _) = cv_runs["jax"], cv_runs["torch"]
    for k in (1, 2):
        for split in ("train", "val"):
            name = f"cv/fold{k}/{split}.csv"
            assert (out / name).read_bytes() == (jax_out / name).read_bytes(), name
        child = json.loads((out / f"cv/fold{k}/config_savescore.json").read_text())
        assert child["model_path"].endswith(f"models/ef_cv{k}/model_dict_best.pt")
        assert child["flag"] == f"ef_cv{k}" and child["restore_path"] == ""
        assert "cv_csv_path" not in child


def _assert_frames(got_path, want_path):
    got, want = pd.read_csv(got_path), pd.read_csv(want_path)
    assert list(got.columns) == list(want.columns)
    assert list(got["id"]) == list(want["id"])
    for c in want:
        if c != "id":
            np.testing.assert_allclose(got[c], want[c], **TOL, err_msg=c)


@pytest.mark.parametrize("split", ["val", "test"])
@pytest.mark.parametrize("k", [1, 2])
def test_cv_fold_frames_match_jax(cv_runs, k, split):
    (jax_out, _), (out, _) = cv_runs["jax"], cv_runs["torch"]
    name = f"feature_{split}_ef_cv{k}_df.csv"
    _assert_frames(out / f"outputs/ef_cv{k}/model_dict_best.pt_{name}",
                   jax_out / f"outputs/ef_cv{k}/model_dict_best_{name}")


@pytest.mark.parametrize("name", ["cv_summary.csv", "cv_oof_val_df.csv",
                                  "cv_ensemble_test_df.csv"])
def test_cv_summary_oof_and_ensemble_match_jax(cv_runs, name):
    (jax_out, jax_log), (out, log) = cv_runs["jax"], cv_runs["torch"]
    if name == "cv_summary.csv":
        got, want = pd.read_csv(out / name), pd.read_csv(jax_out / name)
        assert list(got.columns) == list(want.columns)
        assert got.drop(columns=["val_CI", "test_CI"]).equals(
            want.drop(columns=["val_CI", "test_CI"]))
        np.testing.assert_allclose(got[["val_CI", "test_CI"]], want[["val_CI", "test_CI"]],
                                   **TOL)
        for line in ("CV val CI:", "CV test CI:", "CV out-of-fold val CI:",
                     "CV ensemble test CI:"):
            assert [ln for ln in log.splitlines() if ln.startswith(line)] == \
                [ln for ln in jax_log.splitlines() if ln.startswith(line)]
    else:
        _assert_frames(out / name, jax_out / name)


def _sweep_both(feature_cohort, name, grid, *extra_args, **overrides):
    tmp, base, init = feature_cohort
    outs = {}
    for stack, (_, sw, extra) in STACKS.items():
        out = tmp / f"{name}_{stack}"
        cfg = dict(base, **{f"{s}_csv_path": str(tmp / f"{s}.csv") for s in ("train", "val")},
                   restore_path=init[stack], checkpoint_path=str(out) + "/",
                   summary_path=str(out / "summary"), **overrides)
        outs[stack] = (out, _quiet(sw.main, ["--config", _write(tmp / f"{name}_{stack}.json",
                                                                   cfg),
                                             "--task", "feature", "--grid", grid,
                                             *extra_args] + extra))
    return outs


@pytest.mark.parametrize("mode, grid, args", [
    ("full", '{"lr": [1e-5, 3e-6], "dropout": 0.0}', ()),
    ("max_trials", '{"lr": [1e-5, 3e-6, 1e-6, 3e-7]}', ("--max_trials", "2", "--seed", "3")),
    ("halving", '{"lr": [1e-5, 3e-6, 1e-6, 3e-7]}', ("--halving", "2")),
])
def test_sweep_matches_jax(feature_cohort, mode, grid, args):
    outs = _sweep_both(feature_cohort, mode, grid, *args)
    (jax_out, jax_log), (out, log) = outs["jax"], outs["torch"]
    got, want = pd.read_csv(out / "sweep_summary.csv"), pd.read_csv(jax_out / "sweep_summary.csv")
    assert list(got.columns) == list(want.columns)
    assert list(got["combo"]) == list(want["combo"])
    assert got.drop(columns=["val_CI", "test_CI"]).equals(
        want.drop(columns=["val_CI", "test_CI"]))
    np.testing.assert_allclose(got[["val_CI", "test_CI"]], want[["val_CI", "test_CI"]], **TOL)
    best, jax_best = (json.loads((o / "sweep_best_config.json").read_text())
                      for o in (out, jax_out))
    assert best["lr"] == jax_best["lr"] and best["flag"] == jax_best["flag"] == "ef"
    for c in got["combo"]:
        _assert_frames(out / f"outputs/ef_hp{c}/val_output_best.csv",
                       jax_out / f"outputs/ef_hp{c}/val_output_best.csv")
    for prefix in ("successive halving", "halving rung", "--max_trials", "sweep epoch-units"):
        assert [ln for ln in log.splitlines() if ln.startswith(prefix)] == \
            [ln for ln in jax_log.splitlines() if ln.startswith(prefix)]
    if mode == "halving":
        assert sorted(got["epochs_trained"]) == [1, 1, 2, 2]


def test_full_grid_ranks_by_val_ci_where_jax_puts_epochs_first(feature_cohort):
    """A grid over ``num_epochs`` and ``lr``: the learning LR after one
    epoch outranks the near-zero LR after two on the val C-index, so the
    port lists it second where JAX, sorting by ``epochs_trained`` first,
    lists both two-epoch runs first."""
    outs = _sweep_both(feature_cohort, "epochs", '{"num_epochs": [1, 2], "lr": [3e-2, 1e-9]}',
                       lr=3e-2)
    got = pd.read_csv(outs["torch"][0] / "sweep_summary.csv")
    want = pd.read_csv(outs["jax"][0] / "sweep_summary.csv")
    assert list(got["val_CI"]) == sorted(got["val_CI"], reverse=True)
    assert list(want["epochs_trained"]) == [2, 2, 1, 1]
    assert list(got["combo"]) != list(want["combo"])
    # the same runs: each combination's C-index equal in both stacks
    np.testing.assert_allclose(got.sort_values("combo")["val_CI"],
                               want.sort_values("combo")["val_CI"], **TOL)
    assert list(got["combo"]) == list(got.sort_values("val_CI", ascending=False,
                                                      kind="stable")["combo"])


# --- the port alone: RNA and histo folds -------------------------------------------


def _cv_cohort(tmp, n_cases=8, n_rna=16):
    root = tmp / "patches"
    wsis = [f"W{i}" for i in range(n_cases)]
    for i, w in enumerate(wsis):
        make_patch_dir(str(root), w, 6, img_size=32, seed=20 + i)
    cohort = make_survival_csv(str(tmp / "cohort.csv"), [f"c{i}" for i in range(n_cases)],
                               wsi_names=[f"{w}.svs" for w in wsis], n_rna=n_rna, seed=5)
    cohort["vital_status"] = 1
    cohort.to_csv(str(tmp / "cohort.csv"), index=False)
    return root, str(tmp / "cohort.csv")


def _check_cv_outputs(out, flag, n_cases, prefix):
    val_cases = []
    for k in (1, 2):
        train = pd.read_csv(out / f"cv/fold{k}/train.csv")
        val = pd.read_csv(out / f"cv/fold{k}/val.csv")
        assert not set(train["case"]) & set(val["case"])
        val_cases += list(val["case"])
        frame = pd.read_csv(out / f"outputs/{flag}_cv{k}/{prefix}_val_{flag}_cv{k}_df.csv")
        assert list(frame.columns)[1:] == ["id", "score", "survival_months", "vital_status"]
        assert np.isfinite(frame["score"]).all()
        assert (out / f"models/{flag}_cv{k}/model_dict_best.pt").is_file()
    assert sorted(val_cases) == [f"c{i}" for i in range(n_cases)]
    summary = pd.read_csv(out / "cv_summary.csv")
    assert list(summary["flag"]) == [f"{flag}_cv1", f"{flag}_cv2"]
    assert np.isfinite(summary["val_CI"]).all()
    oof = pd.read_csv(out / "cv_oof_val_df.csv")
    assert sorted(oof["id"]) == sorted(val_cases)


@pytest.mark.parametrize("task", ["rna", "histo"])
def test_cv_run_rna_and_histo_on_the_port(tmp_path, task):
    root, cohort = _cv_cohort(tmp_path)
    out = tmp_path / "out"
    cfg = {"num_classes": 1, "batch_size": 4, "cv_csv_path": cohort, "num_workers": 1,
           "num_epochs": 2, "weight_decay": 1e-5, "task": "survival_prediction",
           "checkpoint_path": str(out) + "/", "model_path": "", "restore_path": "",
           "flag": task}
    if task == "rna":
        cfg.update(lr_rna=1e-4, lr_mlp=1e-3, dropout=0.0)
        prefix = "rna"
    else:
        cfg.update(model_name="resnet18", data_path=str(root), img_size=32, lr=5e-4,
                   n_layers_to_train=2, aggregator="identity", aggregator_hdim=512,
                   train_bag_size=2, val_bag_size=2, max_patch_per_wsi_train=4,
                   max_patch_per_wsi_val=4)
        prefix = "model_dict_best.pt_pathology"
    _quiet(cv_run.main, ["--config", _write(tmp_path / "cfg.json", cfg), "--task", task,
                         "--folds", "2", "--device", "cpu"])
    _check_cv_outputs(out, task, 8, prefix)
    shutil.rmtree(out / "models")  # the folds' checkpoints: the suite's disk is shared
