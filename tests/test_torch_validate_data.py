"""The port's ``validate_data`` against the JAX CLI, on the CPU.

Every case of ``tests/test_validate_data.py``, and the label rules of the
other tasks, run through both stacks' ``main`` on the same files: the
same exit code, and the same ``ERROR`` / ``WARN`` lines and summary, in
order.
"""

import json
import os

import numpy as np
import pytest

from multimodalbrainsurvival_torch.cli import validate_data
from multimodalbrainsurvival_tpu.cli import validate_data as jax_validate_data
from tests.helpers import make_patch_dir
from tests.test_validate_data import _cfg, _three_splits


def _findings(out: str) -> list[str]:
    return [ln for ln in out.splitlines()
            if ln.startswith(("ERROR", "WARN", "validation:", "OK", "gene vocabulary"))]


def _check(capsys, argv) -> tuple[int, list[str]]:
    """Run both stacks; they must agree. Returns the port's (rc, lines)."""
    want_rc = jax_validate_data.main(argv)
    want = _findings(capsys.readouterr().out)
    rc = validate_data.main(argv)
    got = _findings(capsys.readouterr().out)
    assert (rc, got) == (want_rc, want)
    return rc, got


def _patch_cohort(tmp_path, n=5):
    root = tmp_path / "patches"
    wsis = {"train": [f"TW{i}" for i in range(6)],
            "val": [f"VW{i}" for i in range(4)],
            "test": [f"EW{i}" for i in range(4)]}
    for names in wsis.values():
        for i, w in enumerate(names):
            make_patch_dir(str(root), w, n, img_size=16, seed=i)
    return root, wsis


def test_clean_feature_cohort(tmp_path, capsys):
    _three_splits(tmp_path, n_feature=8)
    rc, lines = _check(capsys, ["--config", _cfg(tmp_path), "--task", "feature"])
    assert rc == 0 and lines[-1] == "OK"


def test_label_and_leakage_errors(tmp_path, capsys):
    frames = _three_splits(tmp_path, n_feature=8)
    df = frames["train"]
    df.loc[0, "survival_months"] = -3.0
    df.loc[1, "vital_status"] = 2
    df.loc[2, "survival_months"] = np.nan
    df.loc[3, "case"] = frames["val"].loc[0, "case"]
    df.to_csv(tmp_path / "train.csv", index=False)
    rc, lines = _check(capsys, ["--config", _cfg(tmp_path), "--task", "feature"])
    assert rc == 1 and any("case leakage" in ln for ln in lines)


def test_missing_columns_and_nan_features(tmp_path, capsys):
    frames = _three_splits(tmp_path, n_feature=8)
    df = frames["val"].drop(columns=["vital_status"])
    df.loc[1, "feature_3"] = np.nan
    df.to_csv(tmp_path / "val.csv", index=False)
    rc, _ = _check(capsys, ["--config", _cfg(tmp_path), "--task", "feature"])
    assert rc == 1


@pytest.mark.parametrize("symbols", [["0", "1", "2", "3", "4"], ["1", "0", "2", "3", "4"],
                                     ["g0", "g1"]])
def test_rna_vocabulary_width_and_order(tmp_path, capsys, symbols):
    _three_splits(tmp_path, n_rna=5)
    genes = tmp_path / "genes.txt"
    genes.write_text("i,symbol\n" + "".join(f"{i},{s}\n" for i, s in enumerate(symbols)))
    rc, _ = _check(capsys, ["--config", _cfg(tmp_path), "--task", "rna",
                            "--genes", str(genes)])
    assert rc == (1 if len(symbols) == 2 else 0)


def test_default_reference_vocab_mismatch_is_advisory(tmp_path, capsys, monkeypatch):
    """Without ``--genes`` the reference vocabulary is implicit: a cohort of
    another width warns, and does not fail (the default file is put in
    place for both stacks)."""
    genes = tmp_path / "genes.txt"
    genes.write_text("i,symbol\n" + "".join(f"{i},g{i}\n" for i in range(7)))
    monkeypatch.setattr(jax_validate_data, "REFERENCE_GENES_TXT", str(genes))
    monkeypatch.setattr(validate_data, "REFERENCE_GENES_TXT", str(genes))
    _three_splits(tmp_path, n_rna=5)
    rc, lines = _check(capsys, ["--config", _cfg(tmp_path), "--task", "rna"])
    assert rc == 0 and any("gene vocabulary defines 7 genes" in ln for ln in lines)


def test_histo_patch_directory_contracts(tmp_path, capsys):
    root, wsis = _patch_cohort(tmp_path)
    _three_splits(tmp_path, wsis=wsis)
    cfgp = _cfg(tmp_path, data_path=str(root), train_bag_size=2, val_bag_size=2)
    assert _check(capsys, ["--config", cfgp, "--task", "histo"])[0] == 0
    os.rename(root / "TW0", root / "GONE")
    os.remove(root / "TW1" / "TW1_patch_4.png")
    loc = root / "TW2" / "loc.txt"
    loc.write_text("".join(loc.read_text().splitlines(keepends=True)[:3]))
    assert _check(capsys, ["--config", cfgp, "--task", "histo"])[0] == 1


def test_packed_shard_shorter_than_loc(tmp_path, capsys):
    root, wsis = _patch_cohort(tmp_path, n=4)
    _three_splits(tmp_path, wsis=wsis)
    np.save(root / "TW0" / "patches.npy", np.zeros((2, 16, 16, 3), dtype=np.uint8))
    rc, lines = _check(capsys, ["--config", _cfg(tmp_path, data_path=str(root)),
                                "--task", "histo"])
    assert rc == 1 and any("patches.npy holds 2" in ln for ln in lines)


def test_stale_packed_shard_falls_back_to_png_check(tmp_path, capsys):
    root, wsis = _patch_cohort(tmp_path, n=4)
    _three_splits(tmp_path, wsis=wsis)
    cfgp = _cfg(tmp_path, data_path=str(root))
    shard = root / "TW0" / "patches.npy"
    np.save(shard, np.zeros((4, 16, 16, 3), dtype=np.uint8))
    os.utime(shard, (os.path.getmtime(root / "TW0" / "loc.txt") - 100,) * 2)
    os.remove(root / "TW0" / "TW0_patch_3.png")
    assert _check(capsys, ["--config", cfgp, "--task", "histo"])[0] == 1
    os.utime(shard, None)
    assert _check(capsys, ["--config", cfgp, "--task", "histo"])[0] == 0


def test_joint_cohort_with_duplicate_slides(tmp_path, capsys):
    root, wsis = _patch_cohort(tmp_path)
    wsis["val"][1] = wsis["val"][0]
    _three_splits(tmp_path, wsis=wsis, n_rna=3)
    rc, lines = _check(capsys, ["--config", _cfg(tmp_path, data_path=str(root)),
                                "--task", "joint"])
    assert rc == 1 and any("duplicate wsi_file_name" in ln for ln in lines)


def test_missing_split_file_and_unset_key(tmp_path, capsys):
    _three_splits(tmp_path, n_feature=4)
    os.remove(tmp_path / "test.csv")
    cfg = {"train_csv_path": str(tmp_path / "train.csv"),
           "val_csv_path": str(tmp_path / "val.csv"),
           "test_csv_path": str(tmp_path / "test.csv")}
    p = tmp_path / "cfg.json"
    p.write_text(json.dumps(cfg))
    assert _check(capsys, ["--config", str(p), "--task", "feature"])[0] == 1
    cfg.pop("test_csv_path")
    p.write_text(json.dumps(cfg))
    assert _check(capsys, ["--config", str(p), "--task", "feature"])[0] == 0


def test_fully_censored_split_warns_but_passes(tmp_path, capsys):
    frames = _three_splits(tmp_path, n_feature=4)
    frames["val"]["vital_status"] = 0
    frames["val"].to_csv(tmp_path / "val.csv", index=False)
    rc, lines = _check(capsys, ["--config", _cfg(tmp_path), "--task", "feature"])
    assert rc == 0 and any("fully censored" in ln for ln in lines)


@pytest.mark.parametrize("task", ["survival_bin", "classification"])
def test_other_tasks_label_rules(tmp_path, capsys, task):
    """``survival_bin`` needs integer bins and the Cox labels;
    classification its ``target_label``."""
    frames = _three_splits(tmp_path, n_feature=4)
    for split, df in frames.items():
        df["survival_bin"] = np.arange(len(df)) % 4
        df["grade"] = np.arange(len(df)) % 2
        if split == "train":
            df["survival_bin"] = df["survival_bin"] + 0.5
            df.loc[1, "grade"] = np.nan
        df.to_csv(tmp_path / f"{split}.csv", index=False)
    rc, _ = _check(capsys, ["--config", _cfg(tmp_path, task=task, target_label="grade"),
                            "--task", "feature"])
    assert rc == 1


def test_unknown_task_is_refused():
    with pytest.raises(SystemExit, match="unknown --task"):
        validate_data.main(["--config", "missing.json", "--task", "tiles"])
