"""K-fold cross-validation of any trainable pipeline.

The port's own copy of ``multimodalbrainsurvival_tpu/cli/cv_run.py``,
without pandas. The reference's published workflow evaluates every
pipeline with K-fold CV but ships no script for it: the user hand-splits
the cohort, writes K configs whose ``flag`` contains ``cv`` (the
substring the savescore naming keys on, ``cli/_common.savescore_name``),
and runs train then savescore once per fold. This CLI runs that loop for
the four trainable pipelines, in-process, with ``--device`` passed to
every child CLI (``cuda`` by default, which raises without a card)::

    python -m multimodalbrainsurvival_torch.cli.cv_run \\
        --config config_rna_train.json --task rna --folds 5

- **Split**: case-level (every row of a case in one fold), stratified by
  the case's event indicator (its rows' largest ``vital_status``),
  deterministic under ``--seed``, the JAX package's case → fold map. The
  cohort is ``cv_csv_path`` if set, else the base config's train and val
  CSVs, one after the other.
- **Fold k (1-based)**: ``<checkpoint_path>/cv/fold{k}/{train,val}.csv``
  and a derived config with ``flag: "<flag>_cv{k}"``; the task's train CLI,
  then (unless ``--no_savescore 1``) its savescore CLI on
  ``<checkpoint_path>/models/<flag>_cv{k}/model_dict_best.pt``, its frames
  under ``<checkpoint_path>/outputs/<flag>_cv{k}/``.
- **Summary**: each fold's val / test C-index, their mean and population
  std over the folds where they exist, in ``<checkpoint_path>/
  cv_summary.csv``.
- **Out of fold**: the fold val frames one after the other in
  ``<checkpoint_path>/cv_oof_val_df.csv``, every case scored once by the
  model that never trained on it.
- **Fold ensemble**: with a fixed ``test_csv_path``, the fold models' test
  scores averaged per case in ``<checkpoint_path>/cv_ensemble_test_df.csv``
  (the savescore frame's columns).

Config keys: ``cv_csv_path`` (a single cohort CSV) and ``cv_folds``
(overrides ``--folds``). Everything else is the task's train config:
``mesh``, ``cache_patches_on_device`` and ``quantize_trunk`` apply to each
fold unchanged (JAX ``cv_run.py:44-48``).

In a world (``python -m torch.distributed.run --nproc_per_node N -m
multimodalbrainsurvival_torch.cli.cv_run ...`` with a ``mesh`` of N
ranks) every rank runs this loop and the train CLIs in-process in that
world; rank 0 writes the fold CSVs, the configs and the summaries, the
others waiting for its files, and its timestamp flag is every rank's. The
savescore CLIs serve on one device (their world rule: rank 0 serves).
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np

from multimodalbrainsurvival_torch.cli._common import (
    load_config,
    make_device_put,
    make_parser,
)
from multimodalbrainsurvival_torch.device import resolve_device
from multimodalbrainsurvival_torch.frames import (
    as_text,
    concat_frames,
    frame_lines,
    infer_column,
    inner_merge,
    is_missing,
    n_rows,
    read_frame,
    records_frame,
    write_frame,
)
from multimodalbrainsurvival_torch.ops.metrics import survival_ci
from multimodalbrainsurvival_torch.parallel.mesh import world_barrier

TASKS = ("rna", "histo", "feature", "joint")


def task_mains(task: str):
    """(train_main, savescore_main) of a pipeline."""
    if task == "rna":
        from multimodalbrainsurvival_torch.cli import rna_savescore, rna_train

        return rna_train.main, rna_savescore.main
    if task == "histo":
        from multimodalbrainsurvival_torch.cli import histo_savescore, histo_train

        return histo_train.main, histo_savescore.main
    if task == "feature":
        from multimodalbrainsurvival_torch.cli import feature_savescore, feature_train

        return feature_train.main, feature_savescore.main
    if task == "joint":
        from multimodalbrainsurvival_torch.cli import joint_savescore, joint_train

        return joint_train.main, joint_savescore.main
    raise ValueError(f"--task must be one of {TASKS}, got {task!r}")


def _read(path: str) -> dict:
    """A CSV as pandas holds it: a missing text value is missing
    (``read_frame`` gives a column one type; number columns are as
    pandas reads them)."""
    return {c: infer_column(v) if v and isinstance(v[0], str) else v
            for c, v in read_frame(path).items()}


def load_cohort(config) -> dict:
    """The frame to split: ``cv_csv_path``, or the train then the val rows."""
    if config.get("cv_csv_path"):
        return _read(config["cv_csv_path"])
    frames = [_read(config[k]) for k in ("train_csv_path", "val_csv_path")
              if config.get(k)]
    if not frames:
        raise ValueError("config needs cv_csv_path or train/val_csv_path")
    return concat_frames(frames)


def assign_folds(df: dict, k: int, seed: int) -> dict[str, int]:
    """case → fold index, the JAX package's map. Case-level, so a case's
    rows never straddle a fold boundary; stratified on the case's event
    indicator (its rows' largest ``vital_status``; a case with none is
    left out), so no fold is event-free: the strata in ascending order,
    each's cases (sorted) shuffled by ``default_rng(seed)``, then dealt
    round-robin from a random phase."""
    if "case" not in df:
        raise ValueError("cohort CSV needs a 'case' column for CV splitting")
    cases = as_text(df["case"])
    strata: dict = {c: 0 for c in sorted(set(cases))}
    if "vital_status" in df:
        strata = {c: None for c in strata}
        for c, v in zip(cases, df["vital_status"]):
            if not is_missing(v) and (strata[c] is None or v > strata[c]):
                strata[c] = v
    if len(strata) < k:
        raise ValueError(f"{len(strata)} cases cannot fill {k} folds")
    rng = np.random.default_rng(seed)
    fold_of: dict[str, int] = {}
    for value in sorted({v for v in strata.values() if v is not None}):
        ids = [c for c, v in strata.items() if v == value]
        rng.shuffle(ids)
        # round-robin with a random phase: each stratum spreads evenly over
        # the folds instead of always loading fold 0 first
        phase = int(rng.integers(k))
        for i, case in enumerate(ids):
            fold_of[case] = (i + phase) % k
    return fold_of


def fold_frame(output_dir: str, flag_k: str, split: str) -> dict | None:
    """One fold's saved ``<split>`` survival score frame, or None when the
    task wrote no survival frame (classification) or skipped the split."""
    matches = sorted(glob.glob(os.path.join(output_dir, f"*_{split}_*{flag_k}*_df.csv")))
    if not matches:
        return None
    frame = _read(matches[0])
    if not {"score", "survival_months", "vital_status"} <= set(frame):
        return None
    return frame


def frame_ci(frame: dict) -> float:
    ids = frame["id"] if "id" in frame else list(range(n_rows(frame)))
    ci, _ = survival_ci(np.asarray(frame["score"], np.float64), list(ids),
                        np.asarray(frame["survival_months"]),
                        np.asarray(frame["vital_status"]))
    return float(ci)


def ensemble_frames(frames: list[dict]) -> dict:
    """Average the fold models' risk scores per case, the usual deployment
    of a K-fold committee on a held-out cohort. Cases are inner-joined on
    ``id`` (a case missing from a fold's frame drops: every fold must have
    voted), in the first frame's order; ``score`` is the mean over the
    folds, the labels come from the first frame. The savescore frame's
    columns, so ``evaluate_scores`` and ``merge_scores`` read it."""
    if not frames:
        raise ValueError("no fold frames to ensemble")
    base = {c: frames[0][c] for c in ("id", "survival_months", "vital_status")}
    scores = None
    for k, frame in enumerate(frames):
        one = {"id": frame["id"], f"s{k}": frame["score"]}
        scores = one if scores is None else inner_merge(scores, one, "id")
    score_cols = [c for c in scores if c != "id"]
    out = inner_merge(scores, base, "id")
    mat = np.array([out[c] for c in score_cols], np.float64).reshape(len(score_cols), -1)
    # pandas' row mean: NaN skipped, the folds' scores summed in order
    with np.errstate(invalid="ignore"):
        mean = np.nansum(mat, axis=0) / (~np.isnan(mat)).sum(axis=0)
    return {"id": out["id"], "score": mean.tolist(),
            "survival_months": out["survival_months"], "vital_status": out["vital_status"]}


def _mean_std(values: list) -> tuple[float, float]:
    """Mean and population std, NaN for none."""
    if not values:
        return float("nan"), float("nan")
    return float(np.mean(values)), float(np.std(values))


def main(argv=None):
    parser = make_parser(__doc__)
    parser.add_argument("--task", type=str, required=True,
                        help=f"pipeline to cross-validate: {'/'.join(TASKS)}")
    parser.add_argument("--folds", type=int, default=5,
                        help="number of CV folds (config cv_folds overrides)")
    parser.add_argument("--no_savescore", type=int, default=0,
                        help="1 = train the folds only, skip score export")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    train_main, savescore_main = task_mains(args.task)
    config, flag = load_config(args)
    put, _, flag = make_device_put(config, device, flag)
    writes = put is None or put.mesh.rank == 0
    checkpoint_path = config.get("checkpoint_path", "checkpoints/")
    k = int(config.get("cv_folds", 0) or args.folds)

    df = load_cohort(config)
    fold_of = assign_folds(df, k, args.seed)
    folds = [fold_of.get(c) for c in as_text(df["case"])]
    # the cohort's rows as the fold CSVs write them (index=False), each
    # formatted once for all the folds
    header, lines = frame_lines(df, index=False)
    cv_dir = os.path.join(checkpoint_path, "cv")

    child_args = ["--seed", str(args.seed), "--device", args.device]
    if args.quick:
        child_args += ["--quick", "1"]

    rows = []
    for f in range(k):
        fold_dir = os.path.join(cv_dir, f"fold{f + 1}")
        train_csv = os.path.join(fold_dir, "train.csv")
        val_csv = os.path.join(fold_dir, "val.csv")
        val_rows = [i for i, g in enumerate(folds) if g == f]
        if writes:
            os.makedirs(fold_dir, exist_ok=True)
            for path, keep in ((train_csv, [i for i, g in enumerate(folds) if g != f]),
                               (val_csv, val_rows)):
                with open(path, "w", newline="") as fh:
                    fh.writelines([header] + [lines[i] for i in keep])

        flag_k = f"{flag}_cv{f + 1}"
        raw = {key: v for key, v in dict(config.raw).items() if not key.startswith("cv_")}
        raw.update(
            train_csv_path=train_csv,
            val_csv_path=val_csv,
            # an unseen test split stays fixed across folds when the base
            # config has one; else the fold's val split, so every train CLI
            # (which loads all three) still runs
            test_csv_path=config.get("test_csv_path") or val_csv,
            flag=flag_k,
        )
        cfg_path = os.path.join(fold_dir, "config_train.json")
        if writes:
            with open(cfg_path, "w") as fh:
                json.dump(raw, fh, indent=2)
        world_barrier(device)  # every rank's train CLI reads them

        n_val = len(val_rows)
        n_train = n_rows(df) - n_val
        print(f"=== fold {f + 1}/{k}: {n_train} train rows, "
              f"{n_val} val rows (flag {flag_k}) ===")
        train_main(["--config", cfg_path] + child_args)

        row = {"fold": f + 1, "flag": flag_k, "n_train_rows": n_train, "n_val_rows": n_val}
        if not args.no_savescore:
            output_dir = os.path.join(checkpoint_path, "outputs", flag_k)
            score_raw = dict(
                raw,
                model_path=os.path.join(checkpoint_path, "models", flag_k,
                                        "model_dict_best.pt"),
                restore_path="",
                output_path=output_dir,
            )
            score_path = os.path.join(fold_dir, "config_savescore.json")
            if writes:
                with open(score_path, "w") as fh:
                    json.dump(score_raw, fh, indent=2)
            savescore_main(["--config", score_path] + child_args)
            for split in ("val", "test") if writes else ():
                frame = fold_frame(output_dir, flag_k, split)
                if frame is not None:
                    row[f"{split}_CI"] = frame_ci(frame)
        rows.append(row)
    if not writes:
        return

    summary = records_frame(rows)
    for split in ("val", "test"):
        col = f"{split}_CI"
        if col in summary:
            # CI is NaN for a fold with no comparable pairs (tiny or fully
            # censored val split): report over the folds where it exists
            good = [v for v in summary[col] if not is_missing(v)]
            mean, std = _mean_std(good)
            print(f"CV {split} CI: {mean:.4f} +/- {std:.4f} over {len(good)}/{k} folds")
    out = os.path.join(checkpoint_path, "cv_summary.csv")
    write_frame(out, summary, index=False)
    print(f"wrote {out}")

    def fold_frames(split):
        frames = [fold_frame(os.path.join(checkpoint_path, "outputs", f"{flag}_cv{j + 1}"),
                             f"{flag}_cv{j + 1}", split) for j in range(k)]
        return [f for f in frames if f is not None]

    # out of fold: the fold val splits partition the cohort, so their
    # frames together score every case once, by the one model that never
    # saw it: the leak-free frame a merge_scores -> late_fusion stage
    # should train on
    if not args.no_savescore:
        val_frames = fold_frames("val")
        if val_frames and len(val_frames) == k:
            oof = concat_frames(val_frames)
            n_dup = n_rows(oof) - len(set(oof["id"]))
            if n_dup:  # cannot happen with assign_folds' partition
                print(f"warning: {n_dup} duplicate cases across fold val frames")
            oof_out = os.path.join(checkpoint_path, "cv_oof_val_df.csv")
            write_frame(oof_out, oof, index=False)
            print(f"CV out-of-fold val CI: {frame_ci(oof):.4f} over "
                  f"{n_rows(oof)} cases (pooled across {k} folds)")
            print("  note: Cox risk scores are rank-comparable only within "
                  "a fold; pooling mixes K model scales — compare against "
                  "the per-fold mean +/- std above")
            print(f"wrote {oof_out}")

    # fold ensemble: with a test split FIXED across folds, every fold
    # model's test scores averaged per case (the fold val splits are
    # disjoint cohorts: averaging them would mean nothing)
    if not args.no_savescore and config.get("test_csv_path"):
        frames = fold_frames("test")
        if frames and len(frames) == k:
            ens = ensemble_frames(frames)
            longest = max(n_rows(f) for f in frames)
            if n_rows(ens) < longest:
                print(f"ensemble dropped {longest - n_rows(ens)} "
                      "cases missing from some fold's frame")
            ens_out = os.path.join(checkpoint_path, "cv_ensemble_test_df.csv")
            write_frame(ens_out, ens, index=False)
            print(f"CV ensemble test CI: {frame_ci(ens):.4f} over {n_rows(ens)} cases "
                  f"({k} fold models averaged)")
            print(f"wrote {ens_out}")


if __name__ == "__main__":
    main()
