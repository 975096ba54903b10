"""Pre-flight cohort and data validation, before a training job starts.

The port's own copy of ``multimodalbrainsurvival_tpu/cli/validate_data.py``
without pandas: the same checks, ``ERROR`` / ``WARN`` lines and summary.
The reference validates nothing: a missing ``survival_bin`` column crashes
mid-epoch (``2_HistoPath_train.py:313``), a truncated patch directory
raises deep inside a loader, and a train/val case overlap silently
inflates every C-index. No device work, so no ``--device``::

    python -m multimodalbrainsurvival_torch.cli.validate_data \\
        --config config_ffpe_train.json --task histo

Checks, per split CSV (``{train,val,test}_csv_path``):

- the file exists and parses; the label columns the config's task needs
  (``case`` + ``survival_months`` / ``vital_status`` for Cox,
  ``survival_bin`` too for the discrete task, ``target_label`` for
  classification); NaN labels, negative survival months, vital status
  outside {0, 1}, non-integer survival bins; a split with no event warns;
- modality columns: the ``rna_`` / ``feature_`` column count and their
  NaN / non-finite values; for RNA, the width and order against the gene
  vocabulary (``data/genes.py``): an explicit ``--genes`` file is a
  contract (a mismatch is an error), the implicit reference default is
  advisory (a mismatch warns);
- histo / joint: every ``wsi_file_name``'s patch directory with its
  ``loc.txt``, the PNGs (or a packed ``patches.npy`` no older than
  ``loc.txt``; a shorter one is an error, a stale one falls back to the
  PNG check, as the loader does) that ``loc.txt`` promises, and slides
  whose usable patches fall below ``bag_size`` (their bags drop);
- across splits: case leakage between train / val / test, and duplicate
  ``wsi_file_name`` rows within a split.

The exit status is 1 if and only if an error was found (warnings pass).
"""

from __future__ import annotations

import csv
import math
import os
import sys

import numpy as np

from multimodalbrainsurvival_torch.cli._common import make_parser
from multimodalbrainsurvival_torch.config import Config
from multimodalbrainsurvival_torch.data.genes import REFERENCE_GENES_TXT, GeneVocabulary
from multimodalbrainsurvival_torch.frames import (
    NA_STRINGS,
    as_text,
    is_missing,
    n_rows,
    read_frame,
)

TASKS = ("histo", "rna", "feature", "joint")


class Report:
    def __init__(self) -> None:
        self.errors: list[str] = []
        self.warnings: list[str] = []

    def error(self, msg: str) -> None:
        self.errors.append(msg)
        print(f"ERROR: {msg}")

    def warn(self, msg: str) -> None:
        self.warnings.append(msg)
        print(f"WARN: {msg}")


def _to_numeric(values: list) -> np.ndarray:
    """``pd.to_numeric(column, errors="coerce")`` as float64: text that is
    not a number is NaN; ``True`` / ``False`` (a bool column) are 1 / 0.
    ``read_frame`` gives a column one type: a number column converts at
    once."""
    if not values or not isinstance(values[0], str):
        return np.asarray(values, np.float64)
    out = np.empty(len(values), np.float64)
    for i, v in enumerate(values):
        if isinstance(v, str):
            v = {"True": 1.0, "False": 0.0}.get(v, v)
            try:
                v = math.nan if v in NA_STRINGS else float(v)
            except (TypeError, ValueError):
                v = math.nan
        out[i] = v
    return out


def _check_labels(df: dict, split: str, task: str, target_label: str,
                  rep: Report) -> None:
    required = ["case"]
    if task == "survival_prediction":
        required += ["survival_months", "vital_status"]
    elif task == "survival_bin":
        # the histo training script reads survival_bin unconditionally AND the Cox
        # labels for the CI metric (2_HistoPath_train.py:313, :184-209)
        required += ["survival_months", "vital_status", "survival_bin"]
    elif task == "classification":
        required += [target_label]
    missing = [c for c in required if c not in df]
    if missing:
        rep.error(f"{split}: missing required columns: {', '.join(missing)}")
        return
    for col in required:
        n_nan = sum(map(is_missing, df[col]))
        if n_nan:
            rep.error(f"{split}: {n_nan} NaN values in '{col}'")
    if "survival_months" in required:
        neg = int((_to_numeric(df["survival_months"]) < 0).sum())
        if neg:
            rep.error(f"{split}: {neg} negative survival_months values")
    if "vital_status" in required:
        status = _to_numeric(df["vital_status"])
        bad = int((~np.isin(status, [0, 1])).sum())
        if bad:
            rep.error(f"{split}: {bad} vital_status values outside {{0, 1}}")
        elif int(np.nansum(status)) == 0:
            rep.warn(f"{split}: fully censored split (zero events) — the Cox "
                     "loss is identically zero and the C-index undefined")
    if "survival_bin" in required:
        bins = _to_numeric(df["survival_bin"])
        bins = bins[~np.isnan(bins)]
        if not np.array_equal(bins, bins.astype(int)):
            rep.error(f"{split}: non-integer survival_bin values")


def _check_modality(df: dict, split: str, prefix: str, vocab,
                    rep: Report, *, vocab_strict: bool = True) -> None:
    cols = [c for c in df if prefix in str(c)]
    if not cols:
        rep.error(f"{split}: no '{prefix}' columns found")
        return
    mat = np.stack([_to_numeric(df[c]) for c in cols], axis=1)
    n_bad = int((~np.isfinite(mat)).sum())
    if n_bad:
        rep.error(f"{split}: {n_bad} NaN/non-finite values across the "
                  f"{len(cols)} '{prefix}' columns")
    if vocab is not None and prefix == "rna_":
        if len(cols) != len(vocab):
            # an explicit --genes vocabulary is a contract (error); the
            # implicit reference default is advisory for non-reference
            # cohorts (warn)
            report = rep.error if vocab_strict else rep.warn
            report(f"{split}: {len(cols)} 'rna_' columns but the gene "
                   f"vocabulary defines {len(vocab)} genes")
        else:
            syms = [c.split("rna_", 1)[-1] for c in cols]
            mismatched = sum(1 for s, v in zip(syms, vocab.symbols) if s != v)
            if mismatched:
                rep.warn(f"{split}: {mismatched}/{len(cols)} rna_ columns "
                         "out of vocabulary order (models trained on the "
                         "canonical order need data/genes.reorder)")


def _check_patches(df: dict, split: str, data_path: str,
                   bag_size: int, max_total: int, rep: Report) -> None:
    if "wsi_file_name" not in df:
        rep.error(f"{split}: missing required column 'wsi_file_name'")
        return
    names = as_text(df["wsi_file_name"])
    n_dup = len(names) - len(set(names))
    if n_dup:
        rep.error(f"{split}: {n_dup} duplicate wsi_file_name rows "
                  "(the last row silently wins in the bag index)")
    for name in names:
        wsi = name.split(".")[0]
        d = os.path.join(data_path, wsi)
        loc = os.path.join(d, "loc.txt")
        if not os.path.isdir(d):
            rep.error(f"{split}: patch directory missing for {name}: {d}")
            continue
        if not os.path.isfile(loc):
            rep.error(f"{split}: {wsi}: no loc.txt in {d}")
            continue
        with open(loc) as f:
            n = sum(1 for _ in f) - 2  # two header lines (models.py:258)
        if n <= 0:
            rep.error(f"{split}: {wsi}: loc.txt promises no patches (n={n})")
            continue
        usable = min(n, max_total)
        packed = os.path.join(d, "patches.npy")
        # the loader's branch (data/patches.py): a shard older than loc.txt
        # is ignored and the PNGs are read, so those are what to check
        if os.path.isfile(packed) and os.path.getmtime(packed) >= os.path.getmtime(loc):
            try:
                n_packed = len(np.load(packed, mmap_mode="r"))
            except (OSError, ValueError) as e:  # a corrupt shard
                rep.error(f"{split}: {wsi}: unreadable patches.npy ({e})")
                n_packed = None
            if n_packed is not None and n_packed < usable:
                rep.error(f"{split}: {wsi}: patches.npy holds {n_packed} "
                          f"patches but loc.txt promises {n}")
        else:
            # the bag index builds paths 0..usable-1; check the endpoints
            for i in (0, usable - 1):
                p = os.path.join(d, f"{wsi}_patch_{i}.png")
                if not os.path.isfile(p):
                    rep.error(f"{split}: {wsi}: loc.txt promises {n} patches "
                              f"but {os.path.basename(p)} is missing")
                    break
        if usable < bag_size:
            rep.warn(f"{split}: {wsi}: only {usable} usable patches < "
                     f"bag_size {bag_size} — every bag drops "
                     "(models.py:266-267), the slide never trains")


def main(argv=None) -> int:
    parser = make_parser(__doc__, device=False)
    parser.add_argument("--task", type=str, required=True,
                        help=f"pipeline to validate: {'/'.join(TASKS)}")
    parser.add_argument("--genes", type=str, default="",
                        help="gene vocabulary file (default: the reference "
                             "genes.txt when present; '' skips the check)")
    args = parser.parse_args(argv)
    if args.task not in TASKS:
        raise SystemExit(f"unknown --task {args.task!r}; one of {TASKS}")
    config = Config.from_json(args.config)
    task = config.get("task", "survival_prediction")
    target_label = config.get("target_label", "label")
    rep = Report()

    vocab = None
    if args.task in ("rna", "joint"):
        genes_path = args.genes or (
            REFERENCE_GENES_TXT if os.path.isfile(REFERENCE_GENES_TXT) else "")
        if genes_path:
            vocab = GeneVocabulary.from_file(genes_path)
            print(f"gene vocabulary: {genes_path} ({len(vocab)} genes)")

    cases: dict[str, set] = {}
    for split in ("train", "val", "test"):
        key = f"{split}_csv_path"
        path = config.get(key, "")
        if not path:
            rep.warn(f"{key} not set — split skipped")
            continue
        if not os.path.isfile(path):
            rep.error(f"{key}: no such file: {path}")
            continue
        try:
            df = read_frame(path)
        except (OSError, UnicodeDecodeError, IndexError, ValueError, csv.Error) as e:
            rep.error(f"{key}: unreadable CSV ({e})")
            continue
        rows = n_rows(df)
        print(f"-- {split}: {path} ({rows} rows)")
        if not rows:
            rep.error(f"{split}: empty cohort")
            continue
        _check_labels(df, split, task, target_label, rep)
        if "case" in df:
            cases[split] = set(as_text(df["case"]))
        if args.task in ("rna", "joint"):
            _check_modality(df, split, "rna_", vocab, rep, vocab_strict=bool(args.genes))
        if args.task == "feature":
            _check_modality(df, split, "feature_", None, rep)
        if args.task in ("histo", "joint"):
            data_path = config.get("data_path", "")
            if not data_path:
                rep.error("config has no data_path (patch root)")
            else:
                # test reuses the val caps, like the histo training CLI
                which = "train" if split == "train" else "val"
                bag = int(config.get(f"{which}_bag_size", 1))
                max_total = int(config.get(f"max_patch_per_wsi_{which}", 1000))
                _check_patches(df, split, data_path, bag, max_total, rep)

    for a, b in (("train", "val"), ("train", "test"), ("val", "test")):
        overlap = cases.get(a, set()) & cases.get(b, set())
        if overlap:
            rep.error(f"case leakage: {len(overlap)} cases appear in both "
                      f"{a} and {b} (e.g. {sorted(overlap)[:3]})")

    print(f"validation: {len(rep.errors)} error(s), "
          f"{len(rep.warnings)} warning(s)")
    if rep.errors:
        return 1
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
