"""Tabular (CSV) datasets: RNA expression and early-fusion features.

The port's own copy of ``multimodalbrainsurvival_tpu/data/tables.py:29-116``
(reference ``2_GeneExpression/datasets.py:11-52`` ``RNADataset`` and
``3_EarlyFusion``'s ``featureDataset``): every column whose name CONTAINS
``"rna_"`` (12,778 at the reference width), or ``"feature_"`` (4,096: the
histo and RNA embeddings side by side), is a feature, the other columns are
labels and ids. The whole CSV becomes one
contiguous (N, D) float32 matrix, and batches are statically shaped padded
slices with a validity mask.

No pandas (the machine with the card has none): the header is read with
``csv`` (a UTF-8 BOM stripped), the feature block with ``np.loadtxt`` (its C
parser; linear in the width) and the few other columns with a second
``np.loadtxt`` pass as strings.
"""

from __future__ import annotations

import csv
from typing import Iterator

import numpy as np

LABEL_FLOAT_KEYS = ("survival_months", "vital_status")
LABEL_INT_KEYS = ("survival_bin", "label", "grade_binary")


def _read_columns(path: str, usecols: list[int], dtype) -> np.ndarray:
    return np.loadtxt(path, delimiter=",", skiprows=1, usecols=usecols,
                      dtype=dtype, ndmin=2, encoding="utf-8", quotechar='"')


class TableDataset:
    """CSV → contiguous feature matrix + label arrays + case ids."""

    def __init__(self, csv_path: str, feature_substring: str):
        with open(csv_path, newline="", encoding="utf-8") as f:
            columns = [c.lstrip("\ufeff") for c in next(csv.reader(f))]
        feat_idx = [i for i, c in enumerate(columns) if feature_substring in c]
        if not feat_idx:
            raise ValueError(f"No '{feature_substring}' columns found in {csv_path}")
        self.feature_columns = [columns[i] for i in feat_idx]
        self.features = _read_columns(csv_path, feat_idx, np.float32).reshape(
            -1, len(feat_idx))
        feat = set(feat_idx)
        other = [i for i in range(len(columns)) if i not in feat]
        text = (_read_columns(csv_path, other, str).reshape(-1, len(other))
                if other else np.zeros((len(self.features), 0), str))
        by_name = {columns[i]: text[:, j] for j, i in enumerate(other)}
        self.labels_float: dict[str, np.ndarray] = {
            k: by_name[k].astype(np.float64).astype(np.float32)
            for k in LABEL_FLOAT_KEYS if k in by_name
        }
        self.labels_int: dict[str, np.ndarray] = {
            k: by_name[k].astype(np.float64).astype(np.int32)
            for k in LABEL_INT_KEYS if k in by_name
        }
        self.case = ([str(c) for c in by_name["case"]] if "case" in by_name
                     else [str(i) for i in range(len(self.features))])

    def __len__(self) -> int:
        return len(self.features)

    @property
    def feature_dim(self) -> int:
        return self.features.shape[1]

    def batches(
        self,
        batch_size: int,
        *,
        shuffle: bool = False,
        seed: int | None = None,
        pad: bool = True,
        skip_batches: int = 0,
    ) -> Iterator[dict]:
        """Yield dicts of statically shaped numpy batches.

        Keys: ``data`` (B, D) f32, ``mask`` (B,) bool, every label array
        present in the CSV, and ``case`` (list of ids, padded with "").
        A shuffle permutes the rows with ``np.random.default_rng(seed)``, as
        the JAX package does, so both stacks see the same batches.
        ``skip_batches`` drops the first k batches of the epoch order.
        """
        n = len(self)
        order = np.arange(n)
        if shuffle:
            rng = np.random.default_rng(seed)
            rng.shuffle(order)
        for start in range(skip_batches * batch_size, n, batch_size):
            idx = order[start : start + batch_size]
            b = len(idx)
            out: dict = {}
            pad_to = batch_size if pad else b
            data = np.zeros((pad_to, self.feature_dim), np.float32)
            data[:b] = self.features[idx]
            mask = np.zeros((pad_to,), bool)
            mask[:b] = True
            out["data"] = data
            out["mask"] = mask
            for k, arr in {**self.labels_float, **self.labels_int}.items():
                buf = np.zeros((pad_to,), arr.dtype)
                buf[:b] = arr[idx]
                out[k] = buf
            out["case"] = [self.case[i] for i in idx] + [""] * (pad_to - b)
            yield out


class RNATableDataset(TableDataset):
    """Parity with ``RNADataset``: features are the ``'rna_'`` columns."""

    def __init__(self, csv_path: str):
        super().__init__(csv_path, "rna_")


class FeatureTableDataset(TableDataset):
    """Parity with ``featureDataset``: features are the ``'feature_'``
    columns."""

    def __init__(self, csv_path: str):
        super().__init__(csv_path, "feature_")
