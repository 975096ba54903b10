"""Gene vocabulary: the ordered index → symbol table of the RNA layout.

The port's own copy of ``multimodalbrainsurvival_tpu/data/genes.py``,
without pandas: the reference ships ``2_GeneExpression/genes.txt`` (12,779
lines with the header) as the order of the 12,778-gene input vector. This
module reads that format, checks an RNA table's width against it, and
reorders a frame's expression columns into vocabulary order, so a model
trained on one column order can score data stored in another.

``REFERENCE_GENES_TXT`` is where a checkout of the reference would put
that file beside the repository (``reference/2_GeneExpression/genes.txt``
under the repository's root); it need not exist, and when it does not the
default vocabulary check of ``cli/validate_data.py`` is skipped.
"""

from __future__ import annotations

import os

import numpy as np

REFERENCE_GENES_TXT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "reference", "2_GeneExpression", "genes.txt")


class GeneVocabulary:
    def __init__(self, symbols: list[str]):
        self.symbols = list(symbols)
        self.index = {s: i for i, s in enumerate(self.symbols)}

    @classmethod
    def from_file(cls, path: str) -> "GeneVocabulary":
        """Reads the reference genes.txt format: a CSV with a header line and
        ``index,symbol`` rows (``2_GeneExpression/genes.txt``); plain
        one-symbol-per-line files are accepted too."""
        with open(path) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        symbols = [ln.split(",")[-1] for ln in lines[1:]]  # drop header
        return cls(symbols)

    def __len__(self) -> int:
        return len(self.symbols)

    def __contains__(self, symbol: str) -> bool:
        return symbol in self.index

    def validate_width(self, n_rna_columns: int) -> None:
        if n_rna_columns != len(self):
            raise ValueError(
                f"RNA input has {n_rna_columns} 'rna_' columns but the gene "
                f"vocabulary defines {len(self)} genes"
            )

    def reorder(self, frame: dict, column_to_symbol) -> np.ndarray:
        """(N, G) float32 matrix in vocabulary order from a ``frames.py``
        frame (``{column: values}``) whose RNA columns map to symbols via
        ``column_to_symbol(col) -> symbol``."""
        cols = {}
        for c in frame:
            sym = column_to_symbol(c)
            if sym is not None and sym in self.index:
                cols[self.index[sym]] = c
        missing = len(self) - len(cols)
        if missing:
            raise ValueError(f"{missing} vocabulary genes missing from frame")
        ordered = [cols[i] for i in range(len(self))]
        return np.array([frame[c] for c in ordered], np.float32).T.reshape(-1, len(self))
