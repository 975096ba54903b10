"""CSV frames written the way pandas writes them, without pandas."""

from __future__ import annotations

import csv


def write_frame(path: str, frame: dict[str, list], *, index: bool = True) -> None:
    """Write ``{column: values}`` as ``DataFrame(frame).to_csv(path,
    index=index)`` does, byte for byte: with ``index``, an unnamed leading
    column of row numbers; floats as ``repr``; ``\n`` line ends."""
    columns = list(frame)
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow([""] * index + columns)
        for i, row in enumerate(zip(*(frame[c] for c in columns))):
            w.writerow([i] * index
                       + [repr(v) if isinstance(v, float) else v for v in row])
