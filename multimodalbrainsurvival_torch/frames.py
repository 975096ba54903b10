"""CSV frames read and written the way pandas does it, without pandas.

A frame is ``{column: values}``, the columns in order; every column holds
one Python type, as ``pd.read_csv`` infers it: ``int``, ``float`` (a
missing value is NaN) or ``str``.
"""

from __future__ import annotations

import csv
import math

#: the strings ``pd.read_csv`` reads as a missing value (its default
#: ``na_values``)
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null",
})


def _format(v):
    if isinstance(v, float):
        return "" if math.isnan(v) else repr(float(v))
    return v


def write_frame(path: str, frame: dict, *, index: bool = True,
                header: bool = True) -> None:
    """Write ``{column: values}`` as ``DataFrame(frame).to_csv(path,
    index=index, header=header)`` does, byte for byte: with ``index``, an
    unnamed leading column of row numbers; floats as ``repr``, NaN as an
    empty field; ``\n`` line ends."""
    columns = list(frame)
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        if header:
            w.writerow([""] * index + columns)
        for i, row in enumerate(zip(*(frame[c] for c in columns))):
            w.writerow([i] * index + [_format(v) for v in row])


def _parse_column(values: list[str]) -> list:
    try:
        return [int(v) for v in values]
    except ValueError:
        pass
    try:
        out = [math.nan if v in NA_STRINGS else float(v) for v in values]
    except ValueError:
        return values
    # a column of missing values only is float (all NaN); one with a number
    return out


def _column_names(names: list[str]) -> list[str]:
    """pandas' header names: an empty one is ``Unnamed: <position>``, a
    repeated one gets ``.1``, ``.2``, …"""
    out, seen = [], {}
    for i, name in enumerate(names):
        name = name or f"Unnamed: {i}"
        base, k = name, seen.get(name, 0)
        while name in seen:
            k += 1
            name = f"{base}.{k}"
        seen[base] = k
        seen[name] = 0
        out.append(name)
    return out


def read_frame(path: str, *, header: bool = True) -> dict:
    """``pd.read_csv(path, header=0 if header else None)`` as a frame: with
    no header the columns are ``0, 1, …``; a UTF-8 BOM is stripped."""
    with open(path, newline="", encoding="utf-8-sig") as f:
        rows = list(csv.reader(f))
    if header:
        names, rows = _column_names(rows[0]), rows[1:]
    else:
        names = list(range(len(rows[0]))) if rows else []
    return {name: _parse_column([r[j] for r in rows]) for j, name in enumerate(names)}


def n_rows(frame: dict) -> int:
    return len(next(iter(frame.values()), []))


def inner_merge(left: dict, right: dict, on: str) -> dict:
    """``left.merge(right, how="inner", on=on)``: the left rows in order,
    each once per right row with its key, in the right's order; the left's
    columns (the key where the left has it), then the right's others; a
    column name in both gets ``_x`` (left) and ``_y`` (right)."""
    matches: dict = {}
    for j, key in enumerate(right[on]):
        matches.setdefault(key, []).append(j)
    pairs = [(i, j) for i, key in enumerate(left[on]) for j in matches.get(key, ())]
    both = (set(left) & set(right)) - {on}

    def name(col, suffix):
        return f"{col}{suffix}" if col in both else col

    out = {name(c, "_x"): [v[i] for i, _ in pairs] for c, v in left.items()}
    out.update({name(c, "_y"): [v[j] for _, j in pairs]
                for c, v in right.items() if c != on})
    return out
