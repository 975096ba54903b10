"""CSV frames read and written the way pandas does it, without pandas.

A frame is ``{column: values}``, the columns in order; every column holds
one Python type, as ``pd.read_csv`` infers it: ``int``, ``float`` (a
missing value is NaN) or ``str``.
"""

from __future__ import annotations

import csv
import io
import math
import numbers

import numpy as np

#: the strings ``pd.read_csv`` reads as a missing value (its default
#: ``na_values``)
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null",
})


def is_missing(v) -> bool:
    """A missing value as ``pd.read_csv`` reads it: NaN in a number column,
    one of its NA strings in a text column (``read_frame`` keeps a text
    column's strings as they are)."""
    return (isinstance(v, float) and math.isnan(v)) or (isinstance(v, str) and v in NA_STRINGS)


def as_text(values) -> list[str]:
    """``column.astype(str)``: a missing value is ``"nan"``, a number its
    text."""
    return ["nan" if is_missing(v) else str(v) for v in values]


def _format_column(values) -> list:
    """A column's fields: floats (numpy's too) as ``repr``, NaN empty."""
    values = list(values)
    if all(type(v) is float for v in values):
        return ["" if v != v else repr(v) for v in values]
    return ["" if v != v else float.__repr__(v) if isinstance(v, float) else v
            for v in values]


def frame_lines(frame: dict, *, index: bool = True) -> tuple[str, list[str]]:
    """The header line and each row's line of ``DataFrame(frame).to_csv(
    index=index)``: a file of the header and any of the rows, in any
    order, is that of the frame of those rows."""
    columns = [_format_column(v) for v in frame.values()]
    if index:
        columns.insert(0, range(n_rows(frame)))
    buf = io.StringIO()
    w = csv.writer(buf, lineterminator="\n")

    def line(fields) -> str:
        buf.seek(0)
        buf.truncate()
        w.writerow(fields)
        return buf.getvalue()

    return line([""] * index + list(frame)), [line(row) for row in zip(*columns)]


def write_frame(path: str, frame: dict, *, index: bool = True,
                header: bool = True) -> None:
    """Write ``{column: values}`` as ``DataFrame(frame).to_csv(path,
    index=index, header=header)`` does, byte for byte: with ``index``, an
    unnamed leading column of row numbers; floats as ``repr``, NaN as an
    empty field; ``\n`` line ends."""
    head, lines = frame_lines(frame, index=index)
    with open(path, "w", newline="") as f:
        f.writelines(([head] if header else []) + lines)


def _parse_column(values) -> list:
    try:
        return list(map(int, values))
    except ValueError:
        pass
    try:
        return list(map(float, values))
    except ValueError:
        pass
    try:
        # a column of missing values only is float (all NaN); one with a number
        return [math.nan if v in NA_STRINGS else float(v) for v in values]
    except ValueError:
        return list(values)


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
    if all(len(r) == len(names) for r in rows):
        columns = list(zip(*rows)) if rows else [()] * len(names)
    else:  # ragged rows: a short one raises, as it did before
        columns = [[r[j] for r in rows] for j in range(len(names))]
    return {name: _parse_column(col) for name, col in zip(names, columns)}


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


def infer_column(values: list) -> list:
    """The column pandas makes of ``values`` (Python or numpy scalars,
    ``None``, NaN or an NA string where missing), as ``to_csv`` writes it:
    integers with a missing value or a float become floats (the missing
    ones NaN); anything else (text, bools) stays as it is, a missing text
    value ``None`` (an empty field)."""
    kinds = set(map(type, values))
    if kinds <= {int} or kinds <= {float}:
        return list(values)
    if str in kinds:
        values = [None if type(v) is str and v in NA_STRINGS else v for v in values]
    if not any(isinstance(v, (bool, np.bool_)) for v in values) and all(
            v is None or isinstance(v, numbers.Real) for v in values):
        if all(isinstance(v, numbers.Integral) for v in values):
            return [int(v) for v in values]
        return [math.nan if v is None else float(v) for v in values]
    return list(values)


def concat_frames(frames: list[dict]) -> dict:
    """``pd.concat(frames, ignore_index=True)``: the columns in order of
    first appearance, a column a frame lacks missing in its rows, each
    column's type as ``infer_column`` gives it."""
    columns = list(dict.fromkeys(c for f in frames for c in f))
    out = {}
    for c in columns:
        values = []
        for f in frames:
            values.extend(f[c] if c in f else [None] * n_rows(f))
        out[c] = infer_column(values)
    return out


def records_frame(records: list[dict]) -> dict:
    """``pd.DataFrame(records)``: one row a dict, the columns in order of
    first appearance, a key a record lacks missing there."""
    columns = list(dict.fromkeys(c for r in records for c in r))
    return {c: infer_column([r.get(c) for r in records]) for c in columns}
