"""Experimental conditions and start markers from csv (port of
``deepof_tpu/io/conditions.py``).

Each experiment maps to a one-row :class:`ConditionTable` of its values.
The JAX package reads the file with ``pd.read_csv(index_col=0)``; the
machine with the card has no pandas, so the file is parsed with the
standard library's ``csv`` module under pandas' rules: the first column is
dropped (the index), the next holds the experiment ids, and each column's
type is inferred as a whole (all integers: int; all numbers: float, an
empty or NA cell making an integer column float; all booleans: bool; else
strings, NA cells staying NaN). Duplicate ids keep their first row.
"""

from __future__ import annotations

import csv
import re

import numpy as np

from deepof_tpu_torch.core.table_dict import seconds_to_time

# pandas' default NA strings (``pd.read_csv(na_values=None)``).
_NA = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND", "1.#QNAN", "<NA>",
    "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})
_INT = re.compile(r"[+-]?\d+")
_FLOAT = re.compile(r"[+-]?(?:(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?|inf|infinity)", re.IGNORECASE)
_TRUE, _FALSE = frozenset({"True", "TRUE", "true"}), frozenset({"False", "FALSE", "false"})
_TIME = re.compile(r"\d{1,6}:\d{1,6}:\d{1,6}(?:\.\d{1,9})?")


class ConditionTable(dict):
    """One experiment's row: ``{column: [value]}``, with ``columns`` in file
    order, as a one-row DataFrame answers ``df.columns`` and
    ``df[column].iloc[0]``."""

    @property
    def columns(self) -> list:
        return list(self)


def _column(tokens: list) -> list:
    """One csv column's values, typed as pandas infers the column: numbers
    tolerate surrounding spaces, NA strings are NaN."""
    present = [t for t in tokens if t not in _NA]
    has_na = len(present) < len(tokens)
    stripped = [t.strip() for t in present]
    if present and all(_INT.fullmatch(t) for t in stripped):
        if has_na:
            return [np.nan if t in _NA else float(t) for t in tokens]
        return [np.int64(t) if abs(int(t)) < 2**63 else int(t) for t in stripped]
    if present and all(_FLOAT.fullmatch(t) for t in stripped):
        return [np.nan if t in _NA else np.float64(t.strip()) for t in tokens]
    if present and all(t in _TRUE or t in _FALSE for t in present):
        # A boolean column with NA cells is an object column of Python bools.
        cast = bool if has_na else np.bool_
        return [np.nan if t in _NA else cast(t in _TRUE) for t in tokens]
    return [np.nan if t in _NA else t for t in tokens]


def _read_table(filepath: str):
    """(column names, typed columns) of a csv, its first column dropped."""
    with open(filepath, newline="") as f:
        rows = list(csv.reader(f))
    if not rows:
        raise ValueError(f"{filepath} is empty")
    header, body = rows[0], [r for r in rows[1:] if r]
    names, seen = [], {}
    for i, name in enumerate(header):
        name = name or f"Unnamed: {i}"
        if name in seen:  # pandas mangles repeated names: a, a.1, a.2
            seen[name] += 1
            name = f"{name}.{seen[name]}"
        else:
            seen[name] = 0
        names.append(name)
    for r in body:
        if len(r) > len(header):
            raise ValueError(f"{filepath}: a row has {len(r)} fields, the header {len(header)}")
    columns = [_column([r[i] if i < len(r) else "" for r in body]) for i in range(len(header))]
    if len(names) < 2:
        raise ValueError(f"{filepath} needs an index column and an experiment id column")
    return names[1:], columns[1:]


def _load_conditions_csv(filepath: str) -> dict:
    """{experiment id: ConditionTable of the other columns}."""
    names, columns = _read_table(filepath)
    ids = columns[0]
    out = {}
    for exp_id in ids:
        rows = [i for i, v in enumerate(ids) if v == exp_id]
        if not rows:  # a NaN id matches no row
            raise ValueError(f"Conditions could not be loaded: experiment id {exp_id!r} matches no row")
        i = rows[0]
        if exp_id not in out:
            out[exp_id] = ConditionTable((name, [col[i]]) for name, col in zip(names[1:], columns[1:]))
    return {k.item() if isinstance(k, np.generic) else k: v for k, v in out.items()}


def load_exp_conditions(filepath: str) -> dict:
    """Experimental conditions from a csv; every value must be a string."""
    conditions = _load_conditions_csv(filepath)
    for table in conditions.values():
        for column in table.columns:
            if not isinstance(table[column][0], str):
                raise ValueError("Condition values need to be strings!")
    return conditions


def load_start_markers(filepath: str, frame_rate: float) -> dict:
    """Start markers from a csv: each value a frame integer (turned into
    "HH:MM:SS.sssssssss" at ``frame_rate``) or an "HH:MM:SS(.sss)" string
    (quotes and spaces stripped)."""
    markers = _load_conditions_csv(filepath)
    for table in markers.values():
        for column in table.columns:
            raw = table[column][0]
            value = raw.strip().strip('"').strip("'") if isinstance(raw, str) else raw
            is_frame = isinstance(value, (int, np.integer))
            is_time = isinstance(value, str) and _TIME.fullmatch(value)
            if not (is_frame or is_time):
                raise ValueError('Start markers must be frame integers or time strings ("xx:xx:xx.xxx").')
            if is_frame:
                value = seconds_to_time(value / frame_rate, cut_milliseconds=False)
            table[column] = [value]
    return markers
