"""Column helpers of the port (its own copy of
``deepof_tpu/utils.py`` ``filter_columns``)."""

from __future__ import annotations

from typing import Optional


def filter_columns(columns, selected_id: Optional[str], table_type: str = None) -> list:
    """The columns that belong to one animal: a string column that starts
    with ``selected_id`` (or, for supervised tables, contains it); a
    (bodypart, "x"|"y"|"rho"|"phi") column of its bodypart; a pair or a
    triple whose every part is its; a phenotype column."""
    if selected_id is None:
        return list(columns)
    keep = []
    for column in columns:
        if isinstance(column, str):
            if table_type == "supervised" and selected_id in column:
                keep.append(column)
            elif column.startswith(selected_id):
                keep.append(column)
            continue
        if column[0].startswith(selected_id) and column[1] in ("x", "y", "rho", "phi"):
            keep.append(column)
        elif len(column) in (2, 3) and all(str(c).startswith(selected_id) for c in column):
            keep.append(column)
        elif str(column[0]).lower().startswith("pheno"):
            keep.append(column)
    return keep
