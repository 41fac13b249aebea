"""Pose-table readers: DeepLabCut (csv/h5) and SLEAP (analysis.h5/npy/slp)
(port of ``deepof_tpu/io/readers.py``).

Every reader lands in a :class:`RawTable` of dense ``(T, B, 2)`` positions
plus a ``(T, B)`` likelihood matrix, with multi-animal tables flattened to
``{animal_id}_{bodypart}`` names.

The machine with the card has no pandas and no h5py: the DLC csv reader
parses the file with numpy alone (pandas' header, index and NaN rules), and
h5py is imported only inside the two h5 readers, which raise an ImportError
naming it when it is absent.
"""

from __future__ import annotations

import csv
import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np


def natural_sorted(items: Sequence[str]) -> List[str]:
    """Natural (os-style) sort: digit runs compare numerically."""

    def key(s: str):
        return [
            int(tok) if tok.isdigit() else tok.lower()
            for tok in re.split(r"(\d+)", str(s))
        ]

    return sorted(items, key=key)


@dataclass
class RawTable:
    """One experiment's tracks in dense tensor form.

    Attributes:
        positions: (T, B, 2) float64 x/y pixel positions (NaN = missing).
        likelihood: (T, B) float64 tracking likelihoods.
        bodyparts: names per column of axis B, flattened multi-animal style
            ("{aid}_{bp}"), in file order.
        animal_ids: ids found in / implied by the file ([""] if single).
        has_individuals: whether the source table carried an explicit
            individuals header row.
    """

    positions: np.ndarray
    likelihood: np.ndarray
    bodyparts: List[str]
    animal_ids: List[str]
    has_individuals: bool = False

    def rename(self, mapping: Optional[Dict[str, str]]) -> "RawTable":
        """Apply a bodypart rename mapping (regex replace)."""
        if not mapping:
            return self
        renamed = []
        for bp in self.bodyparts:
            out = bp
            for old, new in mapping.items():
                out = re.sub(old, new, out)
            renamed.append(out)
        self.bodyparts = renamed
        return self

    def reorder(self, order: Sequence[str]) -> "RawTable":
        """Reorder columns to the given bodypart name order."""
        idx = [self.bodyparts.index(bp) for bp in order]
        return RawTable(
            positions=self.positions[:, idx],
            likelihood=self.likelihood[:, idx],
            bodyparts=list(order),
            animal_ids=self.animal_ids,
            has_individuals=self.has_individuals,
        )


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "Reading .h5 pose tables requires the 'h5py' package; export the "
            "tables as DeepLabCut .csv (or SLEAP .npy) instead."
        ) from e
    return h5py


def _decode(arr) -> List[str]:
    return [x.decode() if isinstance(x, bytes) else str(x) for x in arr]


def _read_pandas_fixed_frame(path: str):
    """A pandas 'fixed' HDF5 frame as DLC writes it (one float block with a
    2-4 level column MultiIndex), read with h5py.

    Returns (values (T, C) float64, column_tuples list of tuples).
    """
    h5py = _h5py()
    with h5py.File(path, "r") as f:
        g = f[next(iter(f.keys()))]
        nlevels = int(g.attrs.get("axis0_nlevels", 1))
        levels = [_decode(g[f"axis0_level{lvl}"][:]) for lvl in range(nlevels)]
        labels = [g[f"axis0_label{lvl}"][:].astype(np.int64) for lvl in range(nlevels)]
        columns = [
            tuple(levels[lvl][labels[lvl][c]] for lvl in range(nlevels))
            for c in range(len(labels[0]))
        ]
        values = np.asarray(g["block0_values"][:], dtype=np.float64)
        if "block0_items_label0" in g:
            bl_levels = [_decode(g[f"block0_items_level{lvl}"][:]) for lvl in range(nlevels)]
            bl_labels = [g[f"block0_items_label{lvl}"][:].astype(np.int64) for lvl in range(nlevels)]
            block_items = [
                tuple(bl_levels[lvl][bl_labels[lvl][c]] for lvl in range(nlevels))
                for c in range(len(bl_labels[0]))
            ]
            if block_items != columns:
                values = values[:, [block_items.index(c) for c in columns]]
    return values, columns


def _from_dlc_columns(values: np.ndarray, columns: List[tuple]) -> RawTable:
    """Assemble a RawTable from DLC-style column tuples (scorer,
    [individuals,] bodypart, coord): the scorer level is dropped and
    multi-animal bodyparts are prefixed with their individual id."""
    has_individuals = len(columns[0]) == 4

    per_bp: Dict[str, Dict[str, int]] = {}
    order: List[str] = []
    animal_ids: List[str] = []
    for ci, col in enumerate(columns):
        if has_individuals:
            _, indiv, bp, coord = col
            name = f"{indiv}_{bp}"
            if indiv not in animal_ids:
                animal_ids.append(indiv)
        else:
            _, bp, coord = col
            name = bp
        if name not in per_bp:
            per_bp[name] = {}
            order.append(name)
        per_bp[name][coord] = ci

    t = values.shape[0]
    positions = np.full((t, len(order), 2), np.nan)
    likelihood = np.zeros((t, len(order)))
    for bi, name in enumerate(order):
        cols = per_bp[name]
        positions[:, bi, 0] = values[:, cols["x"]]
        positions[:, bi, 1] = values[:, cols["y"]]
        if "likelihood" in cols:
            likelihood[:, bi] = values[:, cols["likelihood"]]
        else:
            likelihood[:, bi] = np.isfinite(positions[:, bi]).all(-1)

    return RawTable(
        positions=positions,
        likelihood=np.nan_to_num(likelihood, nan=0.0),
        bodyparts=order,
        animal_ids=animal_ids if has_individuals else [""],
        has_individuals=has_individuals,
    )


# pandas.read_csv's default NaN markers; an empty cell is one too.
_NA_CELL = re.compile(
    r"(?<=,)(?:#N/A N/A|#N/A|#NA|-1\.#IND|-1\.#QNAN|-NaN|-nan|1\.#IND|1\.#QNAN"
    r"|<NA>|N/A|NA|NULL|NaN|None|n/a|nan|null|)(?=,|$)",
    re.M,
)


def _read_dlc_csv(path: str) -> RawTable:
    """DLC csv: 2-3 meta header rows (scorer[, individuals], bodyparts),
    the coords row, then rows led by an integer frame index; what
    ``pd.read_csv(path, header=[0..n], index_col=0)`` reads, with numpy."""
    with open(path, newline="") as f:
        lines = f.read().splitlines()
    head = list(csv.reader(lines[:4]))
    has_individuals = "individuals" in [row[0] for row in head if row]
    n_header = 4 if has_individuals else 3
    header = head[:n_header]
    columns = list(zip(*(row[1:] for row in header)))
    body = lines[n_header:]
    if body and not body[0].split(",", 1)[-1].strip(","):
        body = body[1:]  # the index-name row pandas writes for a named index
    try:
        values = np.loadtxt(body, delimiter=",", dtype=np.float64, ndmin=2)
    except ValueError:  # empty cells or pandas' NaN markers other than nan
        body = _NA_CELL.sub("nan", "\n".join(body)).splitlines()
        values = np.loadtxt(body, delimiter=",", dtype=np.float64, ndmin=2)
    values = values[:, 1:] if values.size else np.zeros((0, len(columns)))
    if values.shape[1] != len(columns):
        raise ValueError(
            f"{path}: {len(columns)} header columns but {values.shape[1]} value columns"
        )
    return _from_dlc_columns(values, columns)


def _read_dlc_h5(path: str) -> RawTable:
    return _from_dlc_columns(*_read_pandas_fixed_frame(path))


def _from_sleap_array(
    tracks: np.ndarray,
    node_names: List[str],
    track_names: List[str],
    animal_ids: Optional[List[str]],
) -> RawTable:
    """tracks: (T, A, B, 2). Likelihood = finiteness (1.0 / 0.0)."""
    t, a, b, _ = tracks.shape
    ids = list(animal_ids) if animal_ids and animal_ids[0] else list(track_names)
    single = a == 1 and (not animal_ids or not animal_ids[0])

    likelihood = np.isfinite(tracks).all(axis=-1).astype(np.float64)  # (T, A, B)
    if single:
        return RawTable(tracks[:, 0], likelihood[:, 0], list(node_names), [""], has_individuals=False)

    names = [f"{ids[ai]}_{bp}" for ai in range(a) for bp in node_names]
    return RawTable(
        tracks.reshape(t, a * b, 2), likelihood.reshape(t, a * b), names, ids,
        has_individuals=True,
    )


def _read_sleap_analysis_h5(path: str, animal_ids) -> RawTable:
    h5py = _h5py()
    with h5py.File(path, "r") as f:
        tracks = np.transpose(f["tracks"][:], [3, 0, 2, 1]).astype(np.float64)
        node_names = _decode(f["node_names"][:])
        track_names = _decode(f["track_names"][:])
    return _from_sleap_array(tracks, node_names, track_names, animal_ids)


def _read_sleap_npy(path: str, bodyparts: List[str], animal_ids) -> RawTable:
    tracks = np.asarray(np.load(path), dtype=np.float64)  # (T, A, B, 2)
    if tracks.shape[2] != len(bodyparts):
        raise ValueError(
            f"The table has {tracks.shape[2]} bodyparts but {len(bodyparts)} "
            "names were provided via rename_bodyparts."
        )
    if animal_ids and animal_ids[0]:
        track_names = list(animal_ids)
    else:
        track_names = [str(i) for i in range(tracks.shape[1])]
    return _from_sleap_array(tracks, bodyparts, track_names, animal_ids)


def _read_slp(path: str, animal_ids) -> RawTable:
    try:
        import sleap_io as sio
    except ImportError as e:
        raise ImportError(
            "Reading .slp files requires the optional 'sleap-io' package; "
            "export your SLEAP project to .analysis.h5 or .npy instead."
        ) from e
    labels = sio.load_slp(path)
    node_names = [n.name for n in labels.skeletons[0].nodes]
    track_names = [t.name for t in labels.tracks]
    tracks = np.asarray(labels.numpy(), dtype=np.float64)
    return _from_sleap_array(tracks, node_names, track_names, animal_ids)


def load_table(
    tab: str,
    table_path: str,
    table_format: str,
    rename_bodyparts: Optional[Dict[str, str]] = None,
    animal_ids: Optional[List[str]] = None,
) -> RawTable:
    """Load one experiment's pose table into a RawTable.

    Args:
        tab: file name.
        table_path: directory containing the file.
        table_format: "h5" | "csv" | "npy" | "slp" | "analysis.h5".
        rename_bodyparts: mapping of file bodypart names to canonical names.
        animal_ids: animal ids (required for multi-animal npy).
    """
    path = os.path.join(table_path, tab)
    if table_format == "h5":
        raw = _read_dlc_h5(path)
    elif table_format == "csv":
        raw = _read_dlc_csv(path)
    elif table_format == "analysis.h5":
        raw = _read_sleap_analysis_h5(path, animal_ids)
    elif table_format == "npy":
        if not rename_bodyparts:
            raise ValueError(
                "Loading .npy tracks requires bodypart names via rename_bodyparts."
            )
        raw = _read_sleap_npy(path, list(rename_bodyparts.keys()), animal_ids)
        rename_bodyparts = {k: v for k, v in rename_bodyparts.items() if k != v}
    elif table_format == "slp":
        raw = _read_slp(path, animal_ids)
    else:
        raise NotImplementedError(
            "Tracking files must be in h5, csv, npy, slp or analysis.h5 format"
        )
    return raw.rename(rename_bodyparts)
