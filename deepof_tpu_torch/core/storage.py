"""Table storage of a TableDict value (port of ``deepof_tpu/core/storage.py``,
in-memory mode), and the column-addressed device tables of the supervised
rules.

A TableDict value is the object itself, a :class:`LazyFrame` (a frame whose
values still live on the device, realised on first access) or a
:class:`LazyWindows` (window tensors realised on first access). The JAX
package realises frames as ``pd.DataFrame``; here a frame is a float64
numpy array and its columns are a list beside it. Paths mode (values stored
in files and passed around as pointers, for very large projects) is not
ported.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

PATHS_MODE = (
    "paths mode (tables stored in files, return_path / save_as_paths, very large "
    "projects) is not ported yet: ROADMAP queue 1 item 2"
)


class LazyFrame:
    """A (T, F) frame realised to a float64 numpy array on first access;
    ``columns`` and ``shape`` answer without realising it."""

    __slots__ = ("_realize", "_columns", "_nrows", "_cache")

    def __init__(self, realize_fn, columns, nrows: int):
        self._realize = realize_fn
        self._columns = list(columns)
        self._nrows = int(nrows)
        self._cache = None

    @property
    def columns(self) -> list:
        return self._columns

    @property
    def shape(self) -> Tuple[int, int]:
        return (self._nrows, len(self._columns))

    def realize(self) -> np.ndarray:
        if self._cache is None:
            self._cache = np.asarray(self._realize(), np.float64)
        return self._cache

    def __getstate__(self):  # pickle: realise (device tensors stay behind)
        return {"frame": self.realize(), "columns": self._columns}

    def __setstate__(self, state):
        frame = state["frame"]
        self._realize = lambda: frame
        self._columns = state["columns"]
        self._nrows = len(frame)
        self._cache = frame


class LazyWindows:
    """Windowed ``(nodes, edges, angles)`` tensors realised on first access;
    ``shapes`` answers without realising them."""

    __slots__ = ("_realize_fn", "_shapes", "_cache")

    def __init__(self, realize_fn, shapes):
        self._realize_fn = realize_fn
        self._shapes = tuple(tuple(int(d) for d in s) for s in shapes)
        self._cache = None

    @property
    def shapes(self):
        return self._shapes

    def realize(self) -> tuple:
        if self._cache is None:
            self._cache = tuple(self._realize_fn())
        return self._cache

    def __getstate__(self):
        return {"windows": self.realize()}

    def __setstate__(self, state):
        windows = state["windows"]
        self._realize_fn = lambda: windows
        self._shapes = tuple(np.shape(w) for w in windows)
        self._cache = windows


class DeviceTable:
    """A (T, C) tensor whose columns are addressed by label, kept on its
    device: the tables the supervised rules read, in place of the JAX
    package's DataFrames. ``table[label]`` is a (T,) column; for
    coordinate tables, ``table[bodypart]`` is the (T, 2) block of its
    (bodypart, axis) columns, as a DataFrame's first column level gives it."""

    __slots__ = ("values", "columns", "_index", "_groups")

    _AXES = ("x", "y", "rho", "phi")

    def __init__(self, values, columns):
        self.values = values
        self.columns = list(columns)
        self._index = {c: i for i, c in enumerate(self.columns)}
        self._groups = {}
        for i, c in enumerate(self.columns):
            if isinstance(c, tuple) and len(c) == 2 and c[1] in self._AXES:
                self._groups.setdefault(c[0], []).append(i)

    def __len__(self) -> int:
        return self.values.shape[0]

    @property
    def bodyparts(self) -> list:
        """First labels of the (bodypart, axis) columns, in order."""
        return list(self._groups)

    def __contains__(self, label) -> bool:
        return label in self._index or label in self._groups

    def __getitem__(self, label):
        if label in self._index:
            return self.values[:, self._index[label]]
        if label in self._groups:
            return self.values[:, self._groups[label]]
        raise KeyError(label)

    def select(self, labels) -> "DeviceTable":
        """The table of the given column labels, in their order."""
        labels = list(labels)
        return DeviceTable(self.values[:, [self._index[c] for c in labels]], labels)


def save_dt(dt: Any, path: Optional[str] = None, return_path: bool = False):
    """The TableDict value for ``dt``: the object itself (in-memory mode)."""
    if return_path:
        raise NotImplementedError(PATHS_MODE)
    return dt


def get_dt(tab_dict: dict, key: str, only_metainfo: bool = False, load_range=None):
    """Resolve a TableDict value, realising a lazy one.

    With ``only_metainfo``: a dict of ``shape``, ``columns`` (None where the
    value has no column list), ``num_rows`` and, for frames, ``num_cols``,
    without realising anything. ``load_range`` selects rows: a 2-element
    sequence is the inclusive span [start, end], anything longer or shorter
    an array of row indices (:func:`get_dt_rows` always reads indices).
    """
    entry = tab_dict[key]
    if only_metainfo:
        return _metainfo(entry)
    obj = entry.realize() if isinstance(entry, (LazyFrame, LazyWindows)) else entry
    return obj if load_range is None else _slice_obj(obj, load_range)


def get_dt_rows(tab_dict: dict, key: str, idx):
    """The rows ``idx`` of a TableDict value, ``idx`` always an array of row
    indices (``get_dt`` reads a 2-element sequence as a span)."""
    if idx is None:
        return get_dt(tab_dict, key)
    return _take(get_dt(tab_dict, key), np.asarray(idx).astype(np.int64))


def _slice_obj(obj, load_range):
    """Rows of an array, tensor or tuple of them: a 2-element 1-D
    ``load_range`` is the inclusive span [start, end], else row indices."""
    if hasattr(load_range, "__len__") and len(load_range) == 2 and np.ndim(load_range) == 1:
        return _take(obj, slice(int(load_range[0]), int(load_range[1]) + 1))
    return _take(obj, np.asarray(load_range))


def _take(obj, rows):
    if isinstance(obj, tuple):
        return tuple(_take(o, rows) for o in obj)
    if isinstance(obj, torch.Tensor):
        return obj[rows] if isinstance(rows, slice) else obj[torch.as_tensor(rows, device=obj.device)]
    return np.asarray(obj)[rows]


def _metainfo(entry) -> dict:
    if isinstance(entry, LazyWindows):
        shapes = [tuple(s) for s in entry.shapes]
        return {"shape": shapes, "columns": None, "num_rows": shapes[0][0] if shapes else 0}
    if isinstance(entry, LazyFrame):
        return {"shape": entry.shape, "columns": list(entry.columns),
                "num_cols": entry.shape[1], "num_rows": entry.shape[0]}
    if isinstance(entry, tuple):
        return {"shape": [np.shape(o) for o in entry], "columns": None,
                "num_rows": np.shape(entry[0])[0] if entry else 0}
    shape = np.shape(entry)
    return {"shape": shape, "columns": None,
            "num_cols": shape[1] if len(shape) > 1 else 1,
            "num_rows": shape[0] if shape else 0}
