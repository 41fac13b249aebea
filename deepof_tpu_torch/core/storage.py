"""Table storage of a TableDict value (port of ``deepof_tpu/core/storage.py``),
and the column-addressed device tables of the supervised rules.

A TableDict value is the object itself, a :class:`LazyFrame` (a frame whose
values still live on the device, realised on first access), a
:class:`LazyWindows` (window tensors realised on first access) or, in paths
mode (very large projects, ``return_path`` / ``save_as_paths``), a
:class:`TablePointer` to files that :func:`save_dt` wrote. The JAX package
realises frames as ``pd.DataFrame``; here a frame is a float64 numpy array
and its columns are a list beside it.

Paths mode stores each table as ``.npy`` files read through
``np.load(mmap_mode="r")`` beside a json of its metainfo (the JAX package
writes HDF5, which the card's machine lacks): ``<base>.json`` and
``<base>.npy`` (a frame in float64, an array in its own dtype, the frame of
a window pointer), ``<base>.<i>.npy`` for the items of a tuple. Every file is
written under a temporary name and moved over the old one with
``os.replace``, so a map of the old file keeps its data; each write draws a
new ``stamp``, and a pointer whose stamp the json no longer holds reads only
through the maps it opened before the rewrite (else it raises).
"""

from __future__ import annotations

import json
import os
import uuid
from typing import Any, Optional, Tuple

import numpy as np
import torch

from deepof_tpu_torch.ops.windows import rolling_windows_host

POINTER_KEY = "npy_table"


class LazyFrame:
    """A (T, F) frame realised to a float64 numpy array on first access;
    ``columns`` and ``shape`` answer without realising it. ``dtype`` names
    the precision its values were computed in (None: float64), which paths
    mode stores beside the float64 file so that a frame read back is
    uploaded as it was made."""

    __slots__ = ("_realize", "_columns", "_nrows", "_cache", "dtype")

    def __init__(self, realize_fn, columns, nrows: int, dtype: Optional[str] = None):
        self._realize = realize_fn
        self._columns = list(columns)
        self._nrows = int(nrows)
        self._cache = None
        self.dtype = dtype

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
        return {"frame": self.realize(), "columns": self._columns, "dtype": self.dtype}

    def __setstate__(self, state):
        frame = state["frame"]
        self._realize = lambda: frame
        self._columns = state["columns"]
        self._nrows = len(frame)
        self._cache = frame
        self.dtype = state.get("dtype")


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


def frame_windows(frame: np.ndarray, groups, window: int, step: int, order=None) -> tuple:
    """(T, F) frame -> for each column group g, the stride-``step`` windows
    of ``frame[:, g]`` (n, window, len(g)) as a view of that column copy
    (an empty group: float64 zeros); in ``order`` (copies) where given."""
    windows = tuple(
        rolling_windows_host(frame[:, list(g)], window, step, contiguous=False)
        if len(g)
        else np.zeros((max(frame.shape[0] - window + 1, 0), window, 0))[::step]
        for g in groups
    )
    return windows if order is None else tuple(w[order] for w in windows)


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



# --------------------------------------------------------------------------- #
# Paths mode: tables in .npy files, passed around as pointers
# --------------------------------------------------------------------------- #


class TablePointer(dict):
    """A TableDict value stored in files: ``{"npy_table": base path,
    "kind": "frame" | "array" | "tuple" | "windows", "stamp": ...}``. It keeps
    the read-only maps it opened (not pickled), so a rewrite of its files
    leaves it readable."""

    __slots__ = ("maps",)

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.maps = None

    def __reduce__(self):
        return (TablePointer, (dict(self),))


def is_pointer(obj: Any) -> bool:
    return isinstance(obj, dict) and POINTER_KEY in obj


def _check_not_jax(entry) -> None:
    if isinstance(entry, dict) and "h5_file" in entry:
        raise TypeError(
            f"{entry!r} is the JAX package's pointer to an HDF5 table; the port stores tables as .npy files "
            "(its pointers hold 'npy_table') and reads no HDF5 table: build the table with the port"
        )


def _encode_columns(columns) -> list:
    return [{"t": "tuple", "v": list(map(str, c))} if isinstance(c, tuple) else {"t": "str", "v": str(c)}
            for c in columns]


def _decode_columns(items) -> list:
    return [tuple(item["v"]) if item["t"] == "tuple" else item["v"] for item in items]


def _write_npy(path: str, arr: np.ndarray, stamp: str) -> None:
    tmp = f"{path}.{stamp}.tmp"
    with open(tmp, "wb") as f:
        np.lib.format.write_array(f, np.ascontiguousarray(arr), allow_pickle=False)
    os.replace(tmp, path)


def _write_table(base: str, kind: str, arrays: dict, meta: dict) -> TablePointer:
    """Write ``arrays`` ({suffix: array}: ``<base><suffix>.npy``) then the
    json, each under a temporary name moved over the old file."""
    os.makedirs(os.path.dirname(base) or ".", exist_ok=True)
    stamp = uuid.uuid4().hex
    for suffix, arr in arrays.items():
        _write_npy(f"{base}{suffix}.npy", arr, stamp)
    tmp = f"{base}.json.{stamp}.tmp"
    with open(tmp, "w") as f:
        json.dump({"kind": kind, "stamp": stamp, **meta}, f)
    os.replace(tmp, f"{base}.json")
    return TablePointer({POINTER_KEY: base, "kind": kind, "stamp": stamp})


def _host_array(obj) -> np.ndarray:
    return obj.detach().cpu().numpy() if isinstance(obj, torch.Tensor) else np.asarray(obj)


def save_dt(dt: Any, path: Optional[str] = None, return_path: bool = False):
    """The TableDict value for ``dt``: ``dt`` itself (in-memory mode, or no
    ``path``), else a :class:`TablePointer` to files under ``path`` (no
    extension): a :class:`LazyFrame` realised (one device->host copy) and
    written as a float64 frame with its columns; a tuple one file an item;
    anything else (array, tensor) one array in its own dtype. A
    :class:`LazyWindows` is realised and written as its tuple."""
    if not return_path or path is None:
        return dt
    if isinstance(dt, LazyWindows):
        dt = dt.realize()
    if isinstance(dt, LazyFrame):
        return _write_table(path, "frame", {"": dt.realize()},
                            {"columns": _encode_columns(dt.columns), "dtype": dt.dtype or "float64"})
    if isinstance(dt, tuple):
        return _write_table(path, "tuple", {f".{i}": _host_array(a) for i, a in enumerate(dt)}, {"items": len(dt)})
    return _write_table(path, "array", {"": _host_array(dt)}, {})


def save_windows(frame: np.ndarray, groups, window: int, step: int, path: str, order=None) -> TablePointer:
    """A pointer to the windows :func:`frame_windows` cuts from ``frame``:
    the frame written once (in its dtype), its column groups, the window
    and step, and the drawn ``order`` (a shuffled dataset) beside it. Its
    :func:`get_dt` is ``frame_windows(frame, groups, window, step, order)``."""
    n_windows = len(range(0, max(int(frame.shape[0]) - window + 1, 0), step))
    arrays = {"": frame} if order is None else {"": frame, ".order": np.asarray(order, np.int64)}
    return _write_table(path, "windows", arrays, {
        "groups": [[int(j) for j in g] for g in groups], "window": int(window), "step": int(step),
        "n_windows": n_windows, "shuffled": order is not None,
    })


def _read_json(base: str) -> dict:
    with open(f"{base}.json") as f:
        return json.load(f)


def _npy_shape(path: str) -> tuple:
    """The shape in a .npy file's header (no data read)."""
    with open(path, "rb") as f:
        version = np.lib.format.read_magic(f)
        read = np.lib.format.read_array_header_1_0 if version == (1, 0) else np.lib.format.read_array_header_2_0
        return tuple(read(f)[0])


def _pointer_meta(entry) -> dict:
    """The json of a pointer, checked against its stamp."""
    meta = _read_json(entry[POINTER_KEY])
    if meta["stamp"] != entry["stamp"]:
        raise RuntimeError(
            f"{entry[POINTER_KEY]}: the table was written again after this pointer was made (stamp "
            f"{entry['stamp']}, now {meta['stamp']}) and the pointer had not read it; read the new pointer"
        )
    return meta


def _pointer_maps(entry) -> tuple:
    """(json, {suffix: read-only map}) of a pointer: the maps it holds, or
    opened now (and kept, on a :class:`TablePointer`)."""
    maps = getattr(entry, "maps", None)
    if maps is not None:
        return maps
    base = entry[POINTER_KEY]
    meta = _pointer_meta(entry)
    suffixes = {"tuple": [f".{i}" for i in range(meta.get("items", 0))],
                "windows": [""] + ([".order"] if meta.get("shuffled") else [])}.get(meta["kind"], [""])
    maps = (meta, {s: np.load(f"{base}{s}.npy", mmap_mode="r", allow_pickle=False) for s in suffixes})
    if isinstance(entry, TablePointer):
        entry.maps = maps
    return maps


def pointer_map(entry) -> np.ndarray:
    """The read-only map of a pointer's ``<base>.npy`` (a windows pointer's
    scaled frame), opened and kept if the pointer holds none."""
    return _pointer_maps(entry)[1][""]


def _read_rows(arr: np.ndarray, rows) -> np.ndarray:
    """An in-memory copy of ``arr[rows]``: a slice as one read, an index
    array read in sorted order and returned in the order asked."""
    if rows is None:
        return np.array(arr)
    if isinstance(rows, slice):
        return np.array(arr[rows])
    idx = np.asarray(rows)
    if idx.dtype == bool:
        idx = np.flatnonzero(idx)
    idx = idx.astype(np.int64).reshape(-1)
    idx = np.where(idx < 0, idx + arr.shape[0], idx)
    order = np.argsort(idx, kind="stable")
    out = np.empty((len(idx),) + arr.shape[1:], arr.dtype)
    out[order] = arr[idx[order]]
    return out


def _read_pointer(entry, rows=None):
    """A pointer's table (``rows``: None, a slice or an index array)."""
    meta, maps = _pointer_maps(entry)
    kind = meta["kind"]
    if kind == "frame":
        return _read_rows(maps[""], rows).astype(np.float64, copy=False)
    if kind == "array":
        return _read_rows(maps[""], rows)
    if kind == "tuple":
        return tuple(_read_rows(maps[f".{i}"], rows) for i in range(meta["items"]))
    order = np.asarray(maps[".order"]) if meta["shuffled"] else None
    if rows is not None:
        n = meta["n_windows"]
        taken = np.arange(n)[rows] if isinstance(rows, slice) else np.asarray(rows)
        if taken.dtype == bool:
            taken = np.flatnonzero(taken)
        order = taken if order is None else order[taken]
    return frame_windows(maps[""], meta["groups"], meta["window"], meta["step"], order)


def _pointer_metainfo(entry) -> dict:
    """A pointer's metainfo from its json and .npy headers, or from the maps
    it holds (which outlive a rewrite of its files)."""
    base, held = entry[POINTER_KEY], getattr(entry, "maps", None)
    meta = held[0] if held is not None else _pointer_meta(entry)

    def shape_of(suffix):
        return tuple(held[1][suffix].shape) if held is not None else _npy_shape(f"{base}{suffix}.npy")

    kind = meta["kind"]
    if kind == "tuple":
        shapes = [shape_of(f".{i}") for i in range(meta["items"])]
        return {"shape": shapes, "columns": None, "num_rows": shapes[0][0] if shapes else 0}
    if kind == "windows":
        shapes = [(meta["n_windows"], meta["window"], len(g)) for g in meta["groups"]]
        return {"shape": shapes, "columns": None, "num_rows": meta["n_windows"]}
    shape = shape_of("")
    out = {"shape": shape, "columns": _decode_columns(meta["columns"]) if kind == "frame" else None,
           "num_cols": shape[1] if len(shape) > 1 else 1, "num_rows": shape[0] if shape else 0}
    if kind == "frame":
        out["dtype"] = meta["dtype"]
    return out


def get_dt(tab_dict: dict, key: str, only_metainfo: bool = False, load_range=None):
    """Resolve a TableDict value, realising a lazy one and reading a
    pointer's files.

    With ``only_metainfo``: a dict of ``shape``, ``columns`` (None where the
    value has no column list), ``num_rows`` and, for frames, ``num_cols``
    (and, for a pointer's frame, the ``dtype`` it was made in), read from
    the json and the .npy headers without reading data. ``load_range``
    selects rows: a 2-element sequence is the inclusive span [start, end],
    anything longer or shorter an array of row indices (:func:`get_dt_rows`
    always reads indices); a pointer reads only those rows from its maps.
    A pointer's frames, arrays and tuples come back as in-memory copies, its
    windows as views of a copy of the frame's columns.
    """
    entry = tab_dict[key]
    _check_not_jax(entry)
    if is_pointer(entry):
        if only_metainfo:
            return _pointer_metainfo(entry)
        return _read_pointer(entry, None if load_range is None else _range_rows(load_range))
    if only_metainfo:
        return _metainfo(entry)
    obj = entry.realize() if isinstance(entry, (LazyFrame, LazyWindows)) else entry
    return obj if load_range is None else _slice_obj(obj, load_range)


def get_dt_rows(tab_dict: dict, key: str, idx):
    """The rows ``idx`` of a TableDict value, ``idx`` always an array of row
    indices (``get_dt`` reads a 2-element sequence as a span)."""
    if idx is None:
        return get_dt(tab_dict, key)
    idx = np.asarray(idx).astype(np.int64)
    entry = tab_dict[key]
    _check_not_jax(entry)
    if is_pointer(entry):
        return _read_pointer(entry, idx)
    return _take(get_dt(tab_dict, key), idx)


def _range_rows(load_range):
    """A ``load_range`` as a slice (2-element 1-D: the inclusive span) or an
    index array."""
    if hasattr(load_range, "__len__") and len(load_range) == 2 and np.ndim(load_range) == 1:
        return slice(int(load_range[0]), int(load_range[1]) + 1)
    return np.asarray(load_range)


def _slice_obj(obj, load_range):
    """Rows of an array, tensor or tuple of them: a 2-element 1-D
    ``load_range`` is the inclusive span [start, end], else row indices."""
    return _take(obj, _range_rows(load_range))


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
