"""Paths mode (very large projects: tables stored in files and passed around
as pointers) against the JAX package's, and against the port's own
in-memory mode, on the CPU.

The project is ``tests/test_torch_public.py``'s two recordings (300 frames,
two deepof_14 animals) in both packages. The port's ``create`` flags it very
large with its ``config.VERY_LARGE_TOTAL_FRAMES`` monkeypatched below the
600 frames of its tables; the JAX package counts the frames of the videos
(placeholders here), so its flag is set on its Coordinates. The JAX package stores HDF5 tables (h5py is present on
this box), the port ``.npy`` files and a json; JAX runs in float64 and takes
its device lane (``DEEPOF_TPU_DEVICE_SCALE=1``), the port runs on the CPU in
float64 on one torch thread.

Bars: the storage round trips exactly (values, dtypes, columns, metainfo,
rows); getters written with ``return_path`` at 1e-8 with equal NaNs and
equal file names; the graph dataset's windows, merged tables and scaled
frames at ``tests/test_torch_cohort.py``'s bars (the general route 1e-8,
the device route 1e-5 relative); the window spill's batches equal to the
JAX h5 spill's; paths mode against the in-memory mode on the same route,
and the fit, serve, soft counts and post-hoc reads on pointers against the
same calls on in-memory values, bit for bit.
"""

import json
import os
import pickle

import numpy as np
import pandas as pd
import pytest

from deepof_tpu.core import storage as jstorage
from deepof_tpu.data import Project as JaxProject
from deepof_tpu.train import dataset as jdataset

from deepof_tpu_torch import config as pconfig
from deepof_tpu_torch import posthoc as pph
from deepof_tpu_torch.core import table_dict as ptd
from deepof_tpu_torch.core.storage import (
    LazyFrame,
    TablePointer,
    frame_windows,
    get_dt,
    get_dt_rows,
    is_pointer,
    pointer_map,
    save_dt,
    save_windows,
)
from deepof_tpu_torch.core.table_dict import TableDict, preprocess_time_bins
from deepof_tpu_torch.data import Project
from deepof_tpu_torch.train import dataset as pdataset
from deepof_tpu_torch.train.inference import embedding_per_video

from test_torch_chunks import one_torch_thread  # noqa: F401 (an autouse fixture of this module too)
from test_torch_public import _project_args, write_project

KEYS = ("test", "test2")
WINDOW = 8
TOL64, TOL32 = 1e-8, 1e-5
TUTORIAL = dict(animal_id="B", center="Center", align="Spine_1", window_size=WINDOW, test_videos=1)
CASES = {
    "device_route": dict(test_videos=1),
    "general_route_shuffled": dict(scale="robust", dist_standardize="groupwise", speed_standardize="groupwise",
                                   coord_standardize="groupwise", test_videos=1, shuffle=True),
}


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """Both packages' project, flagged very large (the port's by ``create``)."""
    root = write_project(tmp_path_factory.mktemp("paths"), "csv")
    j_coords = JaxProject(**_project_args(root, "csv")).create(force=True, test=True, verbose=False)
    j_coords._very_large_project = True
    mp = pytest.MonkeyPatch()
    mp.setattr(pconfig, "VERY_LARGE_TOTAL_FRAMES", 500)
    try:
        p_coords = Project(**{**_project_args(root, "csv"), "project_name": "port"}, device="cpu").create(
            force=True, test=True, verbose=False)
    finally:
        mp.undo()
    assert p_coords._very_large_project
    return {"jax": j_coords, "port": p_coords, "builds": {}}


def _close(got, want, tol, rel=False):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=tol if rel else 0, atol=tol, equal_nan=True)


def _equal(got, want):
    """Equal arrays (or tuples of them): values bit for bit, dtypes, shapes."""
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _stem(pointer, table_path):
    """A pointer's file, relative to its project's table path, without
    extension (the JAX package's ``{"h5_file"}`` or the port's)."""
    path = os.path.splitext(pointer["h5_file"])[0] if "h5_file" in pointer else pointer["npy_table"]
    return os.path.relpath(path, table_path)


# --------------------------------------------------------------------------- #
# The storage protocol
# --------------------------------------------------------------------------- #


def _frame(seed=0):
    rng = np.random.default_rng(seed)
    values = rng.normal(size=(9, 4))
    values[2, 1] = np.nan
    columns = [("B_Nose", "x"), ("B_Nose", "y"), "B_Center", ("B_Nose", "B_Tail_base")]
    return values, columns


def test_frame_round_trip_matches_jax(tmp_path):
    """A frame with tuple and string columns: the port's pointer reads back
    what the JAX package's HDF5 pointer does (values, decoded columns,
    metainfo), whole, by span and by index arrays."""
    values, columns = _frame()
    ptr = save_dt(LazyFrame(lambda: values, columns, len(values), "float32"), str(tmp_path / "port" / "t"), True)
    j_ptr = jstorage.save_dt(pd.DataFrame(values, columns=pd.Index(columns, tupleize_cols=False)),
                             str(tmp_path / "jax" / "t"), True)
    assert isinstance(ptr, TablePointer) and "h5_file" not in ptr and os.path.exists(str(tmp_path / "port/t.npy"))
    port, jax_ = {"k": ptr}, {"k": j_ptr}
    _equal(get_dt(port, "k"), values)
    want = jstorage.get_dt(jax_, "k")
    np.testing.assert_array_equal(get_dt(port, "k"), want.to_numpy())
    meta, j_meta = get_dt(port, "k", only_metainfo=True), jstorage.get_dt(jax_, "k", only_metainfo=True)
    assert meta["columns"] == list(j_meta["columns"]) == columns
    for name in ("shape", "num_rows", "num_cols"):
        assert tuple(np.atleast_1d(meta[name])) == tuple(np.atleast_1d(j_meta[name])), name
    assert meta["dtype"] == "float32"
    for load_range in ([2, 5], np.array([0, 3, 8]), [1, 4, 6]):  # span, then sorted index arrays
        np.testing.assert_array_equal(get_dt(port, "k", load_range=load_range),
                                      jstorage.get_dt(jax_, "k", load_range=load_range).to_numpy())
    _equal(get_dt(port, "k", load_range=np.array([7, 0, 3, 3])), values[[7, 0, 3, 3]])  # any order, repeats
    _equal(get_dt_rows(port, "k", [6, 1]), values[[6, 1]])  # two indices, not a span
    np.testing.assert_array_equal(get_dt_rows(port, "k", [6, 1]), jstorage.get_dt_rows(jax_, "k", [6, 1]).to_numpy())


@pytest.mark.parametrize("kind", ["float32", "int64", "tuple"])
def test_arrays_and_tuples_round_trip_match_jax(tmp_path, kind):
    """Arrays keep their dtype; a tuple is one file an item; metainfo and
    row reads as the JAX package's."""
    rng = np.random.default_rng(1)
    obj = {"float32": rng.normal(size=(11, 3)).astype(np.float32), "int64": rng.integers(0, 9, size=(11,)),
           "tuple": (rng.normal(size=(11, 4, 2)).astype(np.float32), np.arange(11), np.zeros((11, 4, 0)))}[kind]
    port = {"k": save_dt(obj, str(tmp_path / "port" / "t"), True)}
    jax_ = {"k": jstorage.save_dt(obj, str(tmp_path / "jax" / "t"), True)}
    _equal(get_dt(port, "k"), obj)
    _equal(get_dt(port, "k"), jstorage.get_dt(jax_, "k"))
    meta, j_meta = get_dt(port, "k", only_metainfo=True), jstorage.get_dt(jax_, "k", only_metainfo=True)
    assert {k: meta[k] for k in j_meta if k in meta} == {k: j_meta[k] for k in j_meta if k in meta}
    for load_range in ([3, 7], np.array([1, 2, 9])):
        _equal(get_dt(port, "k", load_range=load_range), jstorage.get_dt(jax_, "k", load_range=load_range))
    _equal(get_dt_rows(port, "k", [9, 2]), jstorage.get_dt_rows(jax_, "k", [9, 2]))


@pytest.mark.parametrize("shuffled", [False, True], ids=["ordered", "shuffled"])
def test_windows_pointer_reads_the_windows(tmp_path, shuffled):
    """A frame-backed windows pointer: the frame written once, its groups
    (one empty), window and step, and the drawn order; it reads back the
    windows of the in-memory lane, whole and by rows."""
    frame = np.random.default_rng(2).normal(size=(40, 7)).astype(np.float32)
    groups, window, step = ([0, 2, 4], [6, 1], []), 5, 2
    n = len(range(0, 40 - window + 1, step))
    order = np.random.default_rng(3).permutation(n) if shuffled else None
    tab = {"k": save_windows(frame, groups, window, step, str(tmp_path / "k_preprocessed"), order)}
    want = frame_windows(frame, groups, window, step, order)
    _equal(get_dt(tab, "k"), want)
    assert get_dt(tab, "k", only_metainfo=True) == {
        "shape": [(n, window, 3), (n, window, 2), (n, window, 0)], "columns": None, "num_rows": n}
    _equal(get_dt(tab, "k", load_range=[2, 6]), tuple(w[2:7] for w in want))
    _equal(get_dt_rows(tab, "k", [9, 0]), tuple(w[[9, 0]] for w in want))
    assert os.path.getsize(str(tmp_path / "k_preprocessed.npy")) < frame.nbytes + 256  # the frame, once


def test_a_rewrite_leaves_earlier_pointers_readable(tmp_path):
    """The files are replaced, not truncated: a pointer that read its table
    keeps reading it through its maps after the path is written again (so
    does a raw map of the old file); one that had not read it raises; the
    new pointer reads the new table."""
    base = str(tmp_path / "k" / "k_preprocessed")
    old = np.arange(60, dtype=np.float32).reshape(20, 3)
    first = save_windows(old, ([0, 1], [2]), 4, 1, base)
    unread = pickle.loads(pickle.dumps(first))
    before = get_dt({"k": first}, "k")
    raw = np.load(base + ".npy", mmap_mode="r")
    second = save_windows(-old, ([0, 1], [2]), 4, 1, base)
    _equal(get_dt({"k": first}, "k"), before)
    _equal(pointer_map(first), old)
    np.testing.assert_array_equal(raw, old)
    with pytest.raises(RuntimeError, match="written again"):
        get_dt({"k": unread}, "k")
    _equal(get_dt({"k": second}, "k"), frame_windows(-old, ([0, 1], [2]), 4, 1))
    assert sorted(os.listdir(tmp_path / "k")) == ["k_preprocessed.json", "k_preprocessed.npy"]  # no temporaries


def test_table_dict_of_pointers_pickles(tmp_path):
    """A TableDict of pointers pickles as dicts (no maps) with its header,
    and reads back; a JAX package's HDF5 pointer raises."""
    values, columns = _frame(4)
    td = TableDict({key: save_dt(LazyFrame(lambda: values + i, columns, len(values)), str(tmp_path / key), True)
                    for i, key in enumerate(KEYS)}, typ="merged", table_path=str(tmp_path), animal_ids=["B"])
    get_dt(td, KEYS[0])  # opens (and keeps) its maps
    blob = pickle.dumps(td)
    assert len(blob) < 2048
    loaded = pickle.loads(blob)
    assert loaded._type == "merged" and loaded._table_path == str(tmp_path) and loaded._animal_ids == ["B"]
    for i, key in enumerate(KEYS):
        assert isinstance(loaded[key], TablePointer) and loaded[key].maps is None and loaded[key] == td[key]
        _equal(get_dt(loaded, key), values + i)
    j_ptr = jstorage.save_dt(np.ones((3, 2)), str(tmp_path / "jax"), True)
    for read in (lambda: get_dt({"k": j_ptr}, "k"), lambda: get_dt({"k": j_ptr}, "k", only_metainfo=True),
                 lambda: get_dt_rows({"k": j_ptr}, "k", [0])):
        with pytest.raises(TypeError, match="h5_file"):
            read()


# --------------------------------------------------------------------------- #
# The getters, the graph dataset and the window spill against the JAX package
# --------------------------------------------------------------------------- #

GETTERS = {
    "coords": ("get_coords", dict(center="arena", align="Spine_1")),
    "distances": ("get_distances", {}),
    "angles": ("get_angles", {}),
    "areas": ("get_areas", {}),
}


@pytest.mark.parametrize("getter", list(GETTERS))
def test_getters_return_path_match_jax(sides, getter):
    """Each getter with ``return_path``: pointers to the same file names
    (``{key}/{key}_{file_name}``), the tables at 1e-8 and their columns."""
    method, kw = GETTERS[getter]
    want = getattr(sides["jax"], method)(return_path=True, **kw)
    got = getattr(sides["port"], method)(return_path=True, **kw)
    assert list(got) == list(want)
    for key in KEYS:
        assert is_pointer(got[key]) and "h5_file" in want[key]
        assert _stem(got[key], sides["port"]._table_path) == _stem(want[key], sides["jax"]._table_path)
        w = jstorage.get_dt(want, key)
        assert get_dt(got, key, only_metainfo=True)["columns"] == list(w.columns)
        _close(get_dt(got, key), w.to_numpy(np.float64), TOL64)


def _build(sides, name, kw):
    """Both packages' paths-mode graph dataset (the project's default), once
    a case."""
    if name not in sides["builds"]:
        mp = pytest.MonkeyPatch()
        mp.setenv("DEEPOF_TPU_DEVICE_SCALE", "1")
        try:
            want = sides["jax"].get_graph_dataset(window_size=WINDOW, **kw)
        finally:
            mp.undo()
        sides["builds"][name] = (sides["port"].get_graph_dataset(window_size=WINDOW, **kw), want)
    return sides["builds"][name]


@pytest.mark.parametrize("case", list(CASES))
def test_graph_dataset_paths_match_jax(sides, case):
    """``get_graph_dataset`` in paths mode: the windows (the drawn order
    too), metainfo and adjacency, the merged tables written by the getters
    and ``merge``, and the scaled frames that ``preprocess`` writes, every
    value a pointer, at the route's bar."""
    kw = CASES[case]
    rel = case == "device_route"
    tol = TOL32 if rel else TOL64
    (p_ds, p_meta, p_adj, p_tab, p_sc), (j_ds, j_meta, j_adj, j_tab, j_sc) = _build(sides, case, kw)
    assert not hasattr(p_tab, "_scaled_frames")
    for name in ("node_columns", "edge_columns", "angle_columns"):
        assert p_meta[name] == list(j_meta[name]), name
    for name in ("shape_train", "shape_test", "dist_standardize", "speed_standardize", "coord_standardize"):
        assert p_meta[name] == j_meta[name], name
    np.testing.assert_array_equal(p_adj, np.asarray(j_adj))
    for key in KEYS:
        assert is_pointer(p_tab[key]) and _stem(p_tab[key], sides["port"]._table_path) == f"{key}/{key}_merged"
        _close(get_dt(p_tab, key), jstorage.get_dt(j_tab, key).to_numpy(), TOL64)
    for p_part, j_part in zip(p_ds, j_ds):
        assert list(p_part) == list(j_part)
        for key in j_part:
            assert p_part[key]["kind"] == "windows" and "h5_file" in j_part[key]
            assert _stem(p_part[key], sides["port"]._table_path) == f"{key}/{key}_preprocessed"
            for g, w in zip(get_dt(p_part, key), jstorage.get_dt(j_part, key)):
                assert g.dtype == w.dtype
                _close(g, w, tol, rel)
    frame_kw = {k: v for k, v in kw.items() if k != "shuffle"}
    frame_kw.setdefault("dist_standardize", "per_column")
    frame_kw.setdefault("speed_standardize", "per_column")
    frame_kw.setdefault("coord_standardize", "per_column")
    mp = pytest.MonkeyPatch()
    mp.setenv("DEEPOF_TPU_DEVICE_SCALE", "1")
    try:
        j_parts, _, _ = j_tab.preprocess(coordinates=sides["jax"], window_size=WINDOW, return_windows=False,
                                         file_name="scaled_check", **frame_kw)
    finally:
        mp.undo()
    p_parts, _, _ = p_tab.preprocess(coordinates=sides["port"], window_size=WINDOW, return_windows=False,
                                     file_name="scaled_check", **frame_kw)
    for p_part, j_part in zip(p_parts, j_parts):
        for key in j_part:
            assert is_pointer(p_part[key]) and get_dt(p_part, key, only_metainfo=True)["dtype"] == (
                "float32" if rel else "float64")
            _close(get_dt(p_part, key), jstorage.get_dt(j_part, key).to_numpy(), tol, rel)


@pytest.mark.parametrize("shuffle", [False, True], ids=["ordered", "shuffled"])
def test_return_windows_paths_match_jax(sides, shuffle):
    """``preprocess(return_windows=True)`` in paths mode (robust scaling,
    step 2, one recording held out): each window stack written over the
    scaled frame's files (``extract_windows`` takes the path from the
    pointer it read), in the order numpy's global state shuffles them."""
    (_, _, _, p_tab, _), (_, _, _, j_tab, _) = _build(sides, "general_route_shuffled",
                                                      CASES["general_route_shuffled"])
    kw = dict(window_size=WINDOW, window_step=2, scale="robust", test_videos=1, shuffle=shuffle,
              save_as_paths=True, file_name="windows_check")
    j_parts, j_meta, _ = j_tab.preprocess(coordinates=sides["jax"], **kw)
    p_parts, p_meta, _ = p_tab.preprocess(coordinates=sides["port"], **kw)
    assert p_meta == j_meta
    for p_part, j_part in zip(p_parts, j_parts):
        assert list(p_part) == list(j_part)
        for key in j_part:
            assert p_part[key]["kind"] == "array"
            assert _stem(p_part[key], sides["port"]._table_path) == f"{key}/{key}_windows_check"
            _close(get_dt(p_part, key), jstorage.get_dt(j_part, key), TOL64)


def _shaped(seed=5):
    rng = np.random.default_rng(seed)
    return {key: (rng.normal(size=(n, 4, 5, 3)).astype(np.float32), rng.normal(size=(n, 4, 2, 1)).astype(np.float32),
                  rng.normal(size=(n, 4, 3, 1)).astype(np.float32)) for key, n in (("v1", 530), ("v2", 117))}


def _batches(ds, seed, **kw):
    rng = np.random.default_rng(seed)
    return [b for _ in range(2) for b in ds.batches(64, rng=rng, **kw)]


@pytest.mark.parametrize("bootstrap", [False, True])
def test_window_dataset_spill_matches_jax_h5(tmp_path, bootstrap):
    """``WindowDataset(spill_to_disk=True)``: the same batches as the JAX
    package's HDF5 spill (in RAM under ``bootstrap``, whose repeated windows
    the h5 read refuses) and as the port in RAM, from one seed; the build
    reused while its keys hash and ``build_complete`` hold, rebuilt when
    they do not or with ``force_rebuild`` (the old maps keep their data)."""
    data = _shaped()
    j_ds = (jdataset.WindowDataset(data) if bootstrap else
            jdataset.WindowDataset(data, dataset_folder=str(tmp_path / "jax"), dataset_name="t", spill_to_disk=True))
    p_ds = pdataset.WindowDataset(data, dataset_folder=str(tmp_path / "port"), dataset_name="t",
                                  spill_to_disk=True, h5_chunk_len=64)
    ram = pdataset.WindowDataset(data)
    assert isinstance(p_ds.x, np.memmap) and not p_ds.x.flags.writeable
    assert len(p_ds) == len(j_ds) == 647 and p_ds.video_ranges == j_ds.video_ranges == ram.video_ranges
    kw = dict(shuffle=True, block_size=100, bootstrap=bootstrap)
    want, ram_batches = _batches(j_ds, 7, **kw), _batches(ram, 7, **kw)
    got = list(pdataset.prefetch(iter(_batches(p_ds, 7, **kw))))
    assert len(got) == len(want) == len(ram_batches)
    for g, w, r in zip(got, want, ram_batches):
        for a, b, c in zip(g, w, r):
            _equal(a, b)
            _equal(a, c)

    folder = tmp_path / "port" / "t_windows"
    inode = os.stat(folder / "x.npy").st_ino
    assert pdataset.WindowDataset(data, dataset_folder=str(tmp_path / "port"), dataset_name="t",
                                  spill_to_disk=True).video_ranges == p_ds.video_ranges
    assert os.stat(folder / "x.npy").st_ino == inode  # reused
    pdataset.WindowDataset(data, dataset_folder=str(tmp_path / "port"), dataset_name="t", spill_to_disk=True,
                           force_rebuild=True)
    assert os.stat(folder / "x.npy").st_ino != inode
    np.testing.assert_array_equal(p_ds.x[:530], data["v1"][0])  # the first build's maps
    meta = json.loads((folder / "build.json").read_text())
    (folder / "build.json").write_text(json.dumps({**meta, "build_complete": False}))
    inode = os.stat(folder / "x.npy").st_ino
    pdataset.WindowDataset(data, dataset_folder=str(tmp_path / "port"), dataset_name="t", spill_to_disk=True)
    assert os.stat(folder / "x.npy").st_ino != inode and json.loads((folder / "build.json").read_text())[
        "build_complete"]
    fewer = {"v2": data["v2"]}  # a stale build: another keys hash
    stale = pdataset.WindowDataset(fewer, dataset_folder=str(tmp_path / "port"), dataset_name="t",
                                   spill_to_disk=True)
    assert stale.video_ranges == {"v2": (0, 117)} and len(stale) == 117
    np.testing.assert_array_equal(stale.x, data["v2"][0])


# --------------------------------------------------------------------------- #
# Paths mode against the in-memory mode, and the slice end to end
# --------------------------------------------------------------------------- #


def _tutorial(sides):
    if "tutorial" not in sides["builds"]:
        coords = sides["port"]
        sides["builds"]["tutorial"] = (coords.get_graph_dataset(**TUTORIAL),
                                       coords.get_graph_dataset(return_as_paths=False, **TUTORIAL))
    return sides["builds"]["tutorial"]


def test_paths_mode_equals_the_in_memory_mode(sides):
    """The tutorial's call (animal B, aligned; the getters' lane in both
    modes): windows, merged tables and scaled frames equal bit for bit; the
    project's default call (the getters' lane in paths mode, the fused lane
    in memory: float32 device routes from other summation orders) at 1e-5
    relative."""
    paths, memory = _tutorial(sides)
    assert all(is_pointer(v) for part in paths[0] for v in part.values())
    assert paths[1].keys() == memory[1].keys() and np.array_equal(paths[2], memory[2])
    for name, value in memory[1].items():
        assert np.array_equal(paths[1][name], value) if name == "inner_link_mask" else paths[1][name] == value
    for p_part, m_part in zip(paths[0], memory[0]):
        assert list(p_part) == list(m_part)
        for key in m_part:
            _equal(get_dt(p_part, key), get_dt(m_part, key))
    for key in KEYS:
        _equal(get_dt(paths[3], key), get_dt(memory[3], key))
        assert get_dt(paths[3], key, only_metainfo=True)["columns"] == memory[3][key].columns
    settings = dict(scale="standard", dist_standardize="per_column", speed_standardize="per_column",
                    coord_standardize="per_column")
    parts, _, _ = paths[3].preprocess(coordinates=sides["port"], window_size=WINDOW, return_windows=False,
                                      test_videos=1, file_name="scaled_check", **settings)
    for part in parts:
        for key in part:
            _equal(get_dt(part, key), get_dt(memory[3]._scaled_frames, key))
    default = sides["port"].get_graph_dataset(window_size=WINDOW, return_as_paths=False, test_videos=1)
    got = _build(sides, "device_route", CASES["device_route"])[0]
    for p_part, m_part in zip(got[0], default[0]):
        for key in m_part:
            for g, w in zip(get_dt(p_part, key), get_dt(m_part, key)):
                _close(g, w, TOL32, rel=True)


def test_fit_serve_soft_counts_and_posthoc_on_pointers(sides, monkeypatch):
    """A short default fit from the paths-mode dataset (window 8, latent 4,
    2 + 1 batches), its bundle served from paths mode (scaled again, frames
    written to files; also past the frames budget, read from them) and from
    the in-memory dataset, equal bit for bit; the sticky-HMM soft counts of
    a very large project saved as pointers; the post-hoc readers over
    pointers and time bins equal to the same calls over in-memory values."""
    coords = sides["port"]
    paths, memory = _tutorial(sides)
    bundle, _, _, summary = coords.deep_unsupervised_embedding(
        paths[:3], adjacency_matrix=paths[2], batch_size=16, latent_dim=4, n_clusters=4, epochs=1,
        pretrain_epochs=1, verbose=False, limit_train_batches=2, limit_val_batches=1)
    assert all(np.isfinite(v) for v in summary.values())
    emb, counts = embedding_per_video(coords, paths[3], bundle, paths[1], animal_id="B", global_scaler=paths[4],
                                      batch_size=64)
    m_emb, m_counts = embedding_per_video(coords, memory[3], bundle, memory[1], animal_id="B",
                                          global_scaler=memory[4], batch_size=64)
    monkeypatch.setattr(ptd, "DEVICE_FRAMES_BYTES", 1)
    h_emb, _ = embedding_per_video(coords, paths[3], bundle, paths[1], animal_id="B", global_scaler=paths[4],
                                   batch_size=64)
    for key in KEYS:
        _equal(emb[key], m_emb[key])
        _equal(counts[key], m_counts[key])
        _equal(h_emb[key], emb[key])

    soft = pph.get_contrastive_soft_counts(coords, emb, states=3, device="cpu")
    plain = pph.get_contrastive_soft_counts(None, emb, states=3, device="cpu")
    table_path = coords._table_path
    for key in KEYS:
        assert soft[key]["npy_table"] == os.path.join(table_path, key, f"{key}_soft_counts")
        _equal(get_dt(soft, key), plain[key])
    in_memory = TableDict(plain, typ="unsupervised_counts", table_path=table_path)
    emb_ptrs = TableDict({k: save_dt(v, os.path.join(table_path, k, f"{k}_embedding"), True) for k, v in emb.items()},
                         typ="unsupervised_embedding", table_path=table_path)
    bins = preprocess_time_bins(coords, bin_size=4, bin_index=1)
    conditions = {"test": "a", "test2": "b"}
    for call in (
        lambda c, e, b: pph.get_time_on_cluster(c, bin_info=b, device="cpu"),
        lambda c, e, b: pph.get_time_on_cluster(c, bin_info=b, normalize=False, device="cpu"),
        lambda c, e, b: pph.get_aggregated_embedding(e, agg="median", bin_info=b, device="cpu"),
        lambda c, e, b: pph.compute_transition_matrix_per_condition(c, conditions, bin_info=b, device="cpu"),
        lambda c, e, b: pph.get_time_on_cluster(c, bin_info={k: np.array([v[0], v[-1]]) for k, v in b.items()},
                                                device="cpu"),
    ):
        want = call(in_memory, emb, bins)
        got = call(soft, emb_ptrs, bins)
        if isinstance(want, dict):
            assert list(got) == list(want)
            for name in want:
                _equal(got[name], want[name])
        else:
            _equal(got.values, want.values)
            assert got.index == want.index and got.columns == want.columns
