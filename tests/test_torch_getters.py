"""The port's kinematic getters against the JAX package's, on the CPU:
``Coordinates.get_coords``, ``get_distances``, ``get_angles`` and
``get_areas`` with their variants, the table-level ``Project`` getters,
``Project.extend``, the metadata getters, a project pickled before the
getters existed, and the ops under them (``polygon_areas``, ``to_polar``,
``align_trajectories``, ``point_in_polygon``).

Both packages create one project from the seeded two-animal csv fixture of
``tests/test_torch_public.py`` (keys "test"/"test2", 300 frames, two
deepof_14 animals, animal W absent on frames 90-101 of "test"), with JAX in
float64 and the port on the CPU in float64, and read ROI 1 from one arena
file: a rectangle whose edge runs through the median x of animal B's Center,
so that frames fall on both sides.

Bars: values at 1e-8 with equal NaN patterns and equal column labels (the
JAX DataFrame's ``list(columns)``). The variants that differentiate scalar
columns twice (``speed=1`` of distances, angles and areas, ``rolling_speed``
at deriv 2) hold every entry within 1e-8 or off by exactly one rounding
unit (1e-3 x the frame rate), on under 2% of the entries: the two packages
sum the 3-frame window of values already rounded to 3 decimals in another
order (ROADMAP queue 3).
"""

import os
import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepof_tpu.data import Project as JaxProject
from deepof_tpu.ops import alignment as jalign
from deepof_tpu.ops import geometry as jgeom
from deepof_tpu.ops import kinematics as jkin
from deepof_tpu.utils import filter_columns as jfilter_columns

from deepof_tpu_torch.core.storage import LazyFrame, get_dt
from deepof_tpu_torch.data import Project, load_project
from deepof_tpu_torch.ops import alignment as palign
from deepof_tpu_torch.ops import geometry as pgeom
from deepof_tpu_torch.ops import kinematics as pkin

from test_torch_public import FPS, _project_args, write_project

TOL = 1e-8
UNIT = 1e-3 * FPS  # one rounding unit of a speed


def _arena_file(root, path):
    """Test-mode arenas with ROI 1 per recording: the half-plane left of
    the median x of B's Center, as a rectangle in mm."""
    probe = Project(**{**_project_args(root, "csv"), "project_name": "probe"}, device="cpu")
    scales, params, _, res = probe.get_arena(test=True)
    coords = probe.create(force=True, test=True, verbose=False)
    ci = coords._nodes.index("B_Center")
    rois = {}
    for key, pos in coords._tables.items():
        xm = float(np.nanmedian(pos[:, ci, 0]))
        rois[key] = {1: np.array([[-1e4, -1e4], [xm, -1e4], [xm, 1e4], [-1e4, 1e4]])}
    probe.save_arena_data(path, params, rois, scales, res)
    return path


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    root = str(write_project(tmp_path_factory.mktemp("getters_project"), "csv"))
    arena = _arena_file(root, os.path.join(root, "arena.pkl"))
    j_proj = JaxProject(**_project_args(root, "csv"))
    j_coords = j_proj.create(force=True, arena_path=arena, verbose=False)
    p_proj = Project(**{**_project_args(root, "csv"), "project_name": "port"}, device="cpu")
    p_coords = p_proj.create(force=True, arena_path=arena, verbose=False)
    return {"root": root, "jax": (j_proj, j_coords), "port": (p_proj, p_coords)}


def _diffs(got: LazyFrame, want_df):
    """(port values, JAX values) after checking labels, shape and NaNs."""
    assert isinstance(got, LazyFrame)
    assert got.columns == list(want_df.columns)
    a, b = got.realize(), want_df.to_numpy(np.float64)
    assert a.dtype == np.float64 and a.shape == b.shape
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    return a, b


def _check_table(got, want, deriv2=False):
    assert sorted(got) == sorted(want)
    off = total = 0
    for key in want:
        a, b = _diffs(got[key], want[key])
        if not deriv2:
            np.testing.assert_allclose(a, b, rtol=0, atol=TOL, equal_nan=True)
            continue
        d = np.abs(np.nan_to_num(a - b))
        assert np.all((d <= TOL) | (np.abs(d - UNIT) <= TOL)), float(d.max())
        off += int((d > TOL).sum())
        total += d.size
    if deriv2:
        assert off < 0.02 * total, (off, total)


COORDS_CASES = [
    {},
    {"center": "arena", "align": "Spine_1"},
    {"polar": True},
    {"speed": 1, "selected_id": "B"},
    {"center": "Center"},
    {"center": "Center", "speed": 1},
    {"to_video": True},
    {"center": "arena", "to_video": True},
    {"center": "arena", "align": "Spine_1", "align_group": True},
    {"center": "Center", "align": "Nose", "selected_id": "W"},
    {"polar": True, "center": "Center"},
    {"roi_number": 1},
    {"roi_number": 1, "invert_roi": True},
    {"roi_number": 1, "animals_in_roi": "W", "in_roi_criterion": "Nose", "center": "arena"},
]


@pytest.mark.parametrize("kw", COORDS_CASES, ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()) or "plain")
def test_get_coords_matches_jax(sides, kw):
    got = sides["port"][1].get_coords(**kw)
    want = sides["jax"][1].get_coords(**kw)
    _check_table(got, want)
    assert got._type == "coords" and got._center == kw.get("center", False)
    assert got._polar == kw.get("polar", False) and got._animal_ids == ["B", "W"]


def test_get_coords_polar_arena_center(sides):
    """Polar with center="arena" subtracts (hypot(cx, cy), atan2(cy, cx))
    of the arena centre from (rho, phi) (deepof_tpu/data.py:1570-1577; the
    JAX package raises there on a read-only array, so its polar table is
    shifted here)."""
    got = sides["port"][1].get_coords(polar=True, center="arena")
    want = sides["jax"][1].get_coords(polar=True)
    for key, df in want.items():
        cx, cy = sides["port"][1]._scales[key][:2]
        b = df.to_numpy(np.float64).reshape(len(df), -1, 2) - np.array([np.hypot(cx, cy), np.arctan2(cy, cx)])
        a = got[key].realize()
        assert got[key].columns == list(df.columns)
        np.testing.assert_allclose(a, b.reshape(len(df), -1), rtol=0, atol=TOL)


def test_absent_animal_and_roi_rows(sides):
    """W is absent on frames 90-101 of "test": every W column of every
    getter is NaN there, B's are not; the mask leaves an inter-animal
    distance alone (its value is NaN there all the same: W's positions are). ROI 1 leaves B's Center inside on some frames and outside
    on others."""
    coords = sides["port"][1]
    rows = slice(90, 102)
    for tab in (coords.get_coords()["test"], coords.get_distances(filter_on_graph=False)["test"],
                coords.get_angles()["test"], coords.get_areas()["test"]):
        arr = tab.realize()
        w = [tab.columns.index(c) for c in jfilter_columns(tab.columns, "W")]
        b = [tab.columns.index(c) for c in jfilter_columns(tab.columns, "B")]
        assert w and np.isnan(arr[rows][:, w]).all() and not np.isnan(arr[rows][:, b]).all()
    cols = [("B_Nose", "W_Nose"), ("W_Nose", "W_Tail_base"), "W_head_area", ("W_Nose", "x")]
    masked = coords._set_missing_animals(torch.ones((300, 4), dtype=torch.float64), cols, "test").numpy()
    assert not np.isnan(masked[:, 0]).any() and np.isnan(masked[rows, 1:]).all()
    assert np.isnan(masked[:, 1:]).sum() == 3 * 12
    roi = coords.get_coords(roi_number=1)["test"].realize()
    ci = coords.get_coords()["test"].columns.index(("B_Center", "x"))
    inside = ~np.isnan(roi[:, ci])
    assert 0.2 < inside.mean() < 0.8


DISTANCE_CASES = [
    {},
    {"filter_on_graph": False},
    {"speed": 1},
    {"selected_id": "B"},
    {"selected_id": "W", "filter_on_graph": False},
    {"roi_number": 1},
    {"roi_number": 1, "invert_roi": True, "filter_on_graph": False},
    {"roi_number": 1, "animals_in_roi": ["W"], "speed": 1},
]


@pytest.mark.parametrize("kw", DISTANCE_CASES, ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()) or "plain")
def test_get_distances_matches_jax(sides, kw):
    got = sides["port"][1].get_distances(**kw)
    _check_table(got, sides["jax"][1].get_distances(**kw), deriv2=bool(kw.get("speed")))
    assert got._type == "dists"


def test_get_distances_at_key_with_pairs(sides):
    pairs = [("W_Nose", "B_Nose"), ("B_Tail_base", "B_Nose"), ("W_Spine_1", "W_Center")]
    for key in ("test", "test2"):
        got = sides["port"][1].get_distances_at_key(key, filter_on_graph=False, pairs=pairs)
        want = sides["jax"][1].get_distances_at_key(key, filter_on_graph=False, pairs=pairs)
        assert len(got.columns) == 3
        a, b = _diffs(got, want)
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL, equal_nan=True)


ANGLE_CASES = [{}, {"degrees": True}, {"speed": 1}, {"degrees": True, "speed": 1}, {"selected_id": "W"}]


@pytest.mark.parametrize("kw", ANGLE_CASES, ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()) or "plain")
def test_get_angles_matches_jax(sides, kw):
    got = sides["port"][1].get_angles(**kw)
    _check_table(got, sides["jax"][1].get_angles(**kw), deriv2=bool(kw.get("speed")))
    assert got._type == "angles"


AREA_CASES = [{}, {"selected_id": "B"}, {"selected_id": "all", "speed": 1}]


@pytest.mark.parametrize("kw", AREA_CASES, ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()) or "plain")
def test_get_areas_matches_jax(sides, kw):
    got = sides["port"][1].get_areas(**kw)
    _check_table(got, sides["jax"][1].get_areas(**kw), deriv2=bool(kw.get("speed")))
    assert got._type == "areas"


def test_project_table_getters_match_jax(sides):
    """``Project.get_distances/get_angles/get_areas`` over a dict of
    position tables, and ``get_distances_tab`` over one table or a
    coordinates LazyFrame."""
    j_proj, j_coords = sides["jax"]
    p_proj, p_coords = sides["port"]
    tabs = {key: np.asarray(pos, np.float64) for key, pos in p_coords._tables.items()}
    for name in ("get_distances", "get_angles", "get_areas"):
        got, want = getattr(p_proj, name)(tabs), getattr(j_proj, name)(tabs)
        assert sorted(got) == sorted(want)
        for key in tabs:
            a, b = _diffs(got[key], want[key])
            np.testing.assert_allclose(a, b, rtol=0, atol=TOL, equal_nan=True)
    one = p_proj.get_distances_tab(p_coords.get_coords()["test"])
    np.testing.assert_array_equal(one.realize(), p_proj.get_distances({"t": tabs["test"]})["t"].realize())


def test_metadata_getters(sides):
    j_coords, p_coords = sides["jax"][1], sides["port"][1]
    assert list(p_coords.get_table_keys()) == list(j_coords.get_table_keys())
    assert p_coords.get_start_times() == j_coords.get_start_times()
    assert p_coords.get_exp_conditions is None and p_coords.get_start_markers is None
    assert p_coords.get_arenas()[:2] == j_coords.get_arenas()[:2]
    q_port, q_jax = p_coords.get_quality(), j_coords.get_quality()
    assert q_port._type == "quality"
    for key in q_jax:
        a, b = _diffs(q_port[key], q_jax[key])
        np.testing.assert_array_equal(a, b)
    rois_p, rois_j = p_coords.get_rois(), j_coords.get_rois()
    assert sorted(rois_p) == sorted(rois_j)
    for key in rois_j:
        np.testing.assert_array_equal(rois_p[key][1], rois_j[key][1])
    assert p_coords.get_supervised_parameters() == j_coords.get_supervised_parameters()
    p_coords.set_supervised_parameters({"follow_tol": 30})
    assert p_coords.get_supervised_parameters()["follow_tol"] == 30
    with pytest.warns(UserWarning, match="does not match"):
        p_coords.set_supervised_parameters({"no_such_parameter": 1})
    p_coords.reset_supervised_parameters()
    assert p_coords.get_supervised_parameters() == j_coords.get_supervised_parameters()

    p_coords._exp_conditions = {"test": {"CSDS": ["Stressed"]}, "test2": {"CSDS": ["Control"]}}
    p_coords._start_markers = {"test": {"m": ["00:00:01.000"]}, "test2": {"m": ["00:00:02.000"]}}
    try:
        assert p_coords.get_condition_values("CSDS") == ["Control", "Stressed"]
        assert p_coords.get_start_times("m") == {"test": "00:00:01.000", "test2": "00:00:02.000"}
        with pytest.raises(ValueError, match="not in experiment conditions"):
            p_coords.get_condition_values("other")
    finally:
        p_coords._exp_conditions = p_coords._start_markers = None
    conditions = os.path.join(sides["root"], "conditions.csv")
    with open(conditions, "w") as f:
        f.write(",experiment_id,CSDS\n0,test,Stressed\n1,test2,Control\n")
    loaded = Project(**{**_project_args(sides["root"], "csv"), "exp_conditions": conditions}, device="cpu")
    assert loaded.exp_conditions == {"test": {"CSDS": ["Stressed"]}, "test2": {"CSDS": ["Control"]}}
    with pytest.raises(FileNotFoundError):
        Project(**{**_project_args(sides["root"], "csv"), "exp_conditions": "no_such.csv"}, device="cpu")
    # return_path: each table written to {table_path}/{key}/{key}_got_distances, read back equal.
    in_memory, pointers = p_coords.get_distances(), p_coords.get_distances(return_path=True)
    for key in in_memory:
        assert pointers[key]["npy_table"] == os.path.join(p_coords._table_path, key, f"{key}_got_distances")
        np.testing.assert_array_equal(get_dt(pointers, key), in_memory[key].realize())
        assert get_dt(pointers, key, only_metainfo=True)["columns"] == in_memory[key].columns


def test_pickle_without_the_store_answers_the_getters(sides, tmp_path, monkeypatch):
    """A Coordinates pickled before the getters existed (no derived store,
    no supervised parameters) answers them after ``load_project``; a
    pickled store drops its device cache; a project on "cuda" raises
    without a GPU."""
    p_coords = sides["port"][1]
    want = p_coords.get_distances(filter_on_graph=False, speed=1)
    old = pickle.loads(pickle.dumps(p_coords))
    for attr in ("_derived_store", "_supervised_parameters"):
        old.__dict__.pop(attr, None)
    old._project_path, old._project_name = str(tmp_path), "old"
    old.save(timestamp=False)
    loaded = load_project(str(tmp_path / "old"))
    assert "_derived_store" not in loaded.__dict__
    got = loaded.get_distances(filter_on_graph=False, speed=1)
    for key in want:
        np.testing.assert_array_equal(got[key].realize(), want[key].realize())
    assert loaded.get_supervised_parameters() == p_coords.get_supervised_parameters()
    assert loaded._derived._cache and not pickle.loads(pickle.dumps(loaded))._derived._cache

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    loaded._device = "cuda"
    loaded.__dict__.pop("_derived_store")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loaded.get_coords()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loaded.get_areas()


def test_extend_processes_only_new_keys(sides, tmp_path):
    """A project of "test" alone, extended by a folder holding both
    recordings: only "test2" is processed, and the merged project's tables
    and getters equal those of the project created with both."""
    root, full = sides["root"], sides["port"][1]
    first = tmp_path / "first"
    for sub in ("Tables", "Videos"):
        os.makedirs(first / sub)
        for name in os.listdir(os.path.join(root, sub)):
            if name.startswith("testDLC"):
                with open(os.path.join(root, sub, name), "rb") as src, open(first / sub / name, "wb") as dst:
                    dst.write(src.read())
    args = {**_project_args(first, "csv"), "project_path": str(tmp_path), "project_name": "ext"}
    Project(**args, device="cpu").create(test=True, verbose=False)
    extended = Project(**{**args, "video_path": f"{root}/Videos", "table_path": f"{root}/Tables"},
                       device="cpu").extend(str(tmp_path / "ext"), test=True, verbose=False)
    assert sorted(extended._tables) == ["test", "test2"]
    assert sorted(os.listdir(first / "Tables")) == sorted(os.listdir(os.path.join(root, "Tables")))
    for key in ("test", "test2"):
        np.testing.assert_array_equal(extended._tables[key], full._tables[key])
    got, want = load_project(str(tmp_path / "ext")).get_areas(), full.get_areas()
    for key in ("test", "test2"):
        np.testing.assert_array_equal(got[key].realize(), want[key].realize())


# --------------------------------------------------------------------------- #
# The ops under the getters
# --------------------------------------------------------------------------- #


def _rand(seed, shape, nan_at=None):
    x = np.random.default_rng(seed).normal(scale=40.0, size=shape)
    if nan_at is not None:
        x[nan_at] = np.nan
    return x


def test_polygon_areas_and_to_polar_match_jax():
    x = _rand(1, (50, 9, 2), nan_at=(7, 2, 0))
    for poly in (np.array([0, 1, 2, 3]), np.array([4, 2, 8, 6, 5]), np.array([1, 2, 3])):
        got = pkin.polygon_areas(torch.as_tensor(x), poly).numpy()
        want = np.asarray(jkin.polygon_areas(jnp.asarray(x), poly))
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL, equal_nan=True)
    assert np.isnan(pkin.polygon_areas(torch.as_tensor(x), np.array([2, 3, 4])).numpy()[7])
    got = pkin.to_polar(torch.as_tensor(x)).numpy()
    want = np.asarray(jkin.to_polar(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-14, equal_nan=True)


@pytest.mark.parametrize("mode", ["all", "center", "none"])
def test_align_trajectories_matches_jax(mode):
    shape = (20, 7, 5, 2) if mode == "center" else (60, 5, 2)
    x = _rand(2, shape, nan_at=(3,))
    got = palign.align_trajectories(torch.as_tensor(x), mode=mode).numpy()
    want = np.asarray(jalign.align_trajectories(jnp.asarray(x), mode=mode))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL, equal_nan=True)
    if mode == "all":  # bodypart 0 lands on +y
        np.testing.assert_allclose(got[4:, 0, 0], 0.0, atol=1e-9)
        assert (got[4:, 0, 1] >= 0).all()


def test_point_in_polygon_matches_jax():
    rng = np.random.default_rng(3)
    pts = rng.uniform(-10, 110, size=(400, 2))
    pts[:5] = [[50, 0], [0, 50], [100, 100], [np.nan, 3], [30, 60]]  # on edges, a vertex, NaN
    for poly in (
        np.array([[0, 0], [100, 0], [100, 100], [0, 100], [0, 0]], float),  # closed repeat
        np.array([[0, 0], [60, 20], [100, 100], [30, 60], [0, 100]], float),  # concave
        np.array([[10, 10], [90, 10], [50, 90]], float),
    ):
        got = pgeom.point_in_polygon(torch.as_tensor(pts), poly).numpy()
        want = np.asarray(jgeom.point_in_polygon(jnp.asarray(pts), poly))
        np.testing.assert_array_equal(got, want)
        assert 0 < got.sum() < len(pts) and not got[3]
    np.testing.assert_array_equal(pgeom._close_polygon(poly), jgeom._close_polygon(poly))
