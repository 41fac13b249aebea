"""The port's group comparison against the JAX package's, on the CPU:
conditions and start markers from csv (every pandas inference rule the
loaders meet), the conditions entry points of ``Project`` and
``Coordinates``, ``get_dt(load_range=...)`` / ``get_dt_rows``, the ROI
helpers and ``apply_rois_to_bin_info``, and the post-hoc statistics
(time on cluster, aggregated embeddings, enrichment, transitions, steady
states, condition separability) in their modes; then the slice as a whole:
a project with a conditions csv through ``get_graph_dataset`` and
``embedding_per_video`` of a carried VaDE, and the post-hoc battery on its
soft counts; and the port's plain path against the reference file of the
JAX package's VaDE outputs that ``chip_smoke.py`` holds the card to.

Inputs are made from a seed with numpy and given to both packages (JAX in
float64; its conditions as one-row DataFrames, the port's as
``ConditionTable``s). Bars: counts, labels and tables exactly; float64
statistics 1e-12; PCA, the logistic regression's AUC path and steady states
1e-8; AUC and the Wasserstein distance 1e-10; VaDE outputs 1e-5.
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch

from deepof_tpu import posthoc as jph
from deepof_tpu import utils as jutils
from deepof_tpu.core import storage as jstorage
from deepof_tpu.core.table_dict import TableDict as JaxTableDict
from deepof_tpu.data import Project as JaxProject
from deepof_tpu.io import conditions as jcond
from deepof_tpu.train.inference import embedding_per_video as jax_embed
from deepof_tpu.visuals_utils import apply_rois_to_bin_info as jax_rois
from deepof_tpu.visuals_utils import preprocess_time_bins as jax_bins

import chip_smoke
from deepof_tpu_torch import posthoc as pph
from deepof_tpu_torch import utils as putils
from deepof_tpu_torch.core import storage as pstorage
from deepof_tpu_torch.core.storage import LazyFrame
from deepof_tpu_torch.core.table_dict import TableDict, apply_rois_to_bin_info, preprocess_time_bins
from deepof_tpu_torch.data import Project
from deepof_tpu_torch.io import conditions as pcond
from deepof_tpu_torch.io.conditions import ConditionTable
from deepof_tpu_torch.train.inference import embedding_per_video, scanned_windowed_forward

from test_torch_cohort import _vade_bundles
from test_torch_public import _project_args, write_project

KEYS = ("test", "test2", "test3")
LENGTHS = (300, 260, 220)
WINDOW = 8  # test_torch_cohort's VaDE bundles: window 8, latent 4, K 4
EXACT, TOL64, TOL_FIT, TOL_AUC, TOL32 = 0.0, 1e-12, 1e-8, 1e-10, 1e-5
CONDITIONS = {"test": ("case", "f"), "test2": ("control", "m"), "test3": ("case", "m")}
MARKERS = {"test": (25, "00:00:01"), "test2": (50, "00:00:00.5"), "test3": (10, "00:00:02")}


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, equal_nan=True)


def _labelled(got, want, tol):
    assert isinstance(got, pph.Labelled)
    assert list(got.index) == list(want.index) and list(got.columns) == list(want.columns)
    _close(got.values, want.to_numpy(np.float64), tol)


def _enrichment(got, want, tol):
    assert list(got) == list(want.columns)
    for name in ("exp_id", "exp condition"):
        assert list(got[name]) == list(want[name])
    if want["cluster"].dtype.kind == "f":
        assert got["cluster"].dtype == np.float64
        np.testing.assert_array_equal(got["cluster"], want["cluster"].to_numpy())
    else:
        assert list(got["cluster"]) == list(want["cluster"]) and all(isinstance(c, str) for c in got["cluster"])
    _close(got["time on cluster"], want["time on cluster"].to_numpy(np.float64), tol)


def _conds(labels):
    """({key: one-row DataFrame}, {key: ConditionTable}) of {key: label}."""
    return ({k: pd.DataFrame({"condition": [v]}) for k, v in labels.items()},
            {k: ConditionTable(condition=[v]) for k, v in labels.items()})


# --------------------------------------------------------------------------- #
# Conditions and start markers from csv
# --------------------------------------------------------------------------- #

CSV_CASES = {
    "strings": ",experiment_id,condition,sex\n0,test,case,f\n1,test2,control,m\n2,test3,case,m\n",
    "frames": ",experiment_id,start\n0,test,150\n1,test2,200\n2,test3,7\n",
    "frames_and_times": ",experiment_id,frame_start,light_on\n0,test,250,00:00:10\n1,test2,500,00:00:20.5\n",
    "quoted_times": ',experiment_id,light\n0,test," 00:00:01.5 "\n1,test2,\'00:01:00\'\n2,test3,"""00:00:02"""\n',
    "int_and_time_mixed": ",experiment_id,start\n0,test,150\n1,test2,00:00:01\n",
    "empty_cell": ",experiment_id,condition\n0,test,case\n1,test2,\n",
    "na_string": ",experiment_id,condition\n0,test,NA\n1,test2,control\n",
    "int_with_empty": ",experiment_id,start\n0,test,150\n1,test2,\n",
    "float_column": ",experiment_id,start\n0,test,1.5\n1,test2,2\n",
    "bool_column": ",experiment_id,flag\n0,test,True\n1,test2,false\n",
    "numeric_ids": ",experiment_id,condition\n0,1,case\n1,2,control\n",
    "duplicate_ids": ",experiment_id,condition,start\n0,test,case,10\n1,test2,control,20\n2,test,other,30\n",
    "spaced_ints": ",experiment_id,start\n0,test, 150 \n1,test2,20\n",
    "repeated_and_unnamed_headers": ",experiment_id,c,c,\n0,test,x,y,z\n1,test2,u,v,w\n",
    "short_row": ",experiment_id,condition,group\n0,test,case\n1,test2,control,b\n",
    "nan_id": ",experiment_id,condition\n0,test,case\n1,,control\n",
}


def _load(fn, *args, **kwargs):
    try:
        return fn(*args, **kwargs)
    except (AssertionError, IndexError, ValueError) as e:
        return type(e)


def _same_tables(got, want):
    assert list(got) == list(want) and [type(k) for k in got] == [type(k) for k in want]
    for key, df in want.items():
        assert isinstance(got[key], ConditionTable) and got[key].columns == list(df.columns)
        for col in df.columns:
            a, b = got[key][col][0], df[col].iloc[0]
            assert isinstance(a, str) == isinstance(b, str)
            assert a == b or (pd.isna(a) and pd.isna(b)), (key, col, a, b)


@pytest.mark.parametrize("case", list(CSV_CASES))
def test_condition_csvs_match_jax(tmp_path, case):
    """Both loaders on csvs built to hit each of pandas' inference rules:
    equal tables, or a ValueError where the JAX package asserts (an
    IndexError for an empty id)."""
    path = tmp_path / "table.csv"
    path.write_text(CSV_CASES[case])
    for p_fn, j_fn, extra in ((pcond.load_exp_conditions, jcond.load_exp_conditions, ()),
                              (pcond.load_start_markers, jcond.load_start_markers, (25.0,)),
                              (pcond.load_start_markers, jcond.load_start_markers, (30.0,))):
        want, got = _load(j_fn, str(path), *extra), _load(p_fn, str(path), *extra)
        if isinstance(want, type):
            assert got is ValueError, (case, want, got)
        else:
            _same_tables(got, want)


def test_condition_csv_outcomes(tmp_path):
    """Which cases load: strings as conditions, frames and time strings as
    start markers (frames as time stamps at the frame rate)."""
    outcomes = {}
    for case, text in CSV_CASES.items():
        path = tmp_path / f"{case}.csv"
        path.write_text(text)
        outcomes[case] = (not isinstance(_load(pcond.load_exp_conditions, str(path)), type),
                          not isinstance(_load(pcond.load_start_markers, str(path), 25.0), type))
    assert [c for c, (cond, _) in outcomes.items() if cond] == [
        "strings", "quoted_times", "int_and_time_mixed", "numeric_ids", "repeated_and_unnamed_headers"]
    assert [c for c, (_, mark) in outcomes.items() if mark] == [
        "frames", "frames_and_times", "quoted_times", "spaced_ints"]


# --------------------------------------------------------------------------- #
# A project with conditions, start markers and ROI 1 (module scope)
# --------------------------------------------------------------------------- #


def _write_csvs(root):
    paths = os.path.join(root, "conditions.csv"), os.path.join(root, "markers.csv")
    for path, header, rows in ((paths[0], "experiment_id,condition,sex", CONDITIONS),
                               (paths[1], "experiment_id,frame_start,light_on", MARKERS)):
        with open(path, "w") as f:
            f.write(f",{header}\n" + "".join(f"{i},{k},{a},{b}\n" for i, (k, (a, b)) in enumerate(rows.items())))
    return paths


def _arena_file(root):
    """The test arenas ("test3" taking "test"'s) with ROI 1, the half-plane
    left of the median x of B's Center of each recording."""
    probe = Project(**{**_project_args(root, "csv"), "project_name": "probe"}, device="cpu")
    scales, params, rois, res = probe.get_arena(test=True)
    for table in (scales, params, rois, res):
        table["test3"] = table["test"]
    path = os.path.join(root, "arena.pkl")
    probe.save_arena_data(path, params, rois, scales, res)
    coords = probe.create(force=True, arena_path=path, verbose=False)
    ci = coords._nodes.index("B_Center")
    rois = {key: {1: np.array([[-1e4, -1e4], [xm, -1e4], [xm, 1e4], [-1e4, 1e4]])}
            for key, xm in ((k, float(np.nanmedian(p[:, ci, 0]))) for k, p in coords._tables.items())}
    probe.save_arena_data(path, params, rois, scales, res)
    return path


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    root = str(write_project(tmp_path_factory.mktemp("posthoc"), "csv", lengths=LENGTHS, keys=KEYS))
    arena = _arena_file(root)
    conditions, markers = _write_csvs(root)
    args = {**_project_args(root, "csv"), "exp_conditions": conditions, "start_markers": markers}
    mp = pytest.MonkeyPatch()
    mp.setenv("DEEPOF_TPU_DEVICE_SCALE", "1")
    try:
        j_proj = JaxProject(**args)
        j_coords = j_proj.create(force=True, arena_path=arena, verbose=False)
        j_ggd = j_coords.get_graph_dataset(window_size=WINDOW)
    finally:
        mp.undo()
    p_proj = Project(**{**args, "project_name": "port"}, device="cpu")
    p_coords = p_proj.create(force=True, arena_path=arena, verbose=False)
    p_ggd = p_coords.get_graph_dataset(window_size=WINDOW)
    return {"root": root, "paths": (conditions, markers), "jax": (j_proj, j_coords, j_ggd),
            "port": (p_proj, p_coords, p_ggd)}


def test_project_reads_conditions_and_start_markers(project):
    """Project(exp_conditions=path, start_markers=path) and the load_*
    methods of Project and Coordinates."""
    (j_proj, j_coords, _), (p_proj, p_coords, _) = project["jax"], project["port"]
    conditions, markers = project["paths"]
    _same_tables(p_proj.exp_conditions, j_proj.exp_conditions)
    _same_tables(p_proj.start_markers, j_proj.start_markers)
    _same_tables(p_coords.get_exp_conditions, j_coords.get_exp_conditions)
    _same_tables(p_coords.get_start_markers, j_coords.get_start_markers)
    assert p_coords.get_start_markers["test"]["frame_start"] == ["00:00:01.000000000"]
    assert p_coords.get_condition_values("condition") == j_coords.get_condition_values("condition")
    assert p_coords.get_condition_values("sex") == ["f", "m"]

    saved = p_coords._exp_conditions, p_coords._start_markers
    try:
        for owner in (p_proj, p_coords):
            owner.load_exp_conditions(conditions)
            owner.load_start_markers(markers)
            with pytest.raises(ValueError, match="Start markers must be"):
                owner.load_start_markers(conditions)
            with pytest.raises(ValueError, match="need to be strings"):  # the frame column
                owner.load_exp_conditions(markers)
        for got in ((p_proj.exp_conditions, p_proj.start_markers),
                    (p_coords._exp_conditions, p_coords._start_markers)):
            _same_tables(got[0], jcond.load_exp_conditions(conditions))
            _same_tables(got[1], jcond.load_start_markers(markers, 25))
    finally:
        p_proj.exp_conditions, p_proj.start_markers = saved
        p_coords._exp_conditions, p_coords._start_markers = saved


def test_start_marker_getters_match_jax(project):
    """get_start_times, get_start_marker_values (frames and strings),
    get_end_times, get_table_lengths(start_marker=...) of the project and of
    a TableDict, preprocess_time_bins(start_marker=...) and the raises."""
    (_, j_coords, (_, _, _, j_tab, _)), (_, p_coords, (_, _, _, p_tab, _)) = project["jax"], project["port"]
    for marker in ("frame_start", "light_on"):
        assert p_coords.get_start_times(marker) == j_coords.get_start_times(marker)
        for frames in (True, False):
            assert p_coords.get_start_marker_values(marker, frames) == j_coords.get_start_marker_values(
                marker, frames)
        assert p_coords.get_table_lengths(start_marker=marker) == j_coords.get_table_lengths(start_marker=marker)
        assert p_coords.get_table_lengths(p_tab, start_marker=marker) == j_coords.get_table_lengths(
            j_tab, start_marker=marker)
        for kw in ({}, {"bin_size": 2, "bin_index": 1}, {"bin_size": "00:00:03", "bin_index": "00:00:01"}):
            want = jax_bins(j_coords, start_marker=marker, **kw)
            got = preprocess_time_bins(p_coords, start_marker=marker, **kw)
            assert list(got) == list(want)
            for key in want:
                np.testing.assert_array_equal(got[key], want[key])
    assert p_coords.get_end_times() == j_coords.get_end_times()
    assert p_coords.get_start_marker_values("frame_start") == {"test": 25, "test2": 50, "test3": 10}
    with pytest.raises(AssertionError):
        j_coords.get_start_marker_values("missing")
    with pytest.raises(ValueError, match="missing at key"):
        p_coords.get_start_marker_values("missing")
    saved = p_coords._start_markers
    try:
        p_coords._start_markers = {k: ConditionTable(m=["00:01:00"]) for k in KEYS}
        j_coords._start_markers = {k: pd.DataFrame({"m": ["00:01:00"]}) for k in KEYS}
        with pytest.raises(AssertionError):
            j_coords.get_table_lengths(start_marker="m")
        with pytest.raises(ValueError, match="exceeding the length"):
            p_coords.get_table_lengths(start_marker="m")
    finally:
        p_coords._start_markers = saved
        j_coords._start_markers = project["jax"][0].start_markers


# --------------------------------------------------------------------------- #
# Storage: load_range and get_dt_rows
# --------------------------------------------------------------------------- #


def test_get_dt_ranges_match_jax():
    """Spans, index arrays, 1-element and 2-element index arrays, on arrays,
    tuples and frames (DataFrames in JAX, LazyFrames here)."""
    rng = np.random.default_rng(3)
    arr = rng.normal(size=(40, 3))
    tup = (rng.normal(size=(40, 2)), rng.normal(size=(40, 4, 2)))
    cols = ["a", "b", "c"]
    j_td = {"arr": arr, "tup": tup, "frame": pd.DataFrame(arr, columns=cols)}
    p_td = {"arr": arr, "tup": tup, "frame": LazyFrame(lambda: arr, cols, len(arr))}
    ranges = [None, np.array([3, 9]), [0, 39], np.array([5, 1, 7, 7, 20]), np.array([4]), np.arange(10, 30)]
    for key in j_td:
        for lr in ranges:
            want = jstorage.get_dt(j_td, key, load_range=lr)
            got = pstorage.get_dt(p_td, key, load_range=lr)
            for g, w in (zip(got, want) if key == "tup" else [(got, want)]):
                np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        for idx in (np.array([3, 9]), np.array([9, 3]), np.array([2, 5, 11]), None):
            want = jstorage.get_dt_rows(j_td, key, idx)
            got = pstorage.get_dt_rows(p_td, key, idx)
            for g, w in (zip(got, want) if key == "tup" else [(got, want)]):
                np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    t = torch.arange(12.0).reshape(6, 2)
    assert torch.equal(pstorage._slice_obj(t, [1, 3]), t[1:4])
    assert torch.equal(pstorage.get_dt_rows({"t": t}, "t", [4, 0]), t[[4, 0]])
    assert pstorage.get_dt(p_td, "frame", only_metainfo=True)["columns"] == cols


# --------------------------------------------------------------------------- #
# ROI helpers
# --------------------------------------------------------------------------- #

TAG_COLUMNS = ["B_climbing", "B_huddle", "W_climbing", "W_sniffing", "B_W_nose2nose", "W_B_nose2body",
               "B_speed", "W_speed", "B_distance", "W_cum-distance", "huddle_all"]


def _local_bin_info(rng, n, ids=("B", "W")):
    info = {"time": np.sort(rng.choice(3 * n, n, replace=False))}
    for aid in ids:
        info[aid] = rng.random(n) < 0.7
    return info


@pytest.mark.parametrize("ids", [("B", "W"), ("B",)], ids=["two_animals", "one_mask"])
def test_roi_helpers_match_jax(ids):
    rng = np.random.default_rng(5)
    n = 60
    info = _local_bin_info(rng, n, ids)
    tags = (rng.random((n, len(TAG_COLUMNS))) < 0.4).astype(float)
    df = pd.DataFrame(tags, columns=TAG_COLUMNS)
    for mode in ("mousewise", "behaviorwise"):
        for animals in ("B", ["B"], list(ids), None):
            want = jutils.get_supervised_behaviors_in_roi(df, info, animals, mode)
            got = putils.get_supervised_behaviors_in_roi(torch.as_tensor(tags), TAG_COLUMNS, info, animals, mode)
            _close(got.numpy(), want.to_numpy(np.float64), EXACT)
    with pytest.raises(NotImplementedError):
        putils.get_supervised_behaviors_in_roi(torch.as_tensor(tags), TAG_COLUMNS, info, "B", "framewise")
    for behavior in (None, "B_climbing", "W_climbing", "B_W_nose2nose", "huddle_all"):
        for animals in ("B", list(ids)):
            np.testing.assert_array_equal(putils.get_behavior_frames_in_roi(behavior, info, animals),
                                          jutils.get_behavior_frames_in_roi(behavior, info, animals))
    hard = rng.integers(0, 4, n).astype(float)
    hard[3] = np.nan
    soft = rng.random((n, 4))
    for values in (hard, soft, rng.integers(0, 4, (n, 4))):
        want = jutils.get_unsupervised_behaviors_in_roi(values, info, list(ids))
        got = putils.get_unsupervised_behaviors_in_roi(torch.as_tensor(values), info, list(ids))
        _close(got.numpy(), want, EXACT)


ROI_CASES = {
    "center": dict(roi_number=1),
    "all_bodyparts_inverted": dict(roi_number=1, in_roi_criterion="all", invert_roi=True),
    "two_criteria": dict(roi_number=1, in_roi_criterion=["Nose", "Center"]),
    "no_roi": dict(roi_number=None),
}


@pytest.mark.parametrize("case", list(ROI_CASES))
@pytest.mark.parametrize("bins", ["full", "time_bin", "span"])
def test_apply_rois_to_bin_info_matches_jax(project, case, bins):
    (_, j_coords, _), (_, p_coords, _) = project["jax"], project["port"]
    time = {"full": None, "time_bin": jax_bins(j_coords, bin_size=2, bin_index=1),
            "span": {k: np.array([10, 90]) for k in KEYS}}[bins]
    want = jax_rois(j_coords, bin_info_time=time, **ROI_CASES[case])
    got = apply_rois_to_bin_info(p_coords, bin_info_time=time, **ROI_CASES[case])
    assert list(got) == list(want)
    for key in want:
        assert list(got[key]) == list(want[key])
        for name in want[key]:
            assert got[key][name].dtype == want[key][name].dtype
            np.testing.assert_array_equal(got[key][name], want[key][name])
    if case == "center":
        inside = np.concatenate([got[k]["B"] for k in KEYS])
        assert 0.2 < inside.mean() < 0.8


# --------------------------------------------------------------------------- #
# Post-hoc statistics on seeded tables
# --------------------------------------------------------------------------- #

EXPS = ("e1", "e2", "e3", "e4", "e5", "e6")
T, K, D = 200, 5, 4
LABELS = {k: ("case" if i % 2 == 0 else "control") for i, k in enumerate(EXPS)}


def _seeded(seed=0, no_cluster_zero=False, nan_experiment=False):
    """{name: (JAX TableDict, port TableDict)} of soft counts (all-NaN,
    partly-NaN and tied rows), embeddings (a NaN row), labelled embeddings
    and tag tables, and {"bins": ...} of time bins and ROI masks."""
    rng = np.random.default_rng(seed)
    counts, emb, tags = {}, {}, {}
    for i, key in enumerate(EXPS):
        runs = rng.geometric(0.15, size=T)
        labels = np.repeat(rng.integers(0, K, size=T), runs)[:T]
        logits = rng.normal(size=(T, K)) + 2.0 * np.eye(K)[labels] + 0.6 * (i % 2) * np.arange(K)
        sc = np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)
        if no_cluster_zero:
            sc[:, 0] = 0.0
        sc[5] = np.nan
        sc[7, 2] = np.nan
        sc[9] = [0.05, 0.3, 0.3, 0.2, 0.15]
        counts[key] = sc
        e = rng.normal(size=(T, D)) + 0.3 * labels[:, None] + 0.5 * (i % 2)
        e[11] = np.nan
        if nan_experiment and key == "e3":
            e[:, 1] = np.nan
        emb[key] = e
        tags[key] = (rng.random((T, len(TAG_COLUMNS))) < 0.3 + 0.1 * (i % 2)).astype(float)
        tags[key][:, TAG_COLUMNS.index("B_speed")] = rng.random(T) * 10
        tags[key][13, 0] = np.nan
    j_conds, p_conds = _conds(LABELS)

    def both(tabs, typ, frame=False):
        j = {k: pd.DataFrame(v, columns=TAG_COLUMNS if v.shape[1] == len(TAG_COLUMNS) else
                             [f"dim_{c}" for c in range(v.shape[1])]) for k, v in tabs.items()} if frame else tabs
        p = {k: LazyFrame(lambda v=v: v, list(j[k].columns), len(v)) for k, v in tabs.items()} if frame else tabs
        return (JaxTableDict(j, typ=typ, exp_conditions=j_conds), TableDict(p, typ=typ, exp_conditions=p_conds))

    rois = {k: {**_local_bin_info(rng, 150), "time": np.sort(rng.choice(T, 150, replace=False))} for k in EXPS}
    return {
        "counts": both(counts, "unsupervised_counts"), "emb": both(emb, "unsupervised_embedding"),
        "emb_frame": both(emb, "unsupervised_embedding", frame=True), "tags": both(tags, "supervised", frame=True),
        "conds": (j_conds, p_conds),
        "bins": {"span": np.array([20, 160]), "dict": {k: np.arange(15, 175) for k in EXPS},
                 "dict_of_dicts": {k: {"time": np.arange(30, 190)} for k in EXPS}, "roi": rois},
    }


@pytest.fixture(scope="module")
def seeded():
    return {"plain": _seeded(), "no_cluster_zero": _seeded(no_cluster_zero=True),
            "nan_experiment": _seeded(nan_experiment=True)}


TIME_ON_CLUSTER_CASES = {
    "share": ({}, TOL64),
    "counts": (dict(normalize=False), EXACT),
    "reduce_dim": (dict(reduce_dim=True), TOL_FIT),
    "span": (dict(bin_info="span"), TOL64),
    "index_bins": (dict(bin_info="dict"), TOL64),
    "roi_one_animal": (dict(bin_info="roi", roi_number=1, animals_in_roi="B"), TOL64),
    "roi_two_animals": (dict(bin_info="roi", roi_number=1, animals_in_roi=["B", "W"], normalize=False), EXACT),
}


def _kw(data, kw):
    return {**kw, "bin_info": data["bins"][kw["bin_info"]]} if "bin_info" in kw else kw


@pytest.mark.parametrize("case", list(TIME_ON_CLUSTER_CASES))
@pytest.mark.parametrize("data", ["plain", "no_cluster_zero"])
def test_time_on_cluster_matches_jax(seeded, case, data):
    d = seeded[data]
    kw, tol = TIME_ON_CLUSTER_CASES[case]
    want = jph.get_time_on_cluster(d["counts"][0], **_kw(d, kw))
    got = pph.get_time_on_cluster(d["counts"][1], device="cpu", **_kw(d, kw))
    _labelled(got, want, tol)
    if data == "no_cluster_zero" and not kw.get("reduce_dim"):
        assert 0.0 not in got.columns


AGG_CASES = {
    "mean": (dict(agg="mean"), TOL64),
    "median": (dict(agg="median"), TOL64),
    "median_index_bins": (dict(agg="median", bin_info="dict"), TOL64),
    "mean_span_reduced": (dict(agg="mean", bin_info="span", reduce_dim=True), TOL_FIT),
    "median_reduced": (dict(agg="median", reduce_dim=True), TOL_FIT),
    "roi": (dict(agg="mean", bin_info="roi", roi_number=1, animals_in_roi=["B", "W"]), TOL64),
}


@pytest.mark.parametrize("case", list(AGG_CASES))
@pytest.mark.parametrize("data", ["plain", "nan_experiment"])
def test_aggregated_embedding_matches_jax(seeded, case, data):
    d = seeded[data]
    kw, tol = AGG_CASES[case]
    want = jph.get_aggregated_embedding(d["emb"][0], **_kw(d, kw))
    got = pph.get_aggregated_embedding(d["emb"][1], device="cpu", **_kw(d, kw))
    _labelled(got, want, tol)
    assert len(got.index) == (5 if data == "nan_experiment" else 6)


@pytest.mark.parametrize("roi_mode", ["mousewise", "behaviorwise"])
def test_aggregated_labelled_embedding_matches_jax(seeded, roi_mode):
    """A labelled table (a frame): supervised ROI masking by mode, and the
    columns holding "distance" dropped."""
    d = seeded["plain"]
    for emb in ("emb_frame", "tags"):
        kw = dict(agg="median", bin_info=d["bins"]["roi"], roi_number=1, animals_in_roi="B", roi_mode=roi_mode)
        want = jph.get_aggregated_embedding(d[emb][0], **kw)
        got = pph.get_aggregated_embedding(d[emb][1], device="cpu", **kw)
        _labelled(got, want, TOL64)


ENRICHMENT_CASES = {
    "counts_share": dict(source="counts", normalize=True),
    "counts_raw_bins": dict(source="counts", bin_info="dict"),
    "counts_roi": dict(source="counts", normalize=True, bin_info="roi", roi_number=1, animals_in_roi=["B"]),
    "tags": dict(source="tags"),
    "tags_share_span": dict(source="tags", normalize=True, bin_info="span"),
    "tags_speed": dict(source="tags", plot_speed=True),
    "tags_custom_continuous": dict(source="tags", custom_continuous_behavior_names=["nose2body"]),
    "tags_roi_behaviorwise": dict(source="tags", bin_info="roi", roi_number=1, animals_in_roi="W",
                                  roi_mode="behaviorwise"),
    "tags_roi_mousewise": dict(source="tags", normalize=True, bin_info="roi", roi_number=1,
                               animals_in_roi=["B", "W"]),
}


@pytest.mark.parametrize("case", list(ENRICHMENT_CASES))
@pytest.mark.parametrize("data", ["plain", "no_cluster_zero"])
def test_enrichment_matches_jax(seeded, case, data):
    d = seeded[data]
    kw = dict(ENRICHMENT_CASES[case])
    source = kw.pop("source")
    name = "soft_counts" if source == "counts" else "supervised_annotations"
    want = jph.enrichment_across_conditions(**{name: d[source][0]}, exp_conditions=d["conds"][0], **_kw(d, kw))
    got = pph.enrichment_across_conditions(**{name: d[source][1]}, exp_conditions=d["conds"][1], device="cpu",
                                           **_kw(d, kw))
    _enrichment(got, want, TOL64)


def test_enrichment_without_conditions_and_with_unequal_columns(seeded):
    d = seeded["plain"]
    j_tags = JaxTableDict({k: v.iloc[:, :-1] if k == "e2" else v for k, v in d["tags"][0].items()}, typ="s")
    p_tags = TableDict({k: LazyFrame(lambda v=v: v.to_numpy(), list(v.columns), len(v)) for k, v in j_tags.items()},
                       typ="s")
    _enrichment(pph.enrichment_across_conditions(supervised_annotations=p_tags, device="cpu"),
                jph.enrichment_across_conditions(supervised_annotations=j_tags), TOL64)


def test_transitions_match_jax():
    rng = np.random.default_rng(8)
    seq = rng.integers(0, 6, 300)
    idx = np.sort(rng.choice(600, 300, replace=False))
    for index_sequence in (None, idx):
        _close(pph.get_transitions(seq, 6, index_sequence, device="cpu"),
               jph.get_transitions(seq, 6, index_sequence), EXACT)
    assert pph.get_transitions(seq[:1], 6, device="cpu").sum() == 0
    with_nan = seq.astype(float)
    with_nan[[4, 40]] = np.nan
    for nclusts in (6, 12):
        got = pph.cluster_transition_matrix(with_nan, nclusts, device="cpu")
        want = jph.cluster_transition_matrix(with_nan, nclusts)
        _close(got[0], want[0], EXACT)
        _close(got[1], want[1], TOL64)
    _close(pph.cluster_transition_matrix(seq, 6, autocorrelation=False, device="cpu"),
           jph.cluster_transition_matrix(seq, 6, autocorrelation=False), EXACT)
    graph = pph.cluster_transition_matrix(seq, 6, autocorrelation=False, return_graph=True, device="cpu")
    assert graph.number_of_nodes() == 6


TRANSITION_CASES = {
    "aggregated": {},
    "per_video_silenced": dict(aggregate=False, silence_diagonal=True),
    "counts": dict(normalize=False),
    "span": dict(bin_info="span", silence_diagonal=True),
    "index_bins": dict(bin_info="dict", aggregate=False),
    "dict_of_dicts": dict(bin_info="dict_of_dicts", normalize=False),
    "roi": dict(bin_info="roi", roi_number=1, animals_in_roi=["B", "W"]),
    "roi_counts": dict(bin_info="roi", roi_number=1, animals_in_roi="W", normalize=False, aggregate=False),
}


@pytest.mark.parametrize("case", list(TRANSITION_CASES))
def test_transition_matrices_and_steady_states_match_jax(seeded, case):
    """Per condition or per video: hard labels with NaN winning (a row with
    one NaN), gaps of the bin or the ROI skipped; then the steady states."""
    d = seeded["plain"]
    kw = TRANSITION_CASES[case]
    want = jph.compute_transition_matrix_per_condition(d["counts"][0], d["conds"][0], **_kw(d, kw))
    got = pph.compute_transition_matrix_per_condition(d["counts"][1], d["conds"][1], device="cpu", **_kw(d, kw))
    assert list(got) == list(want)
    for key in want:
        _close(got[key], want[key], EXACT if kw.get("normalize") is False else TOL64)
    if kw.get("normalize") is not False:
        for entropy in (False, True):
            s_want = jph.compute_steady_state(want, return_entropy=entropy)
            s_got = pph.compute_steady_state(want, return_entropy=entropy, device="cpu")
            assert list(s_got) == list(s_want)
            for key in s_want:
                _close(s_got[key], s_want[key], TOL_FIT)


def test_nan_row_argmax():
    """A row's first NaN is its hard label in the transitions (np.argmax);
    time on cluster counts NaN as -inf and leaves all-NaN rows out."""
    rows = np.array([[0.1, np.nan, 0.8, np.nan], [0.5, 0.2, np.nan, 0.1], [np.nan] * 4, [0.2, 0.2, 0.1, 0.1],
                     [np.inf, 0.3, 0.1, np.nan]])
    hard = pph._hard_labels(torch.as_tensor(rows), nan_wins=True).tolist()
    assert hard == np.argmax(rows, axis=1).tolist() == [1, 2, 0, 0, 3]
    assert pph._hard_labels(torch.as_tensor(rows), nan_wins=False).tolist() == [2, 0, 0, 0, 0]
    j_td, p_td = JaxTableDict({"a": rows}, typ="c"), TableDict({"a": rows}, typ="c")
    _labelled(pph.get_time_on_cluster(p_td, normalize=False, device="cpu"),
              jph.get_time_on_cluster(j_td, normalize=False), EXACT)
    conds = _conds({"a": "x"})
    _close(pph.compute_transition_matrix_per_condition(p_td, conds[1], normalize=False, device="cpu")["x"],
           jph.compute_transition_matrix_per_condition(j_td, conds[0], normalize=False)["x"], EXACT)


def test_two_frame_index_arrays_diverge_by_design():
    """A dict entry of exactly two non-adjacent frames: the JAX package reads
    it as the span between them, the port as the two rows (the one
    divergence of the slice, ROADMAP queue 3)."""
    rng = np.random.default_rng(9)
    sc = rng.random((40, 3))
    j_td, p_td = JaxTableDict({"a": sc}, typ="c"), TableDict({"a": sc}, typ="c")
    bins = {"a": np.array([4, 30])}
    want_rows = np.bincount(sc[[4, 30]].argmax(1), minlength=3)
    got = pph.get_time_on_cluster(p_td, normalize=False, bin_info=bins, device="cpu")
    np.testing.assert_array_equal(got.values.sum(), 2)
    np.testing.assert_array_equal(got.values[0], want_rows[want_rows > 0])
    assert jph.get_time_on_cluster(j_td, normalize=False, bin_info=bins).to_numpy().sum() == 27
    span = pph.get_time_on_cluster(p_td, normalize=False, bin_info=np.array([4, 30]), device="cpu")
    _labelled(span, jph.get_time_on_cluster(j_td, normalize=False, bin_info=np.array([4, 30])), EXACT)
    conds = _conds({"a": "x"})
    got = pph.compute_transition_matrix_per_condition(p_td, conds[1], bin_info=bins, normalize=False, device="cpu")
    assert got["x"].sum() == 0  # two non-adjacent frames: no transition


SEPARATION_CASES = {
    "growing_auc_counts": dict(scan_mode="growing_window", agg="time_on_cluster", metric="auc", start_bin=40,
                               step_bin=50),
    "growing_auc_mean": dict(scan_mode="growing_window", agg="mean", metric="auc"),
    "per_bin_auc_median": dict(scan_mode="per-bin", agg="median", metric="auc", step_bin=60),
    "precomputed_auc_mean": dict(scan_mode="precomputed", agg="mean", metric="auc",
                                 precomputed_bins=np.array([50, 70, 60])),
    "growing_wasserstein": dict(scan_mode="growing_window", agg="mean", metric="wasserstein", start_bin=80,
                                step_bin=60),
    "precomputed_wasserstein_counts": dict(scan_mode="precomputed", agg="time_on_cluster",
                                           metric="wasserstein", precomputed_bins=np.array([90, 100])),
}


@pytest.mark.parametrize("case", list(SEPARATION_CASES))
def test_condition_distance_binning_matches_jax(seeded, case):
    d = seeded["plain"]
    kw = SEPARATION_CASES[case]
    want = jph.condition_distance_binning(d["emb"][0], d["counts"][0], d["conds"][0], **kw)
    got = pph.condition_distance_binning(d["emb"][1], d["counts"][1], d["conds"][1], device="cpu", **kw)
    assert got.shape == want.shape and len(got) >= 2
    _close(got, want, TOL_AUC)


def test_separation_between_conditions_and_its_raises(seeded):
    """A non-separable bin (AUC below 1), the plain-condition rule, and the
    errors of an unknown aggregation or metric, a missing precomputed_bins
    and a third condition."""
    d = seeded["plain"]
    rng = np.random.default_rng(12)
    noise = {k: rng.normal(size=(T, D)) for k in EXPS}
    j_emb, p_emb = JaxTableDict(noise, typ="e"), TableDict(noise, typ="e")
    for metric in ("auc", "wasserstein"):
        want = jph.separation_between_conditions(j_emb, None, np.array([0, 150]), d["conds"][0], "mean", metric)
        got = pph.separation_between_conditions(p_emb, None, np.array([0, 150]), d["conds"][1], "mean", metric,
                                                device="cpu")
        _close(got, want, TOL_AUC)
        if metric == "auc":
            assert got < 1.0
    assert pph._plain_condition(d["conds"][1]["e1"]) == jph._plain_condition(d["conds"][0]["e1"]) == "case"
    assert pph._plain_condition("x") == "x"
    for kw, match in ((dict(agg="max"), "Unknown aggregation"), (dict(metric="l2"), "Unknown metric")):
        with pytest.raises(ValueError, match=match):
            pph.separation_between_conditions(p_emb, d["counts"][1], None, d["conds"][1],
                                              **{"agg": "mean", "metric": "auc", **kw}, device="cpu")
    with pytest.raises(ValueError, match="precomputed_bins"):
        pph.condition_distance_binning(p_emb, d["counts"][1], d["conds"][1], scan_mode="precomputed", device="cpu")
    three = {**d["conds"][1], "e6": ConditionTable(condition=["other"])}
    for metric in ("auc", "wasserstein"):
        with pytest.raises(ValueError):
            pph.separation_between_conditions(p_emb, None, None, three, "mean", metric, device="cpu")


def test_sklearn_restatements():
    """The PCA + scaler, the logistic regression's AUC and the KDE draw
    against sklearn itself, where the fit is not separable."""
    from sklearn.decomposition import PCA
    from sklearn.linear_model import LogisticRegression
    from sklearn.metrics import roc_auc_score
    from sklearn.neighbors import KernelDensity
    from sklearn.pipeline import Pipeline
    from sklearn.preprocessing import StandardScaler

    rng = np.random.default_rng(13)
    x = rng.normal(size=(30, 6)) * np.array([5, 3, 1, 1, 0.5, 0.1])
    want = Pipeline([("PCA", PCA(n_components=2)), ("scaler", StandardScaler())]).fit_transform(x)
    _close(pph._pca2_scaled(torch.as_tensor(x)).numpy(), want, TOL_FIT)
    y = (x[:, 0] + rng.normal(scale=4.0, size=30) > 0).astype(float)
    proba = LogisticRegression(penalty=None).fit(x[:, :2], y).predict_proba(x[:, :2])[:, 1]
    _close(pph._logistic_auc(torch.as_tensor(x[:, :2]), torch.as_tensor(y)), roc_auc_score(y, proba), TOL_AUC)
    _close(pph._kde_sample(x[:, :2]), KernelDensity().fit(x[:, :2]).sample(100, random_state=0), EXACT)
    with pytest.raises(ValueError, match="n_components=2"):
        pph._pca2_scaled(torch.as_tensor(x[:1]))


def test_posthoc_entry_points_default_to_cuda_and_raise_without_gpu(seeded, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = seeded["plain"]
    calls = (
        lambda: pph.get_time_on_cluster(d["counts"][1]),
        lambda: pph.get_aggregated_embedding(d["emb"][1]),
        lambda: pph.enrichment_across_conditions(soft_counts=d["counts"][1], exp_conditions=d["conds"][1]),
        lambda: pph.get_transitions(np.zeros(4, int), 2),
        lambda: pph.cluster_transition_matrix(np.zeros(4), 2),
        lambda: pph.compute_transition_matrix_per_condition(d["counts"][1], d["conds"][1]),
        lambda: pph.compute_steady_state({"x": np.eye(2)}),
        lambda: pph.condition_distance_binning(d["emb"][1], d["counts"][1], d["conds"][1]),
        lambda: pph.separation_between_conditions(d["emb"][1], None, None, d["conds"][1], "mean"),
    )
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# --------------------------------------------------------------------------- #
# The slice as a whole, and the reference file of the JAX package's VaDE
# --------------------------------------------------------------------------- #


def test_conditions_project_to_posthoc_matches_jax(project):
    """The project with its conditions csv through get_graph_dataset and
    embedding_per_video (a VaDE carried from flax params): embeddings and
    soft counts at 1e-5 of the JAX serving forward; then the post-hoc
    battery on the port's soft counts and embeddings, in both packages."""
    (_, j_coords, j_ggd), (_, p_coords, p_ggd) = project["jax"], project["port"]
    (_, j_meta, _, j_tab, j_sc), (_, p_meta, p_adj, p_tab, p_sc) = j_ggd, p_ggd
    j_bundle, p_bundle = _vade_bundles(p_meta, p_adj)
    mp = pytest.MonkeyPatch()
    mp.setenv("DEEPOF_TPU_DEVICE_SCALE", "1")
    try:
        j_emb, j_counts = jax_embed(j_coords, j_tab, j_bundle, j_meta, global_scaler=j_sc, batch_size=64)
    finally:
        mp.undo()
    p_emb, p_counts = embedding_per_video(p_coords, p_tab, p_bundle, p_meta, global_scaler=p_sc, batch_size=64)
    assert list(p_emb) == list(j_emb) and sorted(p_emb) == sorted(KEYS)
    for key in KEYS:
        _close(p_emb[key], j_emb[key].to_numpy(), TOL32)
        _close(p_counts[key], j_counts[key].to_numpy(), TOL32)
    assert p_counts._exp_conditions is p_coords.get_exp_conditions

    # The port's outputs (float32) to both packages; the JAX side gets them
    # in float64, as the port computes every statistic (numpy keeps a
    # float32 table's means and medians in float32).
    j_conds, p_conds = j_coords.get_exp_conditions, p_coords.get_exp_conditions
    j_counts = JaxTableDict({k: v.astype(np.float64) for k, v in p_counts.items()}, typ="unsupervised_counts",
                            exp_conditions=j_conds)
    j_emb = JaxTableDict({k: v.astype(np.float64) for k, v in p_emb.items()}, typ="unsupervised_embedding",
                         exp_conditions=j_conds)
    j_bins = jax_bins(j_coords, bin_size=2, bin_index=1, start_marker="light_on", tab_dict_for_binning=j_counts)
    p_bins = preprocess_time_bins(p_coords, bin_size=2, bin_index=1, start_marker="light_on",
                                  tab_dict_for_binning=p_counts)
    for key in KEYS:
        np.testing.assert_array_equal(p_bins[key], j_bins[key])
    rois = apply_rois_to_bin_info(p_coords, 1, p_bins)
    _labelled(pph.get_time_on_cluster(p_counts, bin_info=rois, roi_number=1, animals_in_roi="B", device="cpu"),
              jph.get_time_on_cluster(j_counts, bin_info=jax_rois(j_coords, 1, j_bins), roi_number=1,
                                      animals_in_roi="B"), TOL64)
    _labelled(pph.get_aggregated_embedding(p_emb, agg="median", bin_info=p_bins, device="cpu"),
              jph.get_aggregated_embedding(j_emb, agg="median", bin_info=j_bins), TOL64)
    _enrichment(pph.enrichment_across_conditions(soft_counts=p_counts, exp_conditions=p_conds, normalize=True,
                                                 device="cpu"),
                jph.enrichment_across_conditions(soft_counts=j_counts, exp_conditions=j_conds, normalize=True),
                TOL64)
    want = jph.compute_transition_matrix_per_condition(j_counts, j_conds, silence_diagonal=True)
    got = pph.compute_transition_matrix_per_condition(p_counts, p_conds, silence_diagonal=True, device="cpu")
    assert list(got) == list(want) and sorted(got) == ["case", "control"]
    for cond in want:
        _close(got[cond], want[cond], TOL64)
    for entropy in (False, True):
        s_want, s_got = jph.compute_steady_state(want, entropy), pph.compute_steady_state(got, entropy, device="cpu")
        for cond in s_want:
            _close(s_got[cond], s_want[cond], TOL_FIT)
    for agg in ("time_on_cluster", "mean"):
        kw = dict(start_bin=60, step_bin=60, agg=agg)
        want = _load(jph.condition_distance_binning, j_emb, j_counts, j_conds, **kw)
        got = _load(lambda *a: pph.condition_distance_binning(*a, device="cpu", **kw), p_emb, p_counts, p_conds)
        if isinstance(want, type):  # a bin on which every frame takes one cluster: no 2-component PCA
            assert agg == "time_on_cluster" and got is want is ValueError
        else:
            _close(got, want, TOL_AUC)


def test_reference_file_matches_the_port():
    """The port's plain serving path against the JAX package's VaDE outputs
    that chip_smoke.py holds the card to (scripts/make_torch_reference.py):
    embeddings and soft counts at 1e-5, equal hard labels."""
    bundle, ref = chip_smoke.reference_bundle(chip_smoke.REFERENCE_NPZ, "cpu")
    assert ref["frame"].shape == (320, 77) and int(ref["latent"]) == 8 and int(ref["n_components"]) == 10
    assert os.path.getsize(chip_smoke.REFERENCE_NPZ) < 1 << 20
    layout = {"node": ref["node"].tolist(), "edge": ref["edge"].tolist(), "angle": None}
    emb, sc = scanned_windowed_forward(bundle, ref["frame"], layout, int(ref["window"]), "VaDE", block=128,
                                       device="cpu")
    _close(emb, ref["embeddings"], TOL32)
    _close(sc, ref["soft_counts"], TOL32)
    np.testing.assert_array_equal(sc.argmax(1), ref["hard_labels"])
