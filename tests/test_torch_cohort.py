"""The port's graph-dataset lanes on a cohort of recordings of unequal
length, against the JAX package's, on the CPU: the time bins, the three
scalers, the two-stage table scaler, both routes of ``TableDict.preprocess``
(the float32 device formulation on taken rows, the float64 general route),
``return_windows=True`` and the window aggregations, ``merge`` /
``filter_id`` / ``filter_condition``, ``sample_windows_from_data``, and
deepof's unsupervised tutorial through ``get_graph_dataset(animal_id=...,
align=...)`` -> ``deep_unsupervised_embedding`` -> ``embedding_per_video``.

The cohort is ``tests/test_torch_public.py``'s synthesizer with three
recordings ("test", "test2", "test3": 300, 260 and 220 frames, two deepof_14
animals) read through one arena file (the test arenas, "test3" taking
"test"'s). JAX runs in float64 and picks its routes as on an accelerator
(``DEEPOF_TPU_DEVICE_SCALE=1``); the port runs on the CPU in float64.

Bars: time bins, equal index arrays, warnings and errors; scalers against
sklearn on NaN-bearing data, 1e-10; the general route (scaled frames,
windows, fitted sections), 1e-8; the device route on taken rows, 1e-5
relative; VaDE embeddings and soft counts, 1e-5.
"""

import os
import warnings

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp
from sklearn.preprocessing import MinMaxScaler as SkMinMax
from sklearn.preprocessing import RobustScaler as SkRobust
from sklearn.preprocessing import StandardScaler as SkStandard

import deepof_tpu.utils as jutils
from deepof_tpu.core import table_dict as jtd
from deepof_tpu.core.storage import get_dt as jget_dt
from deepof_tpu.data import Project as JaxProject
from deepof_tpu.models import zoo as jzoo
from deepof_tpu.ops import windows as jwindows
from deepof_tpu.train.harness import ModelBundle as JaxBundle
from deepof_tpu.train.inference import embedding_per_video as jax_embed
from deepof_tpu.visuals_utils import preprocess_time_bins as jax_bins

from deepof_tpu_torch.core import table_dict as ptd
from deepof_tpu_torch.core.storage import LazyFrame, LazyWindows, get_dt
from deepof_tpu_torch.data import Project
from deepof_tpu_torch.models.zoo import build_model
from deepof_tpu_torch.ops import scaling as pscaling
from deepof_tpu_torch.ops import windows as pwindows
from deepof_tpu_torch.train.inference import ModelBundle, embedding_per_video
from deepof_tpu_torch.weights import from_flax_params

from test_torch_public import IDS, _project_args, write_project

KEYS = ("test", "test2", "test3")
LENGTHS = (300, 260, 220)
WINDOW = 8
LATENT, K = 4, 4
TOL64, TOL32 = 1e-8, 1e-5
TUTORIAL = dict(animal_id="B", center="Center", align="Spine_1", window_step=1,
                test_videos=1, scale="standard")


def _arena_file(root):
    """The test arenas of "test" and "test2", "test3" taking "test"'s, saved
    as an arena file both packages read."""
    probe = Project(**{**_project_args(root, "csv"), "project_name": "probe"}, device="cpu")
    scales, params, rois, res = probe.get_arena(test=True)
    for table in (scales, params, rois, res):
        table["test3"] = table["test"]
    path = os.path.join(root, "arena.pkl")
    probe.save_arena_data(path, params, rois, scales, res)
    return path


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = str(write_project(tmp_path_factory.mktemp("cohort"), "csv", lengths=LENGTHS, keys=KEYS))
    arena = _arena_file(root)
    j_coords = JaxProject(**_project_args(root, "csv")).create(force=True, arena_path=arena, verbose=False)
    p_coords = Project(**{**_project_args(root, "csv"), "project_name": "port"}, device="cpu").create(
        force=True, arena_path=arena, verbose=False)
    assert [len(p_coords._tables[k]) for k in KEYS] == list(LENGTHS)
    return j_coords, p_coords


@pytest.fixture
def device_scale(monkeypatch):
    """JAX picks its routes as on an accelerator."""
    monkeypatch.setenv("DEEPOF_TPU_DEVICE_SCALE", "1")


def _close(got, want, tol, rel=False):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=tol if rel else 0, atol=tol if rel else tol, equal_nan=True)


def _attrs(sc) -> dict:
    names = {"mean_", "var_", "scale_", "data_min_", "data_max_", "data_range_", "min_", "center_"}
    out = {}
    for name in names:
        v = getattr(sc, name, None)
        if v is not None:
            out[name] = (v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v, np.float64))
    return out


def _check_scalers(got, want, tol, rel=False):
    assert (got is None) == (want is None)
    if got is None:
        return
    assert got["kind"] == want["kind"]
    for name in ("speed", "dist", "dist_inner", "dist_intra", "coord"):
        assert (got[name] is None) == (want[name] is None), name
        if want[name] is not None:
            a, b = _attrs(got[name]), _attrs(want[name])
            assert set(a) >= set(b) - {"n_samples_seen_"} and a, name
            for attr in b:
                _close(a[attr].reshape(-1), b[attr].reshape(-1), tol, rel)


# --------------------------------------------------------------------------- #
# Time bins
# --------------------------------------------------------------------------- #

BIN_CASES = {
    "full_range": {},
    "seconds": dict(bin_size=2, bin_index=1),
    "frames": dict(bin_size=30, bin_index=40, given_in_frames=True),
    "time_strings": dict(bin_size="00:00:02.5", bin_index="00:00:01"),
    "precomputed": dict(precomputed_bins=np.arange(280) % 3 != 0),
    "precomputed_and_size": dict(precomputed_bins=np.ones(40, bool), bin_size=2, bin_index=0),
    "invalid_default_60s": dict(bin_size=2),
    "start_marker": dict(start_marker="start"),
    "start_marker_bin": dict(bin_size=1, bin_index=2, start_marker="start"),
    "experiment_id": dict(experiment_id="test2", bin_size=1, bin_index=3),
    "unknown_experiment": dict(experiment_id="nope"),
    "out_of_range": dict(bin_size=4, bin_index=3),
    "truncated": dict(bin_size="00:00:03", bin_index="00:00:08"),
    "zero_size": dict(bin_size=0, bin_index=0),
    "zero_frames": dict(bin_size=0, bin_index=0, given_in_frames=True),
    "subsampled": dict(samples_max=50),
    "first_rows": dict(samples_max=50, down_sample=False),
    "no_cap": dict(samples_max=None),
}


def _run_bins(fn, coords, kw):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            out = fn(coordinates=coords, **kw)
        except Exception as e:  # noqa: BLE001 - compared across packages
            out = (type(e), str(e))
    return out, [str(w.message) for w in caught]


@pytest.mark.parametrize("case", list(BIN_CASES))
def test_time_bins_match_jax(cohort, case):
    j_coords, p_coords = cohort
    markers = {key: pd.DataFrame({"start": [f"00:00:0{i}.5"]}) for i, key in enumerate(KEYS)}
    j_coords._start_markers = p_coords._start_markers = markers
    try:
        want, want_warn = _run_bins(jax_bins, j_coords, BIN_CASES[case])
        got, got_warn = _run_bins(ptd.preprocess_time_bins, p_coords, BIN_CASES[case])
    finally:
        j_coords._start_markers = p_coords._start_markers = None
    assert got_warn == want_warn
    if isinstance(want, tuple):
        assert got == want
        return
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
        assert got[key].dtype.kind == "i"


# --------------------------------------------------------------------------- #
# The three scalers and the two-stage table scaler
# --------------------------------------------------------------------------- #


def _nan_data(seed=0, n=201):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 7)) * rng.uniform(0.1, 50, size=7) + rng.normal(size=7) * 10
    x[rng.random(x.shape) < 0.1] = np.nan
    x[:, 1] = np.nan                      # all NaN
    x[:, 2] = 3.25                        # constant
    x[::2, 3] = np.nan                    # an even count of valid rows
    x[:, 4] = 1e8 + rng.normal(size=n) * 1e-9  # near-constant around a large mean
    return x


@pytest.mark.parametrize("kind", ["standard", "minmax", "robust"])
@pytest.mark.parametrize("groupwise", [False, True], ids=["per_column", "groupwise"])
def test_scalers_match_sklearn(kind, groupwise):
    x = _nan_data()
    if groupwise:
        x = x[:, [0, 3, 5]].reshape(-1, 1)
    sk = {"standard": SkStandard, "minmax": SkMinMax, "robust": SkRobust}[kind]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = sk().fit(x)
        got = pscaling.make_scaler(kind).fit(torch.as_tensor(x))
        probe = _nan_data(1, 33)[:, :x.shape[1]] if not groupwise else _nan_data(1, 33)[:, :1]
        want_t, want_i = want.transform(probe), want.inverse_transform(probe)
    a, b = _attrs(got), _attrs(want)
    assert set(a) == set(b)
    for name in b:
        _close(a[name], b[name], 1e-10, rel=True)
    assert isinstance(got.mean_ if kind == "standard" else got.scale_, torch.Tensor)
    _close(got.transform(torch.as_tensor(probe)), want_t, 1e-10, rel=True)
    _close(got.transform(probe), want_t, 1e-10, rel=True)  # numpy in, numpy out
    _close(got.inverse_transform(probe), want_i, 1e-10, rel=True)
    with pytest.raises(ValueError, match="Invalid scaler"):
        pscaling.make_scaler("quantile")


def test_quantiles_past_torch_limits():
    """The robust fit's quantiles by sort and index arithmetic: numpy's
    linear method, NaNs ignored, the midpoint of an even count."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1000, 3))
    x[rng.random(x.shape) < 0.2] = np.nan
    x[:, 2] = np.nan
    x[:4, 2] = [4.0, 1.0, 3.0, 2.0]
    got = pscaling._nanquantiles(torch.as_tensor(x), (0.25, 0.5, 0.75)).numpy()
    _close(got, np.nanpercentile(x, [25, 50, 75], axis=0), 1e-12, rel=True)
    assert got[1, 2] == 2.5


def _merged_host(coords):
    """One recording's merged getter table (coordinates, speeds, angles,
    distances) as (values, columns)."""
    td = coords.get_coords(center="arena").merge(coords.get_coords(speed=1), coords.get_angles(),
                                                 coords.get_distances())
    key = "test"
    if isinstance(td[key], LazyFrame):
        return get_dt(td, key), list(td[key].columns)
    return jget_dt(td, key)


@pytest.mark.parametrize("scale", ["standard", "minmax", "robust"])
@pytest.mark.parametrize("mode", ["per_column", "groupwise", None])
def test_scale_table_matches_jax(cohort, scale, mode):
    j_coords, p_coords = cohort
    values, columns = _merged_host(p_coords)
    df = pd.DataFrame(values, columns=pd.Index(columns, dtype=object, tupleize_cols=False))
    want = jutils.scale_table(df, scale=scale, animal_ids=IDS, dist_standardize=mode,
                              speed_standardize=mode, coord_standardize=mode)
    got = pscaling.scale_table(torch.as_tensor(values), columns, scale, IDS, dist_standardize=mode,
                               speed_standardize=mode, coord_standardize=mode)
    assert list(want.columns) == columns
    _close(got.numpy(), want.to_numpy(), TOL64)
    ct, jct = pscaling.infer_column_types(columns), jutils.infer_column_types(df)
    assert all(ct[k] == jct[k] for k in ("coords", "speeds", "dists", "angles", "inner_dists",
                                         "intra_dists", "scalars", "bodyparts"))
    factors, default = pscaling.compute_size_factors(torch.as_tensor(values), columns, IDS)
    j_factors, j_default = jutils.compute_size_factors(df, IDS)
    assert float(default) == pytest.approx(j_default, rel=1e-14)
    assert all(float(factors[a]) == pytest.approx(j_factors[a], rel=1e-14) for a in IDS)


# --------------------------------------------------------------------------- #
# get_graph_dataset's two routes
# --------------------------------------------------------------------------- #

GENERAL_CASES = {
    # the fused lane's frames trimmed to the shortest recording
    "fused_trimmed": dict(),
    "robust_groupwise_bins": dict(scale="robust", dist_standardize="groupwise",
                                  speed_standardize="groupwise", coord_standardize="groupwise",
                                  bin_size=4, bin_index=1),
    "minmax_past_samples_max": dict(scale="minmax", samples_max=100),
    "standard_groupwise_low_variance": dict(dist_standardize="groupwise", speed_standardize="groupwise",
                                            coord_standardize="groupwise", filter_low_variance=30.0),
    "animal_robust_precomputed": dict(animal_id="W", align="Nose", scale="robust",
                                      precomputed_bins=np.arange(240) % 4 != 1),
    "fused_past_samples_max": dict(samples_max=150, test_videos=1),
}


@pytest.fixture(scope="module")
def general_builds():
    return {}


def _both(cohort, builds, name, kw):
    if name not in builds:
        j_coords, p_coords = cohort
        mp = pytest.MonkeyPatch()
        mp.setenv("DEEPOF_TPU_DEVICE_SCALE", "1")
        try:
            want = j_coords.get_graph_dataset(window_size=WINDOW, **kw)
        finally:
            mp.undo()
        builds[name] = (p_coords.get_graph_dataset(window_size=WINDOW, **kw), want)
    return builds[name]


def _check_dataset(got, want, tol, rel=False, frames=True):
    (p_ds, p_meta, p_adj, p_tab, p_sc), (j_ds, j_meta, j_adj, j_tab, j_sc) = got, want
    for name in ("node_columns", "edge_columns", "angle_columns"):
        assert p_meta[name] == list(j_meta[name]), name
    np.testing.assert_array_equal(p_meta["inner_link_mask"], j_meta["inner_link_mask"])
    np.testing.assert_array_equal(p_adj, np.asarray(j_adj))
    for key in ("shape_train", "shape_test", "dist_standardize", "speed_standardize", "coord_standardize"):
        assert p_meta[key] == j_meta[key], key
    for key in j_tab:
        assert get_dt(p_tab, key, only_metainfo=True)["columns"] == list(
            jget_dt(j_tab, key, only_metainfo=True)["columns"])
    _check_scalers(p_sc, j_sc, tol, rel)
    if frames:
        assert list(p_tab._scaled_frames) == list(j_tab._scaled_frames)
        for key in j_tab._scaled_frames:
            frame = p_tab._scaled_frames[key]
            assert isinstance(frame, LazyFrame)
            _close(get_dt(p_tab._scaled_frames, key), jget_dt(j_tab._scaled_frames, key).to_numpy(), tol, rel)
            assert p_tab._scaled_device[key].dtype == torch.float32
    for j_part, p_part in zip(j_ds, p_ds):
        assert list(p_part) == list(j_part)
        for key in j_part:
            assert isinstance(p_part[key], LazyWindows)
            for g, w in zip(get_dt(p_part, key), jget_dt(j_part, key)):
                _close(g, w, tol, rel)


@pytest.mark.parametrize("case", list(GENERAL_CASES))
def test_general_route_matches_jax(cohort, general_builds, case):
    """The float64 general route, where the JAX package takes its host
    passes: every scaler, groupwise modes, the low-variance filter, bins,
    fused-lane frames trimmed to the shortest recording or subsampled."""
    kw = GENERAL_CASES[case]
    got, want = _both(cohort, general_builds, case, kw)
    binned = any(k in kw for k in ("bin_size", "precomputed_bins"))
    assert hasattr(got[3], "_scaled_frames") != binned
    _check_dataset(got, want, TOL64, frames=not binned)
    for part in got[0]:
        for key, frame in part._device_frames.items():
            assert frame.dtype == torch.float32 and part._deferred_f32[key].dev64.dtype == torch.float64
    if "filter_low_variance" in kw:  # some columns were filtered out, and came back as zeros
        frame = get_dt(got[3]._scaled_frames, "test")
        assert 0 < int((np.abs(frame).max(axis=0) == 0).sum()) < frame.shape[1] // 2


def test_global_fit_ignores_row_order(cohort):
    """The JAX package fits the global scaler on a RandomState(2)
    permutation of every taken row; the port on the rows in order. The fits
    agree."""
    x = _nan_data(7, 500)[:, [0, 3, 5, 6]]
    perm = np.random.RandomState(2).choice(len(x), size=len(x), replace=False)
    buckets = [x[:260], x[260:]]
    want = jtd._fast_fit_standard([b[np.random.RandomState(i).permutation(len(b))] for i, b in enumerate(buckets)])
    got = pscaling.fit_standard_lite([torch.as_tensor(b) for b in buckets])
    for name in ("mean_", "var_", "scale_"):
        _close(getattr(got, name), getattr(want, name), 1e-12, rel=True)
    for kind, sk in (("robust", SkRobust), ("minmax", SkMinMax)):
        a, b = _attrs(pscaling.make_scaler(kind).fit(torch.as_tensor(x))), _attrs(sk().fit(x[perm]))
        for name in b:
            _close(a[name], b[name], 1e-12, rel=True)


def test_unequal_lengths_take_the_device_route_on_taken_rows(cohort, general_builds):
    """An animal selection's tables, cut to the shortest recording: the
    float32 device formulation on the taken rows (rel 1e-5)."""
    got, want = _both(cohort, general_builds, "tutorial", TUTORIAL)
    _check_dataset(got, want, TOL32, rel=True)
    assert got[1]["shape_train"][0][0] == 2 * (min(LENGTHS) - WINDOW + 1)
    assert got[4]["speed"].__class__.__name__ == "_StandardScalerLite"
    for part in got[0]:
        assert all(h.dev64 is None for h in part._deferred_f32.values())


# --------------------------------------------------------------------------- #
# The tutorial's pipeline
# --------------------------------------------------------------------------- #


def _vade_bundles(meta, adj):
    n, e = len(meta["node_columns"]) // 3, len(meta["edge_columns"])
    jm = jzoo.build_model("VaDE", (WINDOW, n, 3), (WINDOW, e, 1), np.asarray(adj), latent_dim=LATENT,
                          n_components=K)
    shapes = jax.eval_shape(lambda *x: jm.init(jax.random.PRNGKey(0), *x),
                            jnp.zeros((1, WINDOW, n, 3)), jnp.zeros((1, WINDOW, e, 1)))["params"]
    rng = np.random.default_rng(11)
    params = jax.tree_util.tree_map(lambda v: rng.normal(scale=0.3, size=v.shape).astype(np.float32), shapes)
    spec = {"model": "VaDE", "input_shape": [WINDOW, n, 3], "edge_feature_shape": [WINDOW, e, 1],
            "n_components": K, "use_angles": False}
    j_bundle = JaxBundle(model=jm, variables={"params": jax.tree_util.tree_map(jnp.asarray, params)},
                         rebuild_spec=spec)
    pm = build_model("VaDE", (WINDOW, n, 3), (WINDOW, e, 1), adj, LATENT, K, device="cpu")
    pm.load_state_dict(from_flax_params(params, kind="VaDE"))
    return j_bundle, ModelBundle(pm.eval(), spec)


@pytest.mark.parametrize("reuse", [True, False], ids=["reuse_scaled", "pretrained_scaler"])
def test_tutorial_embeddings_match_jax(cohort, general_builds, device_scale, reuse):
    """embedding_per_video on the tutorial's dataset (animal B, aligned on
    Spine_1, one recording held out), with a VaDE on the same weights in both
    packages: the stashed scaled frames, and a new scaler object's
    preprocess."""
    j_coords, p_coords = cohort
    (_, p_meta, p_adj, p_tab, p_sc), (_, j_meta, _, j_tab, j_sc) = _both(cohort, general_builds, "tutorial",
                                                                         TUTORIAL)
    if not reuse:
        j_sc, p_sc = dict(j_sc), dict(p_sc)
    if "vade" not in general_builds:
        general_builds["vade"] = _vade_bundles(p_meta, p_adj)
    j_bundle, p_bundle = general_builds["vade"]
    j_emb, j_counts = jax_embed(j_coords, j_tab, j_bundle, j_meta, animal_id="B", global_scaler=j_sc,
                                batch_size=64)
    p_emb, p_counts = embedding_per_video(p_coords, p_tab, p_bundle, p_meta, animal_id="B",
                                          global_scaler=p_sc, batch_size=64)
    assert list(p_emb) == list(j_emb) and sorted(p_emb) == sorted(KEYS)
    for key in KEYS:
        assert p_emb[key].shape == (min(LENGTHS) - WINDOW + 1, LATENT)
        _close(p_emb[key], j_emb[key].to_numpy(), TOL32)
        _close(p_counts[key], j_counts[key].to_numpy(), TOL32)


def test_tutorial_trains_a_vade_and_serves(cohort, general_builds):
    """deep_unsupervised_embedding at its default model on the tutorial's
    LazyWindows and its held-out recording, then the bundle served."""
    _, p_coords = cohort
    ggd = _both(cohort, general_builds, "tutorial", TUTORIAL)[0]
    (train, test), meta, adj, tab, scaler = ggd
    assert len(test) == 1 and sorted(list(train) + list(test)) == sorted(KEYS)
    bundle, score, _, summary = p_coords.deep_unsupervised_embedding(
        ggd[:3], adjacency_matrix=adj, batch_size=16, latent_dim=LATENT, epochs=1, pretrain_epochs=1,
        n_clusters=K, verbose=False, limit_train_batches=2, limit_val_batches=1,
    )
    assert bundle.rebuild_spec["model"] == "VaDE" and bundle.rebuild_spec["input_shape"] == [WINDOW, 14, 3]
    assert any(k.startswith("val_") for k in summary) and all(np.isfinite(v) for v in summary.values())
    emb, counts = embedding_per_video(p_coords, tab, bundle, meta, animal_id="B", global_scaler=scaler,
                                      batch_size=64)
    for key in KEYS:
        assert np.isfinite(emb[key]).all()
        np.testing.assert_allclose(counts[key].sum(axis=1), 1.0, atol=1e-5)
    # A recording whose scaled frame is not on the device (kept on the host
    # past the frames budget) is uploaded from its host frame and embedded.
    frame = tab._scaled_device.pop("test3")
    tab._scaled_host["test3"] = frame.numpy()
    emb2, counts2 = embedding_per_video(p_coords, tab, bundle, meta, animal_id="B", global_scaler=scaler,
                                        batch_size=64)
    for key in KEYS:
        np.testing.assert_array_equal(emb2[key], emb[key])
        np.testing.assert_array_equal(counts2[key], counts[key])
    del tab._scaled_host["test3"]  # no host copy either: the table's float64 frame, cast
    emb3, _ = embedding_per_video(p_coords, tab, bundle, meta, animal_id="B", global_scaler=scaler, batch_size=64)
    np.testing.assert_array_equal(emb3["test3"], emb["test3"])
    tab._scaled_device["test3"] = frame


# --------------------------------------------------------------------------- #
# Windows, table operations, window sampling
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("shuffle", [False, True], ids=["ordered", "shuffled"])
def test_return_windows_matches_jax(cohort, general_builds, shuffle):
    """preprocess(return_windows=True) of the merged tables (groupwise
    robust scaling, one recording held out): the window stacks, in the
    order numpy's global state shuffles them."""
    got, want = _both(cohort, general_builds, "fused_trimmed", {})
    kw = dict(window_size=WINDOW, window_step=2, scale="robust", test_videos=1, shuffle=shuffle)
    (j_train, j_test), j_meta, j_sc = want[3].preprocess(coordinates=cohort[0], **kw)
    (p_train, p_test), p_meta, p_sc = got[3].preprocess(coordinates=cohort[1], **kw)
    assert p_meta == j_meta and p_meta["shape_train"][1:] == (WINDOW, len(got[3]["test"].columns))
    _check_scalers(p_sc, j_sc, TOL64)
    for p_part, j_part in ((p_train, j_train), (p_test, j_test)):
        assert list(p_part) == list(j_part)
        for key in j_part:
            _close(p_part[key], j_part[key], TOL64)


@pytest.mark.parametrize("aggregate", [None, "mid", "mean", "wta", "lta"])
def test_extract_windows_aggregates_match_jax(aggregate):
    rng = np.random.default_rng(5)
    tabs = {k: rng.integers(0, 3, size=(40 + 7 * i, 3)).astype(np.float64) for i, k in enumerate(KEYS)}
    p_td = ptd.TableDict({k: LazyFrame(lambda a=a: a, ["a", "b", "c"], len(a)) for k, a in tabs.items()}, "x")
    j_td = jtd.TableDict({k: pd.DataFrame(a) for k, a in tabs.items()}, "x")
    got, got_shape = ptd.extract_windows(p_td, 6, 2, aggregate=aggregate)
    want, want_shape = jtd.extract_windows(j_td, 6, 2, aggregate=aggregate)
    assert got_shape == want_shape
    for key in KEYS:
        _close(got[key], want[key], 1e-12)
    if aggregate in ("mid", "mean"):
        w = torch.as_tensor(rng.normal(size=(9, 5, 2)))
        _close(pwindows.aggregate_windows(w, aggregate).numpy(),
               np.asarray(jwindows.aggregate_windows(jnp.asarray(w.numpy()), aggregate)), 1e-12)


def test_merge_filter_id_and_filter_condition_match_jax(cohort):
    j_coords, p_coords = cohort
    j_td = j_coords.get_coords(center="arena").merge(
        j_coords.get_coords(speed=1), j_coords.get_angles(), j_coords.get_distances())
    p_td = p_coords.get_coords(center="arena").merge(
        p_coords.get_coords(speed=1), p_coords.get_angles(), p_coords.get_distances())
    conds = {key: pd.DataFrame({"group": [g], "day": [1]}) for key, g in zip(KEYS, ("a", "b", "a"))}
    j_td._exp_conditions = p_td._exp_conditions = conds
    for got, want in ((p_td, j_td), (p_td.filter_id("W"), j_td.filter_id("W")),
                      (p_td.filter_condition({"group": "a", "day": 1}),
                       j_td.filter_condition({"group": "a", "day": 1}))):
        assert list(got) == list(want) and got._type == want._type
        for key in want:
            assert list(got[key].columns) == list(want[key].columns)
            _close(get_dt(got, key), want[key].to_numpy(), TOL64)
    assert sorted(p_td.filter_condition({"group": "a"})) == ["test", "test3"]
    assert p_td.filter_condition({"group": "a"})._exp_conditions.keys() == {"test", "test3"}

    # On the device: the getters' tables merged there stay there.
    parts = []
    for typ, fn in (("coords", lambda k: p_coords.get_coords_at_key(k, center="arena", _device=True)),
                    ("dists", lambda k: p_coords.get_distances_at_key(k, _device=True))):
        td = ptd.TableDict({}, typ)
        td._device_frames = {}
        for key in KEYS:
            arr, cols = fn(key)
            td._device_frames[key], td[key] = arr, ptd._device_lazy(arr, cols)
        parts.append(td)
    merged = parts[0].merge(parts[1])
    assert sorted(merged._device_frames) == sorted(KEYS)
    for key in KEYS:
        assert isinstance(merged._device_frames[key], torch.Tensor)
        _close(get_dt(merged, key), j_coords.get_coords(center="arena").merge(
            j_coords.get_distances())[key].to_numpy(), TOL64)
        only_b = merged.filter_id("B")
        assert only_b[key].columns == [c for c in merged[key].columns
                                      if c in set(jutils.filter_columns(merged[key].columns, "B"))]
        assert only_b._device_frames[key].shape[1] == len(only_b[key].columns)
    # The projections: NaN in the tables (absent animals) is refused by both
    # packages; on the tables with NaN set to 0, the JAX package's kernel PCA.
    j_merged = j_coords.get_coords(center="arena").merge(j_coords.get_distances())
    with pytest.raises(ValueError, match="NaN"):
        merged.pca()
    with pytest.raises(ValueError, match="NaN"):
        j_merged.pca()
    merged._device_frames = {k: torch.nan_to_num(v, nan=0.0) for k, v in merged._device_frames.items()}
    j_filled = jtd.TableDict({k: j_merged[k].fillna(0.0) for k in KEYS}, typ="merged")
    got, proj = merged.pca()
    want, _ = j_filled.pca()
    assert got.shape == (len(KEYS), 2) and proj.kind == "pca"
    _close(got, want, TOL64)


@pytest.mark.parametrize("provided", [False, True], ids=["random_block", "time_bins"])
@pytest.mark.parametrize("no_nans", [False, True])
def test_sample_windows_from_data_matches_jax(provided, no_nans):
    rng = np.random.default_rng(9)
    tabs = {k: rng.normal(size=(30 + 10 * i, 4)) for i, k in enumerate(KEYS)}
    tabs["test2"][[3, 7, 20], 1] = np.nan
    bins = {k: np.arange(2, 25, 3) for k in KEYS} if provided else None
    p_td = ptd.TableDict(dict(tabs), "x")
    j_td = jtd.TableDict(dict(tabs), "x")
    got = p_td.sample_windows_from_data(bins, n_windows=12, no_nans=no_nans, return_edges=True, seed=4)
    want = j_td.sample_windows_from_data(bins, n_windows=12, no_nans=no_nans, return_edges=True, seed=4)
    for g, w in zip(got[:2], want[:2]):
        _close(g, w, 0)
    assert list(got[2]) == list(want[2])
    for key in want[2]:
        np.testing.assert_array_equal(got[2][key], want[2][key])
