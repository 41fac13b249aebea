"""The port's chunk features, normative scoring, Kernel SHAP and burst
smoothing against the JAX package's, on the CPU: the kinematics views at
every derivative order (feature derivatives and angles included) and
``align_deepof_kinematics_with_unsupervised_labels``;
``chunk_summary_statistics`` on windows that are constant, all-NaN or hold
one value; ``annotate_time_chunks`` (the supervised merge, the confidence
rule, window steps, the ``samples`` draw, both aggregations);
``chunk_cv_splitter`` against sklearn's ``GroupKFold``; the normative KDE
(``fit_normative_global_model`` / ``score_against_normative`` on the
port's aggregated embeddings, far outliers included); ``kmeans_background``
and ``KernelExplainer`` at exact and sampled budgets; ``kleinberg`` and
``smooth_boolean_array``; and the device default of every new entry point.

Both packages create one project (device="cpu", float64 in the port) from
the seeded two-recording csv fixture of ``test_torch_public`` (300 frames,
two deepof_14 animals); soft counts, tags and embeddings are made from a
seed with numpy and given to both. Bars: labels, ``bin_info``, folds, the
bandwidth and the burst outputs exactly; the kinematics tables and the
chunk statistics built on them 1e-8 (the getters' float64 bar; a speed of a
distance, angle or area may sit one rounding unit of the JAX package's
off, as ``test_torch_getters`` holds them); ``chunk_summary_statistics``
1e-10 relative with equal NaN positions; log densities 1e-10 relative;
Shapley values and expected values 1e-10.
"""

import os
import warnings

import numpy as np
import pandas as pd
import pytest
import torch
from sklearn.model_selection import GroupKFold

from deepof_tpu import posthoc as jph
from deepof_tpu import shap_kernel as jshap
from deepof_tpu.core.storage import get_dt as jget_dt
from deepof_tpu.core.table_dict import TableDict as JaxTableDict
from deepof_tpu.data import Project as JaxProject
from deepof_tpu.ops import bursts as jbursts

from deepof_tpu_torch import posthoc as pph
from deepof_tpu_torch import shap_kernel as pshap
from deepof_tpu_torch.core.storage import LazyFrame, get_dt
from deepof_tpu_torch.core.table_dict import TableDict
from deepof_tpu_torch.data import Project
from deepof_tpu_torch.ops import bursts as pbursts

from test_torch_public import FPS, _project_args, write_project

KEYS = ("test", "test2")
TOL, TOL_STATS, TOL_KDE, TOL_SHAP = 1e-8, 1e-10, 1e-10, 1e-10
UNIT = 1e-3 * FPS  # one rounding unit of a speed (test_torch_getters)
K = 4
TAG_COLUMNS = ["B_W_nose2nose", "B_climbing", "W_huddle", "B_speed"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's small CPU tensors on one thread (beside tier-1's other
    workers, more threads only spin)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    return make_sides(tmp_path_factory.mktemp("chunks_project"))


def make_sides(directory):
    """The project in both packages (written under ``directory``), seeded
    soft counts (one recording's longer than its windows, the other's
    shorter) and tags (shorter than the first recording), each as both
    packages' TableDicts."""
    root = str(write_project(directory, "csv"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jc = JaxProject(**_project_args(root, "csv")).create(force=True, test=True, verbose=False)
    pc = Project(**{**_project_args(root, "csv"), "project_name": "port"}, device="cpu").create(
        force=True, test=True, verbose=False)
    rng = np.random.default_rng(3)
    counts, tags_j, tags_p = {}, {}, {}
    for key, n_counts, n_tags in zip(KEYS, (290, 250), (280, 300)):
        logits = rng.normal(size=(n_counts, K)) * 2.0
        soft = np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)
        soft[5] = np.nan  # a NaN row: no confidence, its argmax is its first NaN
        counts[key] = soft
        tags = np.column_stack([rng.random(n_tags) < 0.2, rng.random(n_tags) < 0.3, rng.random(n_tags) < 0.1,
                                rng.gamma(2.0, 2.0, n_tags)]).astype(np.float64)
        tags_j[key] = pd.DataFrame(tags, columns=TAG_COLUMNS)
        tags_p[key] = LazyFrame(lambda arr=tags: arr, TAG_COLUMNS, n_tags)
    return {"jax": jc, "port": pc,
            "counts": (JaxTableDict(counts, typ="unsupervised_counts"), TableDict(counts, typ="unsupervised_counts")),
            "tags": (JaxTableDict(tags_j, typ="supervised"), TableDict(tags_p, typ="supervised"))}


def _close_kinematics(got: np.ndarray, want: np.ndarray):
    """Within TOL, or one rounding unit off on under 2% of entries (a
    speed of a distance, angle or area, as test_torch_getters holds them);
    NaNs equal."""
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    d = np.abs(np.nan_to_num(got - want))
    assert np.all((d <= TOL) | (np.abs(d - UNIT) <= TOL)), float(d.max())
    assert np.mean(d > TOL) < 0.02


# --------------------------------------------------------------------------- #
# Kinematics
# --------------------------------------------------------------------------- #


def test_kinematics_views_at_every_order_match_jax(sides):
    """kin_derivative 2 with feature derivatives and angles: labels (raw,
    speed, acceleration suffixes) and values of each view."""
    kw = dict(kin_derivative=2, include_feature_derivatives=True, include_angles=True)
    views = ["B", "W", None]
    want = jph._kinematics_table_views(sides["jax"], views=views, file_name=None, **kw)
    for key in KEYS:
        got = pph._kinematics_table_views(sides["port"], views, key, **kw)
        for view in views:
            w = jget_dt(want[view], key)
            assert got[view].columns == list(w.columns)
            _close_kinematics(got[view].values.numpy(), w.to_numpy(np.float64))
    assert any(c.endswith("_acceleration") for c in got["B"].columns)
    assert any(c.startswith("('B_") and c.endswith("_raw") and c.count("'") == 6 for c in got["B"].columns)


def test_align_kinematics_matches_jax(sides):
    """The public call at its defaults for one animal, and with
    ``return_path`` (its tables written as pointers, read back equal)."""
    want = jph.align_deepof_kinematics_with_unsupervised_labels(sides["jax"], animal_id="B", file_name=None)
    got = pph.align_deepof_kinematics_with_unsupervised_labels(sides["port"], animal_id="B", device="cpu")
    assert sorted(got) == sorted(want)
    for key in KEYS:
        w = jget_dt(want, key)
        assert isinstance(got[key], LazyFrame) and got[key].columns == list(w.columns)
        _close_kinematics(got[key].realize(), w.to_numpy(np.float64))
    saved = pph.align_deepof_kinematics_with_unsupervised_labels(sides["port"], animal_id="B", return_path=True,
                                                                 device="cpu")
    for key in KEYS:
        assert saved[key]["npy_table"] == os.path.join(sides["port"]._table_path, key, f"{key}_kinematics")
        np.testing.assert_array_equal(get_dt(saved, key), got[key].realize())
        assert get_dt(saved, key, only_metainfo=True)["columns"] == got[key].columns


# --------------------------------------------------------------------------- #
# Chunk statistics
# --------------------------------------------------------------------------- #


def test_chunk_summary_statistics_match_jax():
    """Scattered NaNs, an all-NaN window, constant windows (small and
    large magnitude), one-value and two-value windows."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(30, 12, 3)) * rng.uniform(0.1, 100, size=(1, 1, 3))
    x[rng.random(x.shape) < 0.1] = np.nan
    x[0, :, 0] = np.nan
    x[1, :, 1] = 7.25
    x[2, :, 2] = -3.0e6
    x[3, :, 0] = np.nan
    x[3, 4, 0] = 2.0
    x[4, :, 1] = np.nan
    x[4, [2, 9], 1] = (1.0, 3.0)
    names = ["B_Nose", "B_Center", "W_Tail_base"]
    want = jph.chunk_summary_statistics(x, names)
    got = pph.chunk_summary_statistics(x, names, device="cpu")
    assert got.columns == list(want.columns) and got.index == list(range(30))
    w = want.to_numpy(np.float64)
    np.testing.assert_array_equal(np.isnan(got.values), np.isnan(w))
    np.testing.assert_allclose(got.values, w, rtol=TOL_STATS, atol=0, equal_nan=True)
    assert np.isnan(got.values[1, got.columns.index("B_Center_skew")])
    assert np.isnan(got.values[3, got.columns.index("B_Nose_kurt")])
    assert got.values[0, got.columns.index("B_Nose_abs_energy")] == 0.0


CHUNK_CASES = {
    "mean_tags_confidence": dict(aggregate="mean", tags=True, min_confidence=0.5, samples=None),
    "stats_draw": dict(aggregate="stats", tags=False, samples=150),
    "stats_tags_draw_step": dict(aggregate="stats", tags=True, samples=60, window_step=3, animal_id="B",
                                 window_size=10),
    "mean_distances_areas": dict(aggregate="mean", tags=False, samples=None, include_distances=True,
                                 include_areas=True, window_size=5, animal_id="W"),
}


@pytest.mark.parametrize("case", list(CHUNK_CASES))
def test_annotate_time_chunks_matches_jax(sides, case):
    """Labels and ``bin_info`` exactly; the chunks' statistics and their
    labels at the kinematics' bar. The draw reads numpy's global state:
    seeded the same before each package's call."""
    kw = dict(CHUNK_CASES[case])
    tags = kw.pop("tags")
    (j_counts, p_counts), (j_tags, p_tags) = sides["counts"], sides["tags"]
    np.random.seed(21)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        w_stats, w_y, w_bins = jph.annotate_time_chunks(sides["jax"], j_counts, j_tags if tags else None, **kw)
    np.random.seed(21)
    g_stats, g_y, g_bins = pph.annotate_time_chunks(sides["port"], p_counts, p_tags if tags else None,
                                                    device="cpu", **kw)
    np.testing.assert_array_equal(g_y, w_y.to_numpy())
    assert list(g_bins) == list(w_bins)
    for key in w_bins:
        np.testing.assert_array_equal(g_bins[key], w_bins[key])
    assert g_stats.columns == list(w_stats.columns) and len(g_stats.index) == len(w_stats)
    if tags:
        assert all(any(c.startswith(t) for c in g_stats.columns) for t in TAG_COLUMNS)
    _close_kinematics(g_stats.values, w_stats.to_numpy(np.float64))
    if kw.get("samples"):
        assert len(g_y) == kw["samples"]


# --------------------------------------------------------------------------- #
# CV folds
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("n_folds", [None, 2, 3])
def test_chunk_cv_splitter_matches_group_kfold(n_folds):
    """Experiments of unequal size (one empty): the folds of sklearn's
    ``GroupKFold`` and of the JAX package, in order."""
    bin_info = {"a": np.arange(7), "b": np.arange(12), "c": np.arange(0), "d": np.arange(12), "e": np.arange(3)}
    stats = np.zeros((34, 2))
    groups = np.repeat(np.arange(5), [7, 12, 0, 12, 3])
    n = n_folds or 4  # four non-empty experiments
    want = list(GroupKFold(n_splits=n).split(stats, groups=groups))
    got = pph.chunk_cv_splitter(pph.Labelled(stats, list(range(34)), [0, 1]), bin_info, n_folds=n)
    assert len(got) == len(want) == n
    for (g_tr, g_te), (w_tr, w_te) in zip(got, want):
        np.testing.assert_array_equal(g_tr, w_tr)
        np.testing.assert_array_equal(g_te, w_te)
    if n_folds is not None:
        jax_folds = jph.chunk_cv_splitter(pd.DataFrame(stats), bin_info, n_folds=n_folds)
        for (g_tr, g_te), (w_tr, w_te) in zip(got, jax_folds):
            np.testing.assert_array_equal(g_te, w_te)
    with pytest.raises(ValueError, match="greater than the number of groups"):
        pph.chunk_cv_splitter(stats, bin_info, n_folds=5)
    with pytest.raises(ValueError, match="n_splits=2 or more"):
        pph.chunk_cv_splitter(stats, {"a": np.arange(34)})


# --------------------------------------------------------------------------- #
# Normative KDE
# --------------------------------------------------------------------------- #


def test_normative_kde_matches_jax():
    """Fourteen experiments' mean embeddings (the port's aggregated
    Labelled, the JAX package's DataFrame): the KDE fitted on the twelve
    controls (ten folds of 2 and 1 rows), the same bandwidth, every
    experiment's log density at 1e-10, and far outliers, whose kernels
    underflow in linear space."""
    rng = np.random.default_rng(9)
    emb = {f"e{i:02d}": rng.normal(size=(50, 4)) + (3.0 if i >= 12 else 0.0) for i in range(14)}
    want_agg = jph.get_aggregated_embedding(JaxTableDict(emb, typ="unsupervised_embedding"))
    got_agg = pph.get_aggregated_embedding(TableDict(emb, typ="unsupervised_embedding"), device="cpu")
    controls = [k for k in got_agg.index if int(k[1:]) < 12]
    want_model = jph.fit_normative_global_model(want_agg.loc[controls])
    rows = [got_agg.index.index(k) for k in controls]
    got_model = pph.fit_normative_global_model(pph.Labelled(got_agg.values[rows], controls, got_agg.columns),
                                               device="cpu")
    assert got_model.bandwidth == want_model.bandwidth
    want = jph.score_against_normative(want_model, want_agg)
    got = pph.score_against_normative(got_model, got_agg)
    assert got.index == list(want.index) and got.columns == [0]
    np.testing.assert_allclose(got.values[:, 0], want.to_numpy(), rtol=TOL_KDE)
    far = np.array([[40.0, -35.0, 60.0, 10.0], [1e3, 0.0, 0.0, 0.0]])
    w_far, g_far = want_model.score_samples(far), got_model.score_samples(far)
    assert np.all(np.isfinite(g_far))
    np.testing.assert_allclose(g_far, w_far, rtol=TOL_KDE)
    with pytest.raises(ValueError, match="2 folds"):
        pph.fit_normative_global_model(got_agg.values[:1], device="cpu")


# --------------------------------------------------------------------------- #
# Kernel SHAP
# --------------------------------------------------------------------------- #


def _softmax_linear(w, b):
    """(numpy model, torch model): the same seeded softmax-linear map."""
    def np_model(x):
        z = np.asarray(x, float) @ w + b
        z = np.exp(z - z.max(axis=1, keepdims=True))
        return z / z.sum(axis=1, keepdims=True)

    tw, tb = torch.as_tensor(w), torch.as_tensor(b)

    def torch_model(x):
        return torch.softmax(x @ tw.to(x.device) + tb.to(x.device), dim=1)

    return np_model, torch_model


@pytest.mark.parametrize("m,nsamples,single", [(6, "auto", False), (10, 300, False), (5, "auto", True)])
def test_kernel_explainer_matches_jax(m, nsamples, single, monkeypatch):
    """A k-means background of seeded chunk statistics, then Shapley values
    of a softmax-linear model (its first output alone for ``single``) at
    an exact budget (2^m - 2 coalitions) and a sampled one; the port's
    model takes tensors, and its coalition values come in several model
    calls (a small SYNTH_ELEMENTS)."""
    rng = np.random.default_rng(m)
    x = rng.normal(size=(120, m)) * rng.uniform(0.5, 3, size=m)
    want_bg = jshap.kmeans_background(x, 6)
    got_bg = pshap.kmeans_background(x, 6, device="cpu")
    np.testing.assert_allclose(got_bg.data, want_bg.data, rtol=0, atol=TOL_SHAP)
    np.testing.assert_allclose(got_bg.weights, want_bg.weights, rtol=0, atol=TOL_SHAP)
    assert set(np.unique(got_bg.data[:, 0])) <= set(x[:, 0])
    np_model, torch_model = _softmax_linear(rng.normal(size=(m, 3)), rng.normal(size=3))
    if single:
        np_fn, torch_fn = (lambda v: np_model(v)[:, 0]), (lambda v: torch_model(v)[:, 0].numpy())
    else:
        np_fn, torch_fn = np_model, torch_model
    monkeypatch.setattr(pshap, "SYNTH_ELEMENTS", 5_000)
    want_ex = jshap.KernelExplainer(np_fn, want_bg)
    got_ex = pshap.KernelExplainer(torch_fn, got_bg, device="cpu")
    np.testing.assert_allclose(got_ex.expected_value, want_ex.expected_value, rtol=0, atol=TOL_SHAP)
    rows = x[:7]
    want = want_ex.shap_values(rows, nsamples=nsamples, random_state=4)
    got = got_ex.shap_values(torch.as_tensor(rows), nsamples=nsamples, random_state=4)
    if single:
        assert isinstance(got, np.ndarray) and got.shape == (7, m)
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL_SHAP)
    else:
        assert isinstance(got, list) and len(got) == len(want) == 3
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=TOL_SHAP)
    masks, weights, exact = pshap._build_coalitions(m, 300, np.random.default_rng(1))
    w_masks, w_weights, w_exact = jshap._build_coalitions(m, 300, np.random.default_rng(1))
    assert exact == w_exact == (2 ** m - 2 <= 300)
    np.testing.assert_array_equal(masks, w_masks)
    np.testing.assert_array_equal(weights, w_weights)


# --------------------------------------------------------------------------- #
# Bursts
# --------------------------------------------------------------------------- #


def test_kleinberg_matches_jax():
    """Seeded event offsets with bursts, regular gaps (tied level costs)
    and the explicit n / T / k arguments: the same intervals; the
    level DP against the JAX package's (its C++ kernel where built)."""
    rng = np.random.default_rng(2)
    cases = [
        (np.sort(np.concatenate([rng.choice(300, 40, replace=False), 500 + rng.choice(30, 20, replace=False)])), {}),
        (np.arange(0, 200, 5), {}),
        (np.sort(rng.choice(1000, 80, replace=False)), dict(s=3.0, gamma=0.5, k=4)),
        (np.sort(rng.choice(1000, 80, replace=False)), dict(n=100, T=2000.0)),
        (np.array([7]), {}),
    ]
    for offsets, kw in cases:
        want, got = jbursts.kleinberg(offsets, **kw), pbursts.kleinberg(offsets, **kw)
        assert got.dtype == object and got.shape == want.shape
        assert got.tolist() == want.tolist()
    gaps = np.diff(cases[0][0]).astype(np.float64)
    np.testing.assert_array_equal(pbursts._kleinberg_q(gaps, 2.0, 1.0, len(gaps), gaps.sum(), 5),
                                  jbursts._kleinberg_q(gaps, 2.0, 1.0, len(gaps), gaps.sum(), 5))
    with pytest.raises(ValueError, match="zero time"):
        pbursts.kleinberg([1, 1, 2])


def test_smooth_boolean_array_matches_jax():
    """A detection series with bursts over overlapping batches, and
    through the ``utils`` alias."""
    from deepof_tpu_torch import utils as putils

    rng = np.random.default_rng(4)
    a = rng.random(3000) < 0.03
    a[800:900] |= rng.random(100) < 0.6
    a[2100:2300] |= rng.random(200) < 0.5
    for batch in (50000, 700):
        want = jbursts.smooth_boolean_array(a, batch_size=batch)
        got = pbursts.smooth_boolean_array(a, batch_size=batch)
        np.testing.assert_array_equal(got, want)
        assert got.any()
    np.testing.assert_array_equal(putils.smooth_boolean_array(a), jbursts.smooth_boolean_array(a))
    assert putils.kleinberg(np.flatnonzero(a)).tolist() == jbursts.kleinberg(np.flatnonzero(a)).tolist()


# --------------------------------------------------------------------------- #
# Devices
# --------------------------------------------------------------------------- #


def test_entry_points_default_to_cuda_and_raise_without_gpu(monkeypatch, sides):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.random.default_rng(0).normal(size=(20, 3))
    p_counts = sides["counts"][1]
    calls = [
        lambda: pph.chunk_summary_statistics(x[:, :, None], ["a"]),
        lambda: pph.annotate_time_chunks(sides["port"], p_counts),
        lambda: pph.align_deepof_kinematics_with_unsupervised_labels(sides["port"]),
        lambda: pph.fit_normative_global_model(x),
        lambda: pph.GaussianKDE(1.0),
        lambda: pshap.kmeans_background(x, 3),
        lambda: pshap.KernelExplainer(lambda v: v.sum(1), x),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
