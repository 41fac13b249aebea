"""The port's embedding evaluation against the JAX package's, on the CPU:
the estimators it needs (``cluster.KMeans(n_init=10)`` and
``GaussianMixture`` with "tied" and "spherical" covariances, its score,
BIC and parameter counts) against sklearn itself; ``gmm_compute`` and
``gmm_model_selection`` over the four covariance types; compactness,
separability and kNN agreement (on data with exact duplicate rows, cosine
and euclidean, with and without subsampling); ``return_embedding_evaluation``
in both call layouts and alignment modes; the ``utils`` aliases; and the
device default of every new entry point.

Inputs are made from a seed with numpy and given to both packages (JAX on
the CPU in float64, sklearn as installed). Bars: compactness 1e-12
relative; separability's folds and ``n_used`` exactly, AP 1e-9; kNN's
``k``, ``n_ref``, ``n_pos_queries`` exactly, mean and std 1e-6; BICs 1e-8
relative with equal ``n_iter_`` and the same best setting; the restated
estimators' labels and iteration counts equal, centres and covariances
1e-10 (float64 data).
"""

import numpy as np
import pandas as pd
import pytest
import torch
from sklearn.cluster import KMeans as SkKMeans
from sklearn.mixture import GaussianMixture as SkGMM

from deepof_tpu import evaluation as jev
from deepof_tpu import visuals as jvis
from deepof_tpu.core.table_dict import TableDict as JaxTableDict

from deepof_tpu_torch import cluster, evaluation as pev, utils as putils, visuals as pvis
from deepof_tpu_torch.core.storage import LazyFrame
from deepof_tpu_torch.core.table_dict import TableDict
from deepof_tpu_torch.posthoc import Labelled

TOL_COMPACT, TOL_AP, TOL_KNN, TOL_BIC, TOL_FIT = 1e-12, 1e-9, 1e-6, 1e-8, 1e-10
COV_TYPES = ("spherical", "tied", "diag", "full")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's small CPU tensors on one thread (beside tier-1's other
    workers, more threads only spin)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-300)))


def _blobs(seed, n, k, d, spread=4.0):
    rng = np.random.default_rng(seed)
    centres = rng.normal(scale=spread, size=(k, d))
    return centres[rng.integers(0, k, n)] + rng.normal(size=(n, d))


def _embedding(seed, n, d, rate=0.15, duplicates=40):
    """(x float32 (n, d), y bool): a behaviour shifting the embedding, and
    blocks of exact duplicate rows (idle stretches) inside both classes."""
    rng = np.random.default_rng(seed)
    y = rng.random(n) < rate
    x = rng.normal(size=(n, d)) + 1.2 * y[:, None] * rng.normal(size=d)
    for start in rng.choice(n - duplicates, 4, replace=False):
        x[start:start + duplicates] = x[start]
    return x.astype(np.float32), y


# --------------------------------------------------------------------------- #
# The estimators against sklearn
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("seed,n,k,d,clusters", [(0, 400, 4, 3, 4), (1, 600, 6, 5, 8)])
def test_kmeans_n_init_matches_sklearn(seed, n, k, d, clusters):
    """Ten k-means++ + Lloyd runs from one RandomState, the best kept:
    equal labels, iteration count, centres and inertia."""
    x = _blobs(seed, n, k, d, spread=1.5)
    want = SkKMeans(clusters, n_init=10, random_state=0).fit(x)
    got = cluster.KMeans(clusters, n_init=10, random_state=0, device="cpu").fit(x)
    np.testing.assert_array_equal(got.labels_.numpy(), want.labels_)
    assert got.n_iter_ == want.n_iter_
    np.testing.assert_allclose(got.cluster_centers_.numpy(), want.cluster_centers_, rtol=0, atol=TOL_FIT)
    assert abs(float(got.inertia_) - want.inertia_) <= TOL_FIT * want.inertia_


@pytest.mark.parametrize("cov", COV_TYPES)
def test_gaussian_mixture_types_match_sklearn(cov):
    """Each covariance type: equal ``n_iter_``, parameters at 1e-10, equal
    predictions and responsibilities, ``score``, ``bic`` and
    ``_n_parameters``."""
    x = _blobs(3, 500, 3, 4)
    want = SkGMM(3, covariance_type=cov, random_state=0).fit(x)
    got = cluster.GaussianMixture(3, covariance_type=cov, random_state=0, device="cpu").fit(x)
    assert got.n_iter_ == want.n_iter_ and got.converged_ == want.converged_
    for name in ("weights_", "means_", "covariances_", "precisions_cholesky_"):
        np.testing.assert_allclose(getattr(got, name).numpy(), getattr(want, name), rtol=TOL_FIT, atol=TOL_FIT)
    np.testing.assert_array_equal(got.predict(x).numpy(), want.predict(x))
    np.testing.assert_allclose(got.predict_proba(x).numpy(), want.predict_proba(x), rtol=0, atol=TOL_FIT)
    assert got._n_parameters() == want._n_parameters()
    assert _rel(got.score(x), want.score(x)) <= TOL_FIT and _rel(got.bic(x), want.bic(x)) <= TOL_BIC


# --------------------------------------------------------------------------- #
# gmm_compute / gmm_model_selection against the JAX package
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("cov", COV_TYPES)
def test_gmm_compute_matches_jax(cov):
    x = _blobs(4, 300, 3, 4)
    (w_model, w_bic), (g_model, g_bic) = jev.gmm_compute(x, 3, cov), pev.gmm_compute(x, 3, cov, device="cpu")
    assert g_model.n_iter_ == w_model.n_iter_
    assert _rel(g_bic, w_bic) <= TOL_BIC


def test_gmm_model_selection_matches_jax():
    """The bootstrap draws from numpy's global state in the same order (a
    DataFrame on the JAX side, an array on the port's): every BIC at 1e-8,
    the medians, and the same best setting and run."""
    x = _blobs(5, 400, 3, 3)
    kw = dict(n_components_range=[2, 3], part_size=150, n_runs=3, cv_types=COV_TYPES)
    np.random.seed(11)
    w_bic, w_med, w_best = jev.gmm_model_selection(pd.DataFrame(x), n_cores=1, **kw)
    np.random.seed(11)
    g_bic, g_med, g_best = pev.gmm_model_selection(x, device="cpu", **kw)
    assert len(g_bic) == len(w_bic) == 8
    assert max(_rel(g, w) for g, w in zip(g_bic, w_bic)) <= TOL_BIC
    assert _rel(g_med, w_med) <= TOL_BIC
    assert (g_best.covariance_type, g_best.n_components, g_best.n_iter_) == \
        (w_best.covariance_type, w_best.n_components, w_best.n_iter_)
    np.testing.assert_allclose(g_best.means_.numpy(), w_best.means_, rtol=TOL_FIT, atol=TOL_FIT)
    np.random.seed(11)  # a tensor input draws the same rows
    t_bic = pev.gmm_model_selection(torch.as_tensor(x), device="cpu", **kw)[0]
    assert t_bic == g_bic


# --------------------------------------------------------------------------- #
# The three metrics
# --------------------------------------------------------------------------- #


def test_compactness_matches_jax():
    x, y = _embedding(0, 500, 6)
    want, got = jev.compute_compactness(x[y], x), pev.compute_compactness(x[y], x, device="cpu")
    assert list(got) == list(want)
    assert max(_rel(got[k], want[k]) for k in want) <= TOL_COMPACT
    assert np.isnan(pev.compute_compactness(x[:1], x, device="cpu")["trace_cov_pos"])


@pytest.mark.parametrize("max_train,c", [(100_000, 1.0), (300, 0.3)])
def test_separability_matches_jax(max_train, c):
    """Stratified folds, the class-balanced Newton fit (25 or more steps)
    and AP; the second case draws a class-proportional subsample first."""
    x, y = _embedding(1, 600, 5)
    want = jev.compute_separability_logreg(x, y, seed=3, c=c, max_train=max_train)
    got = pev.compute_separability_logreg(x, y, seed=3, c=c, max_train=max_train, device="cpu")
    assert list(got) == list(want) and got["n_used"] == want["n_used"]
    assert abs(got["ap_mean"] - want["ap_mean"]) <= TOL_AP and abs(got["ap_std"] - want["ap_std"]) <= TOL_AP
    assert got["n_used"] == (600 if max_train > 600 else 300)
    # The folds: numpy's draws on the host, the same in both packages.
    rng_a, rng_b = np.random.default_rng(3), np.random.default_rng(3)
    np.testing.assert_array_equal(pev._stratified_folds(y, 5, rng_a), jev._stratified_folds(y, 5, rng_b))
    none = pev.compute_separability_logreg(x, np.zeros(600), device="cpu")
    assert none["n_used"] == 0 and np.isnan(none["ap_mean"])


def test_logreg_fit_matches_jax():
    """The Newton/IRLS fit alone, float64 coefficients at 1e-10."""
    import jax.numpy as jnp

    x, y = _embedding(2, 400, 4)
    x = x.astype(np.float64)
    want = np.asarray(jev._fit_logreg_weighted(jnp.asarray(x), jnp.asarray(y, jnp.float64), l2=1.0, steps=25))
    got = pev._fit_logreg_weighted(torch.as_tensor(x), torch.as_tensor(y, dtype=torch.float64), l2=1.0, steps=25)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL_FIT, atol=TOL_FIT)


@pytest.mark.parametrize("metric,max_points,max_pos", [("cosine", 50_000, 10_000), ("euclidean", 50_000, 10_000),
                                                       ("cosine", 350, 40)])
def test_knn_agreement_matches_jax(metric, max_points, max_pos):
    """Exact duplicate rows tie: the lower index ranks first on both
    sides, which decides the dropped self-match."""
    x, y = _embedding(3, 700, 8)
    kw = dict(k=10, seed=2, max_points=max_points, max_pos_queries=max_pos, metric=metric)
    want = jev.compute_knn_agreement(x, y, **kw)
    got = pev.compute_knn_agreement(x, y, device="cpu", **kw)
    assert list(got) == list(want)
    for key in ("k", "n_ref", "n_pos_queries"):
        assert got[key] == want[key]
    assert abs(got["pos_knn_agree_mean"] - want["pos_knn_agree_mean"]) <= TOL_KNN
    assert abs(got["pos_knn_agree_std"] - want["pos_knn_agree_std"]) <= TOL_KNN


def test_neighbour_ties_rank_lower_index_first():
    """A hand-made similarity row: the kth value tied across the boundary
    keeps the lowest indices; the first of the tied maxima is dropped."""
    sim = torch.tensor([[0.5, 0.9, 0.7, 0.9, 0.7, 0.7, 0.1]])
    y = torch.tensor([1.0, 0.0, 1.0, 1.0, 0.0, 1.0, 1.0])
    # top 4 by lax.top_k: idx 1 (0.9), 3 (0.9), 2 (0.7), 4 (0.7); drop idx 1.
    got = pev._neighbour_fraction(sim, y, 4)
    assert float(got[0]) == pytest.approx((1.0 + 1.0 + 0.0) / 3)


def test_knn_similarity_sums_features_in_order():
    """The similarities are the float32 products added feature by feature
    in order, bit for bit (what every device computes), and the unit rows
    the float64 quotients rounded to float32."""
    rng = np.random.default_rng(4)
    q, r = rng.normal(size=(37, 8)).astype(np.float32), rng.normal(size=(53, 8)).astype(np.float32)
    want = q[:, 0, None] * r[None, :, 0]
    for j in range(1, 8):
        want = want + q[:, j, None] * r[None, :, j]
    got = pev._dot_rows(torch.as_tensor(q), torch.as_tensor(r.T.copy()))
    np.testing.assert_array_equal(got.numpy(), want)
    q64 = q.astype(np.float64)
    sq = q64[:, 0] * q64[:, 0]
    for j in range(1, 8):
        sq = sq + q64[:, j] * q64[:, j]
    want = (q64 / (np.sqrt(sq)[:, None] + 1e-12)).astype(np.float32)
    np.testing.assert_array_equal(pev._unit_rows(torch.as_tensor(q)).numpy(), want)


# --------------------------------------------------------------------------- #
# return_embedding_evaluation
# --------------------------------------------------------------------------- #

TAGS = ["B_climbing", "B_huddle", "W_rare", "B_speed", "B_distance_cum"]


@pytest.fixture(scope="module")
def evaluation_inputs():
    return make_evaluation_inputs()


def make_evaluation_inputs():
    """Three recordings: embeddings (windows of 9 frames, latent 6) and
    tags (binary behaviours with NaN gaps, a rare one, continuous speed
    and distance columns), for both packages."""
    rng = np.random.default_rng(7)
    window = 9
    j_emb, j_sup, p_emb, p_sup = {}, {}, {}, {}
    for key, t in (("a", 260), ("b", 230), ("c", 200)):
        tags = np.stack([
            rng.random(t) < 0.25, rng.random(t) < 0.4, rng.random(t) < 0.0015,
            rng.gamma(2.0, 3.0, t), rng.random(t) * 50], axis=1).astype(np.float64)
        tags[rng.choice(t, 5, replace=False), 0] = np.nan
        active = np.convolve(tags[:, 1], np.ones(window), "valid") > 3
        emb = rng.normal(size=(t - window + 1, 6)) + 1.5 * active[:, None]
        emb[10:30] = emb[10]  # an idle stretch of identical windows
        emb = emb.astype(np.float32)
        j_emb[key], p_emb[key] = emb, emb
        j_sup[key] = pd.DataFrame(tags, columns=TAGS)
        p_sup[key] = LazyFrame(lambda arr=tags: arr, TAGS, t)
    return {"jax": (JaxTableDict(j_emb, typ="unsupervised_embedding"), JaxTableDict(j_sup, typ="supervised")),
            "port": (TableDict(p_emb, typ="unsupervised_embedding"), TableDict(p_sup, typ="supervised"))}


def _same_evaluation(got: Labelled, want: pd.DataFrame):
    assert isinstance(got, Labelled)
    assert list(got.index) == list(want.index) and list(got.columns) == list(want.columns)
    want = want.to_numpy(np.float64)
    for j, name in enumerate(got.columns):
        tol = {"trace_cov_pos": TOL_COMPACT, "trace_cov_pos_norm_global": TOL_COMPACT}.get(name)
        if tol is not None:
            np.testing.assert_allclose(got.values[:, j], want[:, j], rtol=tol)
        elif "knn" in name:
            np.testing.assert_allclose(got.values[:, j], want[:, j], rtol=0, atol=TOL_KNN * 10)
        else:
            np.testing.assert_allclose(got.values[:, j], want[:, j], rtol=0, atol=TOL_AP * 10)


@pytest.mark.parametrize("mode", ["any", "center"])
def test_embedding_evaluation_matches_jax(evaluation_inputs, mode):
    """Both alignment modes, normalised: the rows (the behaviours past the
    positives floor, speed and distance columns left out), the columns and
    each metric at its bar (AP and kNN times the chance-level scale, at
    most 1 / 0.25)."""
    (j_emb, j_sup), (p_emb, p_sup) = evaluation_inputs["jax"], evaluation_inputs["port"]
    kw = dict(window_size=9, alignment_mode=mode, minimum_number_of_positives=20)
    want = jvis.return_embedding_evaluation(None, j_emb, j_sup, **kw)
    got = pvis.return_embedding_evaluation(None, p_emb, p_sup, device="cpu", **kw)
    assert got.index == ["B_climbing", "B_huddle"]
    _same_evaluation(got, want)


def test_embedding_evaluation_layouts_and_filters(evaluation_inputs):
    """The old layout (embeddings first, a behaviour list third) without
    normalising, the ``behaviors`` alias, the inferred window size, and an
    empty result."""
    (j_emb, j_sup), (p_emb, p_sup) = evaluation_inputs["jax"], evaluation_inputs["port"]
    picks = ["B_huddle", "B_distance_cum"]
    kw = dict(minimum_number_of_positives=20, normalize=False)
    want = jvis.return_embedding_evaluation(j_emb, j_sup, picks, **kw)
    got = pvis.return_embedding_evaluation(p_emb, p_sup, picks, device="cpu", **kw)
    assert got.index == picks
    _same_evaluation(got, want)
    got = pvis.return_embedding_evaluation(None, p_emb, p_sup, behaviors=picks, device="cpu", **kw)
    _same_evaluation(got, want)
    empty = pvis.return_embedding_evaluation(None, p_emb, p_sup, minimum_number_of_positives=10_000, device="cpu")
    assert empty.values.shape == (0, 0) and empty.index == [] and empty.columns == []
    with pytest.raises(ValueError, match="alignment_mode"):
        pvis.return_embedding_evaluation(None, p_emb, p_sup, alignment_mode="middle", device="cpu")


# --------------------------------------------------------------------------- #
# Aliases and devices
# --------------------------------------------------------------------------- #


def test_utils_aliases():
    x = _blobs(6, 200, 2, 2)
    model, bic = putils.gmm_compute(x, 2, "diag", device="cpu")
    assert bic == pev.gmm_compute(x, 2, "diag", device="cpu")[1] and model.n_iter_ >= 1
    np.random.seed(0)
    a = putils.gmm_model_selection(x, [2], 100, n_runs=2, cv_types=("full",), device="cpu")[0]
    np.random.seed(0)
    assert a == pev.gmm_model_selection(x, [2], 100, n_runs=2, cv_types=("full",), device="cpu")[0]


def test_entry_points_default_to_cuda_and_raise_without_gpu(monkeypatch, evaluation_inputs):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y = _embedding(5, 100, 4)
    p_emb, p_sup = evaluation_inputs["port"]
    calls = [
        lambda: pev.gmm_compute(x, 2, "full"),
        lambda: pev.gmm_model_selection(x, [2], 50, n_runs=1),
        lambda: pev.compute_compactness(x[y], x),
        lambda: pev.compute_separability_logreg(x, y),
        lambda: pev.compute_knn_agreement(x, y),
        lambda: pvis.return_embedding_evaluation(None, p_emb, p_sup),
        lambda: putils.gmm_compute(x, 2, "full"),
        lambda: cluster.KMeans(2, n_init=3).fit(x),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
