"""The port's cluster detectors against sklearn 1.9 and the JAX package, on
the CPU (plain versions of the tree-fit kernels, one torch thread).

- ``gbm.HistGradientBoostingClassifier`` against sklearn's at the JAX
  package's settings on seeded continuous data with NaN entries: binary
  and 4 classes (small ``max_iter``), 3 classes at the default ``max_iter``
  on a tiny set, and past 10,000 rows with early stopping (numpy's global
  seed set before both fits): equal ``n_iter_``, equal trees (each node's
  feature, bin threshold, missing side, leaf flag and row count) and
  ``predict_proba`` within 1e-10; the binning thresholds and bins (few
  distinct values, many, constant; all-NaN raising) exactly; NaN routing at
  prediction, for a feature with and without missing values in training.
- The weighted OVO / OVR ROC AUC against ``roc_auc_score`` (ties, binary,
  a missing class raising as sklearn raises), and ``cross_validate``
  against sklearn's: NaN for a fold lacking a class, and a fold tested on
  a label it was not trained on, scored with the labels paired by position.
- Against the JAX package on ``tests/test_posthoc_visuals.py``'s fixture
  (120 x 6, 3 classes, 4 experiments; its folds run in one process):
  ``train_supervised_cluster_detectors`` (equal folds, AUCs within 1e-9,
  the full pipeline's ``predict_proba`` within 1e-9), ``SimpleSMOTE``
  (1e-12), ``explain_clusters`` from the same numpy state (Shapley values
  1e-8), ``compute_UMAP``'s LDA stage through the same reducer (1e-10) and
  the single-cluster raise.
- With sklearn blocked, the port's detector pipeline runs end to end.
"""

import os
import subprocess
import sys
import warnings

import numpy as np
import pandas as pd
import pytest
import torch
from joblib import parallel_config
from threadpoolctl import threadpool_limits
from sklearn.ensemble import HistGradientBoostingClassifier as SkHGB
from sklearn.ensemble._hist_gradient_boosting.binning import _BinMapper, _find_binning_thresholds
from sklearn.linear_model import LogisticRegression
from sklearn.metrics import roc_auc_score
from sklearn.model_selection import cross_validate as sk_cross_validate

from deepof_tpu import posthoc as jph
from deepof_tpu.legacy_compat import SimpleSMOTE as JaxSMOTE

from deepof_tpu_torch import gbm
from deepof_tpu_torch import posthoc as pph
from deepof_tpu_torch.legacy_compat import SimpleSMOTE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBA_TOL, AUC_TOL, SHAP_TOL, LDA_TOL, SMOTE_TOL = 1e-10, 1e-9, 1e-8, 1e-10, 1e-12


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's small CPU tensors, and sklearn's OpenMP loops, on one
    thread: beside tier-1's other workers, more threads only spin (sklearn's
    tree fits, which synchronise their threads at every node, ran ~100x
    slower there)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


def _data(n, f, k, nan=0.0, seed=0, noise=1.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    y = (x @ rng.normal(size=(f, k)) + noise * rng.normal(size=(n, k))).argmax(1)
    x[:, 1] = np.round(x[:, 1] * 2)  # few distinct values
    x[rng.random(x.shape) < nan] = np.nan
    return x, y


def _assert_same_trees(sk, pt):
    assert sk.n_iter_ == pt.n_iter_
    a = pt.predictors_
    k = pt.n_trees_per_iteration_
    roots = list(a["roots"]) + [len(a["feature"])]
    for i, per_iteration in enumerate(sk._predictors):
        for c, predictor in enumerate(per_iteration):
            nodes = predictor.nodes
            lo, hi = roots[i * k + c], roots[i * k + c + 1]
            assert hi - lo == len(nodes), (i, c)
            inner = nodes["is_leaf"] == 0
            np.testing.assert_array_equal(a["is_leaf"][lo:hi], nodes["is_leaf"])
            np.testing.assert_array_equal(a["count"][lo:hi], nodes["count"])
            for ours, theirs in (("feature", "feature_idx"), ("bin_threshold", "bin_threshold"),
                                 ("missing_left", "missing_go_to_left")):
                np.testing.assert_array_equal(a[ours][lo:hi][inner], nodes[theirs][inner], err_msg=f"{i} {c} {ours}")


def _fit_both(x, y, seed=None, **kw):
    if seed is not None:
        np.random.seed(seed)
    sk = SkHGB(**kw).fit(x, y)
    if seed is not None:
        np.random.seed(seed)
    pt = gbm.HistGradientBoostingClassifier(device="cpu", **kw).fit(x, y)
    return sk, pt


@pytest.mark.parametrize("case", ["binary", "four_classes", "default_max_iter", "early_stopping"])
def test_gbm_matches_sklearn(case):
    if case == "binary":
        x, y = _data(400, 5, 2, nan=0.1, seed=1)
        sk, pt = _fit_both(x, y, max_iter=15)
    elif case == "four_classes":
        x, y = _data(500, 6, 4, nan=0.1, seed=2)
        sk, pt = _fit_both(x, y, max_iter=10)
    elif case == "default_max_iter":
        x, y = _data(60, 2, 3, nan=0.05, seed=3)
        sk, pt = _fit_both(x, y)
    else:  # labels of pure noise: the validation loss stops improving early
        x, y = _data(10_200, 3, 2, nan=0.02, seed=4, noise=100.0)
        sk, pt = _fit_both(x, y, seed=11, max_iter=40)
        assert sk.do_early_stopping_ and pt.do_early_stopping_ and sk.n_iter_ < 40
        np.testing.assert_allclose(pt.validation_score_, sk.validation_score_, rtol=0, atol=1e-12)
    _assert_same_trees(sk, pt)
    np.testing.assert_array_equal(pt.classes_, sk.classes_)
    np.testing.assert_allclose(pt.predict_proba(x), sk.predict_proba(x), rtol=0, atol=PROBA_TOL)
    np.testing.assert_array_equal(pt.predict(x), sk.predict(x))


def test_binning_matches_sklearn():
    rng = np.random.default_rng(5)
    n = 600
    cols = {
        "few": rng.integers(0, 5, n).astype(float),
        "many": rng.normal(size=n),
        "constant": np.full(n, 2.5),
        "nan_mixed": np.where(rng.random(n) < 0.2, np.nan, rng.normal(size=n)),
    }
    for name, col in cols.items():
        np.testing.assert_array_equal(gbm.find_binning_thresholds(col), _find_binning_thresholds(col, 255),
                                      err_msg=name)
    all_nan = np.full(n, np.nan)  # sklearn cannot bin it, and neither can the port
    with pytest.raises(ValueError):
        _find_binning_thresholds(all_nan, 255)
    with pytest.raises(ValueError, match="no non-missing value"):
        gbm.find_binning_thresholds(all_nan)
    x = np.stack(list(cols.values()), 1)
    mapper = _BinMapper(n_bins=256).fit(x)
    ours = gbm.BinMapper().fit(x)
    np.testing.assert_array_equal(ours.n_bins_non_missing_, mapper.n_bins_non_missing_)
    np.testing.assert_array_equal(ours.transform(x).T, mapper.transform(x))


def test_predictor_nan_routing():
    """A feature with NaNs in training (the split's learned side) and one
    without (NaN to the child with more rows) at prediction time."""
    x, y = _data(600, 3, 3, seed=6)
    x[np.random.default_rng(6).random(600) < 0.15, 0] = np.nan
    sk, pt = _fit_both(x, y, max_iter=8)
    _assert_same_trees(sk, pt)
    probe = x[:200].copy()
    probe[::2, 0] = np.nan
    probe[1::3, 2] = np.nan
    probe[::5, 1] = np.nan
    np.testing.assert_allclose(pt.predict_proba(probe), sk.predict_proba(probe), rtol=0, atol=PROBA_TOL)
    assert pt.predictors_["missing_left"].any()


def test_roc_auc_matches_sklearn():
    rng = np.random.default_rng(7)
    for trial in range(24):
        k, n = int(rng.integers(2, 6)), int(rng.integers(6, 50))
        y = rng.integers(0, k, n)
        p = np.round(rng.random((n, k)), 1) + 1e-3  # ties
        p /= p.sum(1, keepdims=True)
        score = p[:, 1] if k == 2 else p
        for mc in ("ovo", "ovr"):
            try:
                want = roc_auc_score(y, score, multi_class=mc, average="weighted")
            except ValueError:  # a class of the scores missing from y
                with pytest.raises(ValueError):
                    pph.roc_auc_weighted(y, score, mc)
                continue
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                got = pph.roc_auc_weighted(y, score, mc)
            assert (np.isnan(want) and np.isnan(got)) or got == want, (trial, mc, got, want)


def test_cross_validate_nan_for_a_fold_missing_a_class():
    x, y = _data(90, 4, 3, seed=8)
    y[:30] = np.where(y[:30] == 2, 0, y[:30])  # the first fold's test rows lack class 2
    folds = [(np.arange(30, 90), np.arange(30)), (np.concatenate([np.arange(30), np.arange(60, 90)]),
                                                    np.arange(30, 60))]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = sk_cross_validate(LogisticRegression(), x, y, cv=folds, return_train_score=True,
                                 scoring=["roc_auc_ovo_weighted", "roc_auc_ovr_weighted"])
        got = pph.cross_validate(LogisticRegression(), x, y, cv=folds)
    for key in want:
        if key.startswith(("test_", "train_")):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert np.isnan(got["test_roc_auc_ovo_weighted"][0]) and np.isfinite(got["test_roc_auc_ovo_weighted"][1])


def test_cross_validate_pairs_labels_by_position_like_sklearn():
    """A fold trained on labels {0, 1, 2} and tested on {0, 1, 3}: as many
    test labels as classifier columns, so sklearn's scorer pairs them by
    position and scores the fold; the port's scores equal sklearn's (the
    other fold's test rows lack a trained label: NaN on both)."""
    rng = np.random.default_rng(10)
    x = rng.normal(size=(120, 4))
    y = np.concatenate([rng.choice([0, 1, 3], 40), rng.choice([0, 1, 2], 80)])
    x[:, 0] += y
    folds = [(np.arange(40, 120), np.arange(40)), (np.arange(80), np.arange(80, 120))]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = sk_cross_validate(LogisticRegression(), x, y, cv=folds, return_train_score=True,
                                 scoring=["roc_auc_ovo_weighted", "roc_auc_ovr_weighted"])
        got = pph.cross_validate(LogisticRegression(), x, y, cv=folds)
    for key in want:
        if key.startswith(("test_", "train_")):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert np.isfinite(got["test_roc_auc_ovo_weighted"][0]) and np.isfinite(got["test_roc_auc_ovr_weighted"][0])


# --------------------------------------------------------------------------- #
# Against the JAX package
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def fixture_data():
    rng = np.random.default_rng(0)
    x = pd.DataFrame(rng.normal(size=(120, 6)))
    y = pd.Series(rng.integers(0, 3, 120))
    x.iloc[:, 0] += 3.0 * y
    bin_info = {f"exp{i}": np.arange(30) + 30 * i for i in range(4)}
    return x, y, bin_info


@pytest.fixture(scope="module")
def detectors(fixture_data):
    """Both packages' train_supervised_cluster_detectors (the JAX package's
    folds in this process, as the port fits them: numpy's global state is
    then drawn in fold order on both sides)."""
    x, y, bin_info = fixture_data
    with warnings.catch_warnings(), parallel_config(backend="sequential"), threadpool_limits(limits=1):
        warnings.simplefilter("ignore")
        jax_out = jph.train_supervised_cluster_detectors(x, y, bin_info, verbose=0)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        port_out = pph.train_supervised_cluster_detectors(pph.Labelled(x.values, list(x.index), list(x.columns)),
                                                          y.values, bin_info, verbose=0, device="cpu")
        torch.set_num_threads(threads)
    return jax_out, port_out


def test_train_supervised_cluster_detectors_matches_jax(fixture_data, detectors):
    x, y, _ = fixture_data
    (j_full, j_perf, j_groups), (p_full, p_perf, p_groups) = detectors
    assert len(p_groups) == len(j_groups) == 4
    for (jt, je), (pt, pe) in zip(j_groups, p_groups):
        np.testing.assert_array_equal(pt, jt)
        np.testing.assert_array_equal(pe, je)
    assert list(p_perf) == list(j_perf)
    for key in j_perf:
        if key.startswith(("test_", "train_")):
            np.testing.assert_allclose(p_perf[key], j_perf[key], rtol=0, atol=AUC_TOL, err_msg=key)
    assert len(p_perf["estimator"]) == 4
    for j_est, p_est in zip(j_perf["estimator"], p_perf["estimator"]):
        np.testing.assert_array_equal(p_est.predict(x.values), j_est.predict(x.values))
    np.testing.assert_allclose(p_full.predict_proba(x.values), j_full.predict_proba(x.values), rtol=0, atol=AUC_TOL)
    assert p_full.named_steps["classifier"].resampler_ is not None


def test_smote_matches_jax(fixture_data):
    x, y, _ = fixture_data
    xs = np.array(x.values, float)
    xs[5, 2] = xs[9, 2]  # a shared coordinate
    jx, jy = JaxSMOTE(random_state=42).fit_resample(xs, y.values)
    px, py = SimpleSMOTE(random_state=42, device="cpu").fit_resample(xs, y.values)
    np.testing.assert_array_equal(py, jy)
    np.testing.assert_allclose(px, jx, rtol=0, atol=SMOTE_TOL)
    tx, _ = SimpleSMOTE(random_state=42, device="cpu").fit_resample(torch.as_tensor(xs), y.values)
    assert isinstance(tx, torch.Tensor) and torch.equal(tx, torch.as_tensor(px))


def test_explain_clusters_matches_jax(fixture_data, detectors):
    x, y, _ = fixture_data
    (j_full, _, _), (p_full, _, _) = detectors
    np.random.seed(3)
    j_shap, j_explainer, j_rows = jph.explain_clusters(x, y.values, j_full, samples=12)
    np.random.seed(3)
    p_shap, p_explainer, p_rows = pph.explain_clusters(pph.Labelled(x.values, list(x.index), list(x.columns)),
                                                       y.values, p_full, samples=12, device="cpu")
    assert list(p_rows.index) == list(j_rows.index)
    np.testing.assert_allclose(p_rows.values, j_rows.values, rtol=0, atol=SHAP_TOL)
    np.testing.assert_allclose(np.asarray(p_explainer.expected_value), np.asarray(j_explainer.expected_value),
                               rtol=0, atol=SHAP_TOL)
    assert len(p_shap) == len(j_shap) == 3
    for got, want in zip(p_shap, j_shap):
        np.testing.assert_allclose(got, want, rtol=0, atol=SHAP_TOL)


class _Reducer:
    def fit_transform(self, z):
        return np.asarray(z)[:, :2] * 2.0 - 1.0


def test_compute_umap_lda_matches_jax():
    rng = np.random.default_rng(9)
    emb = rng.normal(size=(90, 5)) + np.repeat(np.eye(5)[:3] * 2.0, 30, axis=0)
    labels = np.repeat(np.arange(4), [30, 20, 25, 15])
    np.testing.assert_allclose(pph.compute_UMAP(emb, labels, reducer=_Reducer(), device="cpu"),
                               jph.compute_UMAP(emb, labels, reducer=_Reducer()), rtol=0, atol=LDA_TOL)
    with pytest.raises(AssertionError):
        jph.compute_UMAP(emb, np.zeros(90), reducer=_Reducer())
    with pytest.raises(ValueError, match="single cluster"):
        pph.compute_UMAP(emb, np.zeros(90), reducer=_Reducer(), device="cpu")


def test_detectors_run_without_sklearn():
    """The port's pipeline in a fresh interpreter where sklearn cannot be
    imported: detectors, Shapley values, the LDA projection; the pickle
    shims raise an ImportError naming sklearn."""
    code = (
        "import sys\n"
        "sys.modules['sklearn'] = None\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "from deepof_tpu_torch import posthoc as ph\n"
        "from deepof_tpu_torch.legacy_compat import load_pickle_compat\n"
        "rng = np.random.default_rng(0)\n"
        "x = rng.normal(size=(40, 3)); y = rng.integers(0, 2, 40); x[:, 0] += 2 * y\n"
        "info = {'a': np.arange(20), 'b': np.arange(20)}\n"
        "clf, perf, folds = ph.train_supervised_cluster_detectors(x, y, info, verbose=0, device='cpu')\n"
        "shap, ex, rows = ph.explain_clusters(x, y, clf, samples=5, device='cpu')\n"
        "proj = ph.compute_UMAP(x, y, reducer=type('R', (), {'fit_transform': lambda s, z: z})(), device='cpu')\n"
        "assert len(folds) == 2 and len(shap) == 2 and proj.shape == (40, 1)\n"
        "try:\n"
        "    load_pickle_compat('missing.pkl')\n"
        "except ImportError as e:\n"
        "    assert 'sklearn' in str(e)\n"
        "else:\n"
        "    raise SystemExit('the pickle shims ran without sklearn')\n"
        "print('ok', sorted(m for m in sys.modules if m.startswith('sklearn') and sys.modules[m] is not None))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.split("\n")[-2] == "ok []"
