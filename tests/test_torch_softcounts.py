"""The port's soft-count extraction against the JAX package's, on the CPU:
the HMM recursion's plain version and the forward-backward built on it,
the Gaussian HMM (EM, state selection, the prior-biased decode), the
sklearn estimators restated in torch against sklearn itself, the MSM +
PCCA+ pipeline (on analytic fixtures and seeded data), the sticky-HMM
extractor, the gates on a two-animal csv project, the gated GMM and MSM
decoders with the chaos gates, ``embedding_per_video`` with each
extraction method, and ``recluster``.

Inputs are made from a seed with numpy and given to both packages (JAX on
the CPU, sklearn as installed). Bars, each set above what this suite's
inputs showed (seen values beside them where they are not exact):

- forward-backward (float32 both): log-likelihoods 1e-6 relative, gamma
  5e-5 absolute. |log alpha| grows to ~1,600 over 257 frames of these
  emissions, where one float32 ulp is 1.2e-4: the two packages' sums of
  other orders leave ~2e-5 on gamma there (seen 1.9e-5) and nothing
  measurable at T <= 2. xi sums within 5e-5 of max(1, max |xi|) of a
  float64 forward-backward (seen 1.1e-5), and within 1e-3 of the JAX
  package's: the port normalises each frame's xi (ops/hmm_kernels.py
  ``forward_backward``), the JAX package sums them as they come, each off
  by the forward and backward recursions' rounding apart (seen 5.4e-4 at
  T = 257);
- HMM EM after a few iterations: parameters and log-likelihoods 1e-4
  relative (float32 einsums of other orders, carried through EM);
- posteriors and soft counts 1e-4 absolute (the same float32 noise on
  probabilities), hard labels equal; ``embedding_per_video``'s "hmm" 3e-3
  (50 EM iterations amplify the encoders' 1e-6; seen 3.1e-4), hard labels
  equal on at least 99% of windows;
- the restated estimators: equal labels, iteration and step counts, centres
  and means 1e-4 of the data's scale, GMM weights 1e-5, covariances 1e-4
  of max |x|^2 (sklearn's diagonal M-step subtracts squares in float32),
  responsibilities 1e-4;
- gating series 1e-7 relative (float32 results of float64 sums), gates,
  masks, runs, samples and transition counts exactly; PCCA+ 1e-10 (numpy
  float64 on both sides).

The JAX package's HMM forward-backward and log-densities run compiled
whole (``compiled_reference_hmm``); its forward-backward programs of the
nine test shapes compile together in threads, and its side of the HMM
tests runs in threads at once (``jax_hmm_results``); each package's
``embedding_per_video`` with each extraction method runs once a module
(``served``), and the tests that read it share its outputs. The port runs
on one torch thread (``one_torch_thread``): beside tier-1's other
workers, eight threads made its serving calls ~100 times slower.
"""

import os
import pickle
import warnings
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp
from sklearn.cluster import KMeans as SkKMeans
from sklearn.cluster import MiniBatchKMeans as SkMiniBatch
from sklearn.mixture import GaussianMixture as SkGMM

from deepof_tpu import gating as jgating
from deepof_tpu import msm as jmsm
from deepof_tpu import posthoc as jph
from deepof_tpu.core.table_dict import TableDict as JaxTableDict
from deepof_tpu.data import Project as JaxProject
from deepof_tpu.train.inference import embedding_per_video as jax_embed

from deepof_tpu_torch import cluster, gating, msm
from deepof_tpu_torch import posthoc as pph
from deepof_tpu_torch.core.storage import LazyFrame, get_dt
from deepof_tpu_torch.core.table_dict import TableDict
from deepof_tpu_torch.data import Project
from deepof_tpu_torch.ops.hmm_kernels import forward_backward, hmm_scan, hmm_scan_plain
from deepof_tpu_torch.train import gmm
from deepof_tpu_torch.train.inference import embedding_per_video

from test_torch_cohort import _vade_bundles
from test_torch_encoders import one_torch_thread  # noqa: F401 (an autouse fixture of this module too)
from test_torch_public import _project_args, write_project

@pytest.fixture(scope="module", autouse=True)
def compiled_reference_hmm():
    """The JAX package's forward-backward and Gaussian log-densities, each
    compiled whole. Its decode and log-likelihood paths call them outside
    jit, where JAX compiles each of their ~40 operations on its own for
    every new shape (9 of the 11.5 s of one ``fit_hmm_range`` here); the
    same functions, the same arithmetic, as one program."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jmsm, "_forward_backward", jax.jit(jmsm._forward_backward))
    mp.setattr(jmsm, "_log_gaussian", jax.jit(jmsm._log_gaussian))
    yield
    mp.undo()


KEYS = ("test", "test2")
LENGTHS = (300, 260)
WINDOW = 8
GAMMA_TOL, XI_RTOL, XI_JAX_RTOL, LL_RTOL = 5e-5, 5e-5, 1e-3, 1e-6
EM_RTOL, PROB_TOL = 1e-4, 1e-4
# "hmm" through embedding_per_video: 50 EM iterations from embeddings that
# differ by ~1e-6 (the two packages' float32 encoders) on random weights,
# whose states overlap; seen 3.1e-4 on the posteriors.
HMM_E2E_TOL = 3e-3


def _close(got, want, rtol=0.0, atol=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _rel(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max(initial=0.0) <= tol * max(1.0, np.abs(want).max(initial=0.0))


def _hmm_inputs(rng, n, t, k):
    log_b = (rng.normal(size=(n, t, k)) * 3 - 5).astype(np.float32)
    a = rng.random((k, k)) + np.eye(k) * k
    pi = rng.random(k)
    return log_b, np.log(pi / pi.sum()).astype(np.float32), np.log(a / a.sum(1, keepdims=True)).astype(np.float32)


def _exact_xi(log_b, log_pi, log_a):
    """The summed transition posteriors of each sequence, in float64."""
    b, p, a = (v.astype(np.float64) for v in (log_b, log_pi, log_a))
    n, t, k = b.shape
    alpha, beta = np.empty_like(b), np.zeros_like(b)
    alpha[:, 0] = p + b[:, 0]
    for s in range(1, t):
        alpha[:, s] = b[:, s] + np.logaddexp.reduce(alpha[:, s - 1, :, None] + a, axis=1)
    for s in range(t - 2, -1, -1):
        beta[:, s] = np.logaddexp.reduce(a + (b[:, s + 1] + beta[:, s + 1])[:, None, :], axis=2)
    ll = np.logaddexp.reduce(alpha[:, -1], axis=1)
    log_xi = alpha[:, :-1, :, None] + a + (b[:, 1:] + beta[:, 1:])[:, :, None, :] - ll[:, None, None, None]
    return np.exp(log_xi).sum(1)


def _sticky_sequences(seed, n, t, d=4, k=3, scale=3.0):
    """(n, t, d) float32 observations of a sticky k-state chain."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(scale=scale, size=(k, d))
    out = []
    for _ in range(n):
        s = np.empty(t, int)
        s[0] = rng.integers(k)
        for i in range(1, t):
            s[i] = s[i - 1] if rng.random() < 0.95 else rng.integers(k)
        out.append(centres[s] + rng.normal(size=(t, d)))
    return np.stack(out).astype(np.float32)


# --------------------------------------------------------------------------- #
# The HMM recursion and the forward-backward
# --------------------------------------------------------------------------- #


FB_SHAPES = [(k, t) for t in (1, 2, 257) for k in (2, 10, 25)]


@pytest.fixture(scope="module")
def jax_forward_backward():
    """The JAX package's forward-backward vmapped over 3 sequences, as its
    EM runs it, at each FB_SHAPES (K, T): every program traced in turn,
    then all compiled at once in threads (XLA compiles without the
    interpreter lock). -> {(k, t): (inputs, (gamma, xi_sum, ll))}."""
    fb = jax.vmap(jmsm._forward_backward, in_axes=(0, None, None))
    inputs = {(k, t): _hmm_inputs(np.random.default_rng(k * 1000 + t), 3, t, k) for k, t in FB_SHAPES}
    lowered = {s: jax.jit(fb).lower(*(jnp.asarray(v) for v in args)) for s, args in inputs.items()}
    with ThreadPoolExecutor(len(lowered)) as pool:
        compiled = dict(zip(lowered, pool.map(lambda low: low.compile(), lowered.values())))
    return {s: (args, compiled[s](*(jnp.asarray(v) for v in args))) for s, args in inputs.items()}


@pytest.mark.parametrize("k", [2, 10, 25])
@pytest.mark.parametrize("t", [1, 2, 257])
def test_forward_backward_matches_jax(jax_forward_backward, k, t):
    """gamma, xi_sum and the log-likelihood of 3 sequences from
    hmm_scan_plain (through hmm_scan on CPU tensors) against the JAX
    package's _forward_backward, sequence by sequence."""
    (log_b, log_pi, log_a), (jg, jx, jl) = jax_forward_backward[k, t]
    launches = hmm_scan.launches
    gamma, xi, ll = forward_backward(torch.as_tensor(log_b), torch.as_tensor(log_pi), torch.as_tensor(log_a))
    assert hmm_scan.launches == launches  # a CPU tensor never counts a launch
    xi64 = _exact_xi(log_b, log_pi, log_a)
    for i in range(3):
        _close(gamma[i], jg[i], atol=GAMMA_TOL)
        _rel(xi[i], jx[i], XI_JAX_RTOL)
        _rel(xi[i], xi64[i], XI_RTOL)
        _close(ll[i], jl[i], rtol=LL_RTOL)
    assert gamma.dtype == torch.float32 and xi.shape == (3, k, k)
    _close(gamma.sum(-1), np.ones((3, t)), atol=1e-6)


def test_long_float32_sequence_stays_finite():
    """27,000 frames of a sticky 3-state chain with well-separated emissions:
    each float32 log-sum-exp step of the forward recursion rounds its small
    log(sum) away in the same direction, so the forward and the backward
    recursions part by ~135 nats and the JAX package's exp(log_alpha +
    log_beta - ll) overflows (NaN posteriors). The port's frame-wise
    normalisation stays within 5e-3 of a float64 forward-backward on gamma
    (seen 9.1e-4, equal argmax), 1e-4 on xi (seen 1.4e-6); the float32
    log-likelihood itself is 2.2e-4 off (its forward's rounding)."""
    rng = np.random.default_rng(0)
    k, t = 3, 27_000
    states = np.repeat(rng.integers(0, k, t // 50 + 1), 50)[:t]
    log_b = np.full((1, t, k), -25.0) + rng.normal(scale=0.3, size=(1, t, k))
    log_b[0, np.arange(t), states] = -20.0
    log_b = log_b.astype(np.float32)
    a = np.full((k, k), 0.01) + np.eye(k)
    log_pi = np.log(np.ones(k) / k).astype(np.float32)
    log_a = np.log(a / a.sum(1, keepdims=True)).astype(np.float32)
    gamma, xi, ll = forward_backward(*(torch.as_tensor(v) for v in (log_b, log_pi, log_a)))
    jg = jax.jit(jmsm._forward_backward)(jnp.asarray(log_b[0]), jnp.asarray(log_pi), jnp.asarray(log_a))[0]
    assert not np.isfinite(np.asarray(jg)).all()
    b, p, aa = log_b[0].astype(np.float64), log_pi.astype(np.float64), log_a.astype(np.float64)
    alpha, beta = np.empty_like(b), np.zeros_like(b)
    alpha[0] = p + b[0]
    for s in range(1, t):
        alpha[s] = b[s] + np.logaddexp.reduce(alpha[s - 1][:, None] + aa, axis=0)
    for s in range(t - 2, -1, -1):
        beta[s] = np.logaddexp.reduce(aa + (b[s + 1] + beta[s + 1])[None], axis=1)
    ll64 = np.logaddexp.reduce(alpha[-1])
    g64 = np.exp(alpha + beta - ll64)
    xi64 = np.exp(alpha[:-1, :, None] + aa + (b[1:] + beta[1:])[:, None, :] - ll64).sum(0)
    assert torch.isfinite(gamma).all() and torch.isfinite(xi).all()
    _close(gamma[0], g64, atol=5e-3)
    assert (gamma[0].numpy().argmax(1) == g64.argmax(1)).all()
    _rel(xi[0], xi64, 1e-4)
    _close(ll[0], ll64, rtol=1e-3)


def test_hmm_scan_recursions_and_what_raises():
    """hmm_scan on CPU tensors is hmm_scan_plain; its two recursions
    against a float64 loop written from their definitions; bad shapes,
    devices and dtypes raise."""
    log_b, log_pi, log_a = _hmm_inputs(np.random.default_rng(0), 2, 40, 6)
    alpha, beta = hmm_scan(*(torch.as_tensor(v) for v in (log_b, log_pi, log_a)))
    b64, p64, a64 = log_b.astype(np.float64), log_pi.astype(np.float64), log_a.astype(np.float64)
    want_a, want_b = np.empty_like(b64), np.zeros_like(b64)
    want_a[:, 0] = p64 + b64[:, 0]
    for s in range(1, 40):
        want_a[:, s] = b64[:, s] + np.logaddexp.reduce(want_a[:, s - 1, :, None] + a64, axis=1)
    for s in range(38, -1, -1):
        want_b[:, s] = np.logaddexp.reduce(a64 + (b64[:, s + 1] + want_b[:, s + 1])[:, None, :], axis=2)
    _rel(alpha, want_a, 1e-6)
    _rel(beta, want_b, 1e-6)
    pa, pb = hmm_scan_plain(*(torch.as_tensor(v) for v in (log_b, log_pi, log_a)))
    assert torch.equal(pa, alpha) and torch.equal(pb, beta)
    with pytest.raises(ValueError, match="must be"):
        hmm_scan(torch.zeros(2, 3), torch.zeros(3), torch.zeros(3, 3))
    with pytest.raises(ValueError, match="log_pi must be"):
        hmm_scan(torch.zeros(1, 2, 3), torch.zeros(2), torch.zeros(3, 3))
    with pytest.raises(ValueError, match="one dtype"):
        hmm_scan(torch.zeros(1, 2, 3), torch.zeros(3, dtype=torch.float64), torch.zeros(3, 3))


# --------------------------------------------------------------------------- #
# Gaussian HMM
# --------------------------------------------------------------------------- #


def _range_embeddings():
    x = _sticky_sequences(2, 2, 80)
    return {"a": x[0], "b": x[1][:70]}


def _prior_embeddings():
    """Two sequences and their priors, one shorter and one longer than its
    sequence."""
    x = _sticky_sequences(3, 2, 90)
    rng = np.random.default_rng(4)
    priors = {"a": rng.dirichlet(np.ones(3) * 0.3, size=80), "b": rng.dirichlet(np.ones(3) * 0.3, size=90)}
    return {"a": x[0], "b": x[1][:75]}, priors


PRIOR_KWARGS = ({"n_states": 3}, {"min_confidence": 0.6, "prior_weight": 0.5}, {"min_confidence": None})
CONTRASTIVE_CASES = ("int", "bic", "aic", "priors")


def _contrastive_kwargs(case):
    if case == "priors":
        rng = np.random.default_rng(8)
        return {"soft_counts": {"a": rng.dirichlet(np.ones(3) * 0.3, size=300)}, "min_confidence": 0.5}
    return {"int": {"states": 3}, "bic": {"states": "bic", "max_states": 3},
            "aic": {"states": "aic", "max_states": 3}}[case]


@pytest.fixture(scope="module")
def jax_hmm_results():
    """The JAX package's side of the HMM tests, run in threads at once (XLA
    compiles and runs without the interpreter lock): the 6-iteration fit of
    ``hmm_pair`` with its log-likelihood and decodes, ``fit_hmm_range`` by
    each criterion, ``get_soft_counts_hmm`` with each PRIOR_KWARGS and
    ``get_contrastive_soft_counts`` in each case. -> {name: result}."""
    x = _sticky_sequences(0, 3, 120)
    bias = np.log(np.random.default_rng(1).dirichlet(np.ones(3), size=120))

    def pair():
        jm = jmsm.GaussianHMM(3, n_iter=6).fit(x)
        return jm, jm.log_probability(x), [jm.predict_proba(x[1], log_bias=b) for b in (None, bias)]

    embs, priors = _prior_embeddings()
    tasks = {"pair": pair}
    for crit in ("aic", "bic"):
        tasks["range", crit] = lambda crit=crit: jmsm.fit_hmm_range(_range_embeddings(), crit, 2, 3)
    for i, kw in enumerate(PRIOR_KWARGS):
        kw = kw if i == 0 else {"soft_counts": priors, **kw}
        tasks["soft_counts", i] = lambda kw=kw: jmsm.get_soft_counts_hmm(embs, **kw)
    for case in CONTRASTIVE_CASES:
        tasks["contrastive", case] = lambda case=case: jmsm.get_contrastive_soft_counts(
            None, _contrastive_embeddings(), **_contrastive_kwargs(case))
    with ThreadPoolExecutor(len(tasks)) as pool:
        futures = {name: pool.submit(fn) for name, fn in tasks.items()}
        return {name: f.result() for name, f in futures.items()}


@pytest.fixture(scope="module")
def hmm_pair(jax_hmm_results):
    x = _sticky_sequences(0, 3, 120)
    return x, jax_hmm_results["pair"], msm.GaussianHMM(3, n_iter=6, device="cpu").fit(x)


def test_gaussian_hmm_fit_matches_jax(hmm_pair):
    """Six EM iterations from the same numpy init draw: every parameter and
    the log-likelihood trace; log_probability; the decode with and without
    a log bias; n_params."""
    x, (jm, j_ll, j_decodes), pm = hmm_pair
    for got, want in zip(pm.params, jm.params):
        assert got.dtype == np.float32
        _close(got, want, rtol=EM_RTOL, atol=EM_RTOL)
    _close(pm.log_likelihoods_, jm.log_likelihoods_, rtol=EM_RTOL)
    _close(pm.log_probability(x), j_ll, rtol=EM_RTOL)
    bias = np.log(np.random.default_rng(1).dirichlet(np.ones(3), size=120))
    for b, want in zip((None, bias), j_decodes):
        got = pm.predict_proba(x[1], log_bias=b)
        _close(got, want, atol=PROB_TOL)
        assert (got.argmax(1) == want.argmax(1)).all()
    assert pm.n_params(4) == jm.n_params(4) == 3 * 8 + 6


@pytest.mark.parametrize("crit", ["aic", "bic"])
def test_fit_hmm_range_matches_jax(jax_hmm_results, crit):
    """State selection over 2..3 states (30 EM iterations each): the same
    chosen count and scores."""
    jbest, jscores = jax_hmm_results["range", crit]
    pbest, pscores = msm.fit_hmm_range(_range_embeddings(), crit, 2, 3, device="cpu")
    assert pbest.n_states == jbest.n_states
    _close(pscores, jscores, rtol=EM_RTOL)


def test_get_soft_counts_hmm_matches_jax(jax_hmm_results):
    """n_states, then priors (one shorter and one longer than its sequence,
    padded and truncated, with min_confidence gating and a prior weight);
    the raises."""
    embs, priors = _prior_embeddings()
    for i, kw in enumerate(PRIOR_KWARGS):
        kw = kw if i == 0 else {"soft_counts": priors, **kw}
        want = jax_hmm_results["soft_counts", i]
        got = msm.get_soft_counts_hmm(embs, device="cpu", **kw)
        assert list(got) == list(want)
        for key in want:
            _close(got[key], want[key], atol=PROB_TOL)
    for kw, err in (({"n_states": 4, "soft_counts": priors}, "must match"),
                    ({"soft_counts": {"zz": priors["a"]}}, "no keys overlap")):
        with pytest.raises(ValueError, match=err):
            msm.get_soft_counts_hmm(embs, device="cpu", **kw)
    for bad, err in ((np.ones(5), "must be"), (np.ones((5, 4)), "K mismatch")):
        with pytest.raises(ValueError, match=err):
            msm._align_prior(bad, 5, 3, 0.5)
    _close(msm._align_prior(priors["a"], 85, 3, 0.7), jmsm._align_prior(priors["a"], 85, 3, 0.7), atol=0.0)


def test_gaussian_hmm_pickles_as_numpy(hmm_pair, tmp_path):
    """The port's pickle round trip (numpy parameters, equal decode); a
    pickle whose parameters are not numpy arrays raises."""
    x, _, pm = hmm_pair
    path = tmp_path / "hmm.pkl"
    path.write_bytes(pickle.dumps([pm]))
    back = pickle.loads(path.read_bytes())[0]
    assert all(isinstance(p, np.ndarray) for p in back.params)
    np.testing.assert_array_equal(back.predict_proba(x[0]), pm.predict_proba(x[0]))
    state = dict(pm.__dict__, params=tuple(torch.as_tensor(p) for p in pm.params))
    clone = msm.GaussianHMM.__new__(msm.GaussianHMM)
    with pytest.raises(TypeError, match="not numpy arrays"):
        clone.__setstate__(state)


# --------------------------------------------------------------------------- #
# sklearn restated
# --------------------------------------------------------------------------- #


def _blobs(seed, n, k, d, spread=1.0):
    rng = np.random.default_rng(seed)
    centres = rng.normal(scale=5.0, size=(k, d))
    return (centres[rng.integers(0, k, n)] + rng.normal(scale=spread, size=(n, d))).astype(np.float32)


BLOBS = [(0, 500, 4, 3), (1, 3000, 8, 8), (2, 1200, 5, 2)]


@pytest.mark.parametrize("seed,n,k,d", BLOBS)
def test_kmeans_matches_sklearn(seed, n, k, d):
    x = _blobs(seed, n, k, d, spread=2.0)
    want = SkKMeans(k, n_init=1, random_state=seed).fit(x)
    got = cluster.KMeans(k, random_state=seed, device="cpu").fit(x)
    np.testing.assert_array_equal(got.labels_.numpy(), want.labels_)
    assert got.n_iter_ == want.n_iter_
    _close(got.cluster_centers_, want.cluster_centers_, atol=1e-4 * np.abs(x).max())
    _close(got.inertia_, want.inertia_, rtol=1e-5)
    np.testing.assert_array_equal(got.predict(x[:50]).numpy(), want.predict(x[:50]))


@pytest.mark.parametrize("covariance_type", ["full", "diag"])
@pytest.mark.parametrize("seed,n,k,d", BLOBS)
def test_gaussian_mixture_matches_sklearn(covariance_type, seed, n, k, d):
    x = _blobs(seed, n, k, d, spread=1.5)
    kw = dict(covariance_type=covariance_type, reg_covar=1e-5, random_state=seed, max_iter=200, tol=1e-3)
    want = SkGMM(k, **kw).fit(x)
    got = cluster.GaussianMixture(k, device="cpu", **kw).fit(x)
    assert got.n_iter_ == want.n_iter_ and got.converged_ == want.converged_
    _close(got.weights_, want.weights_, atol=1e-5)
    _close(got.means_, want.means_, atol=1e-4 * np.abs(x).max())
    _close(got.covariances_, want.covariances_, atol=1e-4 * (x ** 2).max())
    _close(got.predict_proba(x), want.predict_proba(x), atol=PROB_TOL)
    np.testing.assert_array_equal(got.predict(x).numpy(), want.predict(x))


def test_gaussian_mixture_raises_as_sklearn():
    """An ill-defined covariance (a collapsed component) and an unknown
    covariance type raise; the tied and spherical covariances of the same
    collapsed components keep sklearn's 10 * eps floor (no raise in either
    package)."""
    x = np.repeat(np.eye(3, dtype=np.float32), 10, axis=0)
    for ct in ("full", "diag"):
        with pytest.raises(ValueError, match="ill-defined"):
            SkGMM(3, covariance_type=ct, reg_covar=0.0, random_state=0).fit(x)
        with pytest.raises(ValueError, match="ill-defined"):
            cluster.GaussianMixture(3, covariance_type=ct, reg_covar=0.0, random_state=0, device="cpu").fit(x)
    for ct in ("tied", "spherical"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = SkGMM(3, covariance_type=ct, reg_covar=0.0, random_state=0).fit(x)
            got = cluster.GaussianMixture(3, covariance_type=ct, reg_covar=0.0, random_state=0, device="cpu").fit(x)
        _close(got.covariances_, want.covariances_, atol=1e-12)
    with pytest.raises(ValueError, match="covariance_type"):
        cluster.GaussianMixture(2, covariance_type="banded")


@pytest.mark.parametrize("seed,n,k,d,clusters", [(0, 500, 4, 3, 5), (1, 3000, 8, 8, 5), (1, 3000, 8, 8, 50),
                                                 (2, 5000, 3, 2, 40)])
def test_minibatch_kmeans_matches_sklearn(seed, n, k, d, clusters):
    """More rows than a batch (1024), three inits, the early stop; the
    cases of many centres over few blobs reassign light centres."""
    x = _blobs(seed, n, k, d)
    want = SkMiniBatch(clusters, random_state=seed, n_init=3).fit(x)
    got = cluster.MiniBatchKMeans(clusters, random_state=seed, n_init=3, device="cpu").fit(x)
    assert got.n_steps_ == want.n_steps_ and got.n_iter_ == want.n_iter_
    _close(got.cluster_centers_, want.cluster_centers_, atol=1e-4 * np.abs(x).max())
    np.testing.assert_array_equal(got.labels_.numpy(), want.labels_)
    np.testing.assert_array_equal(got.predict(x).numpy(), want.predict(x))
    _close(got.inertia_, want.inertia_, rtol=1e-4)


def test_minibatch_reassigns_light_centres():
    """A case where sklearn's random reassignment fires (two tight blobs and
    60 scattered points, which k-means++ favours as centres and minibatches
    rarely visit): the same draws, the same centres."""
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.normal(size=(2000, 2)) * 0.3, rng.normal(size=(2000, 2)) * 0.3 + 5,
                        rng.uniform(-40, 40, size=(60, 2))]).astype(np.float32)
    rng.shuffle(x)
    got = cluster.MiniBatchKMeans(30, random_state=7, n_init=3, device="cpu").fit(x)
    want = SkMiniBatch(30, random_state=7, n_init=3).fit(x)
    assert got.reassigned_ > 0 and got.n_steps_ == want.n_steps_
    _close(got.cluster_centers_, want.cluster_centers_, atol=1e-4)
    np.testing.assert_array_equal(got.labels_.numpy(), want.labels_)


@pytest.mark.parametrize("rows,k,dtype", [(1024, 200, np.float32), (30_000, 10, np.float32), (500, 7, np.float64)])
def test_cluster_sums_add_rows_in_order(rows, k, dtype):
    """Each cluster's sum adds its rows in row order, as numpy's ``add.at``
    does, at any intra-op thread count: what the k-means fits' steps rely
    on to repeat bit for bit (chip_smoke.py holds the card to the same)."""
    rng = np.random.default_rng(rows + k)
    x = (rng.normal(size=(rows, 8)) * 10).astype(dtype)
    labels = rng.integers(0, k, rows)
    want = np.zeros((k, 8), dtype)
    np.add.at(want, labels, x)
    threads = torch.get_num_threads()
    try:
        for n in (1, 8):
            torch.set_num_threads(n)
            got = gmm.cluster_sums(torch.as_tensor(x), torch.as_tensor(labels), k)
            np.testing.assert_array_equal(got.numpy(), want)
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("rows,k,d", [(3_528, 200, 8), (700, 10, 3)])
def test_kmeans_distances_sum_feature_by_feature(rows, k, d, monkeypatch):
    """The labels' ``|c|^2 - 2 x.c`` and the inertia's squared distances are
    float32 products and sums taken feature by feature, in order, in
    elementwise operations, which round alike on every device, chunked or
    not: numpy's float32 scalars of the same sequence give the same bits. (A
    matrix product sums in its library's order: on the MSM decoder's 200
    microstates the card and the CPU then split near-ties, and their
    macrostates parted on some fits.)"""
    rng = np.random.default_rng(rows)
    x = rng.normal(size=(rows, d)).astype(np.float32)
    c = rng.normal(size=(k, d)).astype(np.float32)
    cn = c[:, 0] * c[:, 0]
    xc = x[:, :1] * c[:, 0][None]
    for j in range(1, d):
        cn = cn + c[:, j] * c[:, j]
        xc = xc + x[:, j:j + 1] * c[:, j][None]
    want = (cn[None] - np.float32(2) * xc).argmin(1)
    monkeypatch.setattr(cluster, "_ROWS", 256)
    got = cluster._labels(torch.as_tensor(x), torch.as_tensor(c))
    np.testing.assert_array_equal(got.numpy(), want)
    diff = x - c[want]
    per_row = diff[:, 0] * diff[:, 0]
    for j in range(1, d):
        per_row = per_row + diff[:, j] * diff[:, j]
    inertia = cluster._inertia(torch.as_tensor(x), torch.as_tensor(c), got)
    assert inertia.dtype == torch.float32
    assert float(inertia) == np.float32(per_row.astype(np.float64).sum())


# --------------------------------------------------------------------------- #
# MSM + PCCA+
# --------------------------------------------------------------------------- #


def _two_scale_chain(a=0.3, eps=0.02):
    """4-state reversible chain: macro blocks {0, 1} and {2, 3}, fast mixing
    within (a), slow hops between (eps); memberships crisp in closed form,
    coarse matrix [[1-eps, eps], [eps, 1-eps]] (tests/test_msm.py's
    fixture)."""
    return np.array([[1 - a - eps, a, eps, 0.0], [a, 1 - a - eps, 0.0, eps],
                     [eps, 0.0, 1 - a - eps, a], [0.0, eps, a, 1 - a - eps]])


def _ring_chain(a=0.25, eps=0.01):
    """6 states, 3 macro blocks of 2 on a ring; each block hops to each
    neighbour with probability eps (tests/test_msm.py's fixture)."""
    p = np.zeros((6, 6))
    for b in range(3):
        for i in range(2):
            s = 2 * b + i
            p[s, s] = 1 - a - 2 * eps
            p[s, 2 * b + (1 - i)] = a
            p[s, 2 * ((b + 1) % 3) + i] = eps
            p[s, 2 * ((b - 1) % 3) + i] = eps
    return p


def _blocks_chain():
    """7 states in decoupled blocks [0, 1, 2], [3, 4], [5, 6]."""
    p = np.zeros((7, 7))
    for block in ([0, 1, 2], [3, 4], [5, 6]):
        k = len(block)
        sub = np.full((k, k), 0.1 / max(k - 1, 1))
        np.fill_diagonal(sub, 0.9)
        p[np.ix_(block, block)] = sub / sub.sum(1, keepdims=True)
    return p


@pytest.mark.parametrize("chain,n_macro", [(_two_scale_chain(), 2), (_ring_chain(), 3), (_blocks_chain(), 3)])
def test_pcca_plus_and_coarse_kinetics_match_jax(chain, n_macro):
    """Memberships, the stationary distribution and (where the chain is
    connected, so that it is unique) the coarse-grained matrix on the
    analytic chains, and each block's crisp membership."""
    chi = msm.pcca_plus(chain, n_macro)
    _close(chi, jmsm.pcca_plus(chain, n_macro), atol=1e-10)
    _close(msm.stationary_distribution(chain), jmsm.stationary_distribution(chain), atol=1e-12)
    if (chain > 0).sum() != (chain > 0)[:, :3].sum() + (chain > 0)[:, 3:].sum() or n_macro == 2 or \
            np.count_nonzero(np.isclose(np.linalg.eigvals(chain), 1.0)) == 1:
        _close(msm.coarse_grain_transition(chain, chi), jmsm.coarse_grain_transition(chain, chi), atol=1e-10)
    assert np.allclose(np.sort(chi.max(1)), 1.0, atol=1e-8)


def test_transition_matrix_counts_match_jax():
    """Lagged counts over trajectories of several lengths (one too short
    to count), reversible or not, from numpy arrays and tensors."""
    rng = np.random.default_rng(0)
    trajs = [rng.integers(0, 6, size=n) for n in (50, 3, 17, 1)]
    for lag in (1, 3):
        for rev in (True, False):
            want = jmsm.estimate_transition_matrix(trajs, 6, lag, rev)
            _close(msm.estimate_transition_matrix(trajs, 6, lag, rev), want, atol=1e-15)
            _close(msm.estimate_transition_matrix([torch.as_tensor(t) for t in trajs], 6, lag, rev), want,
                   atol=1e-15)


def test_temporal_smooth_is_numpy_convolve():
    p = np.random.default_rng(0).random((50, 4)).astype(np.float32)
    for win in (2, 3, 5):
        _close(msm._temporal_smooth(torch.as_tensor(p), win), jmsm._temporal_smooth(p, win), atol=1e-7)


def _two_scale_embeddings(seed=0, t=3000):
    rng = np.random.default_rng(seed)
    p = _two_scale_chain()
    micro = np.empty(t, int)
    micro[0] = 0
    for i in range(1, t):
        micro[i] = rng.choice(4, p=p[micro[i - 1]])
    centres = np.array([[0, 0], [8, 0], [0, 8], [8, 8]], float)
    z = centres[micro] + rng.normal(0, 0.3, (t, 2))
    return {"e0": z[:1800].astype(np.float32), "e1": z[1800:].astype(np.float32)}


@pytest.mark.parametrize("smooth", [None, 3])
def test_get_soft_counts_msm_matches_jax(smooth):
    """The MSM pipeline on two-scale data with more rows than a minibatch:
    the same microstates (labels), transition matrix and memberships."""
    embs = _two_scale_embeddings()
    want = jmsm.get_soft_counts_msm(embs, n_components=2, n_micro=8, lagtime=1, temporal_smooth_win=smooth)
    got = msm.get_soft_counts_msm(embs, n_components=2, n_micro=8, lagtime=1, temporal_smooth_win=smooth,
                                  device="cpu")
    for key in embs:
        assert got[key].dtype == np.float32
        _close(got[key], want[key], atol=PROB_TOL)
    pooled = np.concatenate(list(embs.values()))
    jfit = jmsm.fit_msm_pcca(embs, n_macro=2, n_micro=8, lagtime=1, sample_size=2500)
    pfit = msm.fit_msm_pcca(embs, n_macro=2, n_micro=8, lagtime=1, sample_size=2500, device="cpu")
    _close(pfit["transition"], jfit["transition"], atol=1e-12)
    np.testing.assert_array_equal(
        pfit["kmeans"].predict(msm.standardize(pfit["scaler"], torch.as_tensor(pooled))).numpy(),
        jfit["kmeans"].predict(jfit["scaler"].transform(pooled)))


def _contrastive_embeddings():
    """Two sequences of one length (the JAX side compiles its scans once a
    shape)."""
    x = _sticky_sequences(6, 2, 300, d=3, k=3, scale=4.0)
    return {"a": x[0], "b": x[1]}


@pytest.mark.parametrize("case", CONTRASTIVE_CASES)
def test_contrastive_soft_counts_match_jax(jax_hmm_results, case):
    """The sticky-HMM extractor: an int state count, BIC and AIC over 2..3,
    and priors (their width fixes K); plain dicts without coordinates."""
    want = jax_hmm_results["contrastive", case]
    got = msm.get_contrastive_soft_counts(None, _contrastive_embeddings(), device="cpu", **_contrastive_kwargs(case))
    assert list(got) == list(want)
    for key in want:
        assert got[key].shape == want[key].shape
        _close(got[key], want[key], atol=PROB_TOL)


@pytest.mark.parametrize("case", CONTRASTIVE_CASES)
def test_sticky_hmm_fit_then_posteriors(case):
    """``fit_sticky_hmm`` then ``sticky_hmm_posteriors`` are the extractor
    bit for bit, and one fitted model decodes other embeddings: a copy
    moved by 1e-6 keeps its hard labels."""
    embs, kw = _contrastive_embeddings(), _contrastive_kwargs(case)
    priors = {k: kw.pop(k) for k in ("soft_counts", "min_confidence") if k in kw}
    model = msm.fit_sticky_hmm(embs, soft_counts=priors.get("soft_counts"), device="cpu", **kw)
    assert model.k == 3 and model.means.shape == (3, 3) and model.log_a.shape == (3, 3)
    got = msm.sticky_hmm_posteriors(model, embs, device="cpu", **priors)
    want = msm.get_contrastive_soft_counts(None, embs, device="cpu", **kw, **priors)
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    moved = {k: v + 1e-6 * np.random.default_rng(1).standard_normal(v.shape) for k, v in embs.items()}
    for key, p in msm.sticky_hmm_posteriors(model, moved, device="cpu", **priors).items():
        np.testing.assert_array_equal(p.argmax(1), want[key].argmax(1))


def test_contrastive_soft_counts_raises(tmp_path):
    """What raises, and a very large project's soft counts saved as
    pointers to {project}/Tables/{key}/{key}_soft_counts."""
    embs = _contrastive_embeddings()
    with pytest.raises(ValueError, match="empty"):
        msm.get_contrastive_soft_counts(None, {}, device="cpu")
    project = SimpleNamespace(_very_large_project=True, _table_path=str(tmp_path / "p" / "Tables"),
                              get_exp_conditions=None)
    saved = msm.get_contrastive_soft_counts(project, embs, states=2, device="cpu")
    plain = msm.get_contrastive_soft_counts(None, embs, states=2, device="cpu")
    for key in embs:
        assert saved[key]["npy_table"] == os.path.join(str(tmp_path), "p", "Tables", key, f"{key}_soft_counts")
        np.testing.assert_array_equal(get_dt(saved, key), plain[key])
    with pytest.raises(NotImplementedError, match="invalid states"):
        msm.get_contrastive_soft_counts(None, embs, states="hic", device="cpu")
    with pytest.raises(ValueError, match="must match"):
        msm.get_contrastive_soft_counts(None, embs, states=2, soft_counts={"a": np.ones((5, 3)) / 3},
                                        device="cpu")


# --------------------------------------------------------------------------- #
# Gates on a two-animal csv project
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    root = str(write_project(tmp_path_factory.mktemp("softcounts"), "csv", lengths=LENGTHS, keys=KEYS))
    mp = pytest.MonkeyPatch()
    mp.setenv("DEEPOF_TPU_DEVICE_SCALE", "1")
    try:
        j_coords = JaxProject(**_project_args(root, "csv")).create(force=True, test=True, verbose=False)
        j_ggd = j_coords.get_graph_dataset(window_size=WINDOW)
    finally:
        mp.undo()
    p_coords = Project(**{**_project_args(root, "csv"), "project_name": "port"}, device="cpu").create(
        force=True, test=True, verbose=False)
    p_ggd = p_coords.get_graph_dataset(window_size=WINDOW)
    return {"jax": (j_coords, j_ggd), "port": (p_coords, p_ggd)}


def _behaviour_tables(seed=0):
    """Seeded binary behaviour tables (with NaNs) for both packages."""
    rng = np.random.default_rng(seed)
    cols = ["B_huddle", "B_climbing", "W_sniffing"]
    j, p = {}, {}
    for key, t in zip(KEYS, LENGTHS):
        runs = np.repeat(rng.random((t // 10 + 1, 3)) < 0.3, 10, axis=0)[:t].astype(np.float64)
        runs[rng.random((t, 3)) < 0.02] = np.nan
        j[key] = pd.DataFrame(runs, columns=cols)
        p[key] = LazyFrame(lambda a=runs: a, cols, t)
    return (JaxTableDict(j, typ="supervised_annotation"), TableDict(p, typ="supervised_annotation"))


def _same_series(got, want, rtol=1e-7):
    assert list(got) == list(want)
    for key in want:
        assert list(got[key]) == list(want[key])
        for gate in want[key]:
            assert got[key][gate].dtype == want[key][gate].dtype
            _close(got[key][gate], want[key][gate], rtol=rtol)


def test_supervised_chaos_matches_jax(project):
    (j_coords, _), (p_coords, _) = project["jax"], project["port"]
    for kw in ({}, {"quality_threshold": 0.9, "frac_bps_below": 0.2}):
        want, got = jgating.get_supervised_chaos(j_coords, **kw), gating.get_supervised_chaos(p_coords, **kw)
        assert list(got) == list(want)
        for key in want:
            assert got[key].columns == list(want[key].columns) == ["B_chaos", "W_chaos", "anychaos"]
            np.testing.assert_array_equal(got[key].realize(), want[key].to_numpy(np.float64))
    assert got["test"].realize()[90:102, 1].all()  # W absent for 12 frames of "test"


def test_gating_series_edges_and_masks_match_jax(project):
    """Distance series of the animal pair (Center and Nose), behaviour
    windows and combination codes, the "" fallback; quantile and fixed
    edges; masks and the preprocessed gates."""
    (j_coords, _), (p_coords, _) = project["jax"], project["port"]
    for bp in ("Center", "Nose"):
        _same_series(gating.get_pairwise_distances(p_coords, WINDOW, embedding_gates=bp),
                     jgating.get_pairwise_distances(j_coords, WINDOW, embedding_gates=bp))
    j_sup, p_sup = _behaviour_tables()
    for gates, combos in ((["B_huddle", "W_sniffing", "nope"], True), (["B_huddle", "B_climbing"], False),
                          ("B_climbing", True), (["nope"], True)):
        _same_series(gating.get_pairwise_distances(p_coords, WINDOW, p_sup, gates, combos),
                     jgating.get_pairwise_distances(j_coords, WINDOW, j_sup, gates, combos), rtol=0.0)
    for kw in ({}, {"M_gates": 4, "window_size": 5}, {"fixed_edges": [0, 50, 100, 1]}):
        want = jgating.compute_gate_edges(j_coords, **kw)
        got = gating.compute_gate_edges(p_coords, **kw)
        assert list(got) == list(want) == [("B", "W")]
        _close(got[("B", "W")], want[("B", "W")], rtol=1e-7)
    assert gating.compute_gate_edges(p_coords, supervised_annotations=p_sup, embedding_gates=["B_huddle"]) is None
    with pytest.raises(ValueError, match="fixed_edges"):
        gating.compute_gate_edges(p_coords, fixed_edges=[0, 1])
    embs = {k: np.zeros((t - WINDOW + 1, 2), np.float32) for k, t in zip(KEYS, LENGTHS)}
    for sup in ((None, None), (j_sup, p_sup)):
        gates = "Center" if sup[0] is None else ["B_huddle", "W_sniffing"]
        jk, jg, jm, _, jeff = jgating._preprocess_gates(j_coords, embs, None, WINDOW, sup[0], 3, gates, None)
        pk, pg, pm, pz, peff = gating._preprocess_gates(p_coords, embs, None, WINDOW, sup[1], 3, gates, None,
                                                        torch.device("cpu"))
        assert (pk, pg, peff) == (jk, jg, jeff) and isinstance(pz["test"], torch.Tensor)
        for gate in jg:
            for b in range(jeff):
                for key in jk:
                    np.testing.assert_array_equal(pm[gate][b][key], jm[gate][b][key])


def test_runs_samples_and_tags_match_jax():
    rng = np.random.default_rng(3)
    for _ in range(5):
        mask = np.repeat(rng.random(40) < 0.5, rng.integers(1, 6, 40))
        for min_len in (1, 2, 4):
            assert gating._mask_to_runs(mask, min_len) == jgating._mask_to_runs(mask, min_len)
    assert gating._mask_to_runs(np.zeros(5, bool)) == []
    segs = [rng.normal(size=(n, 3)).astype(np.float32) for n in (30, 1, 70, 12)]
    for n in (5, 50, 200):
        want = jgating._reservoir_sample(segs, n, seed=9)
        np.testing.assert_array_equal(gating._reservoir_sample(segs, n, seed=9), want)
        np.testing.assert_array_equal(gating._reservoir_sample([torch.as_tensor(s) for s in segs], n, seed=9).numpy(),
                                      want)
    for gate in (("B", "W"), "", None, "a/b c"):
        assert gating._gate_to_tag(gate) == jgating._gate_to_tag(gate)
    x = rng.random(30)
    x[rng.random(30) < 0.1] = np.nan
    _close(gating._moving_mean_valid(x, 4), jgating._moving_mean_valid(x, 4), atol=0.0)
    np.testing.assert_array_equal(gating._moving_any_valid(x, 4), jgating._moving_any_valid(x, 4))


# --------------------------------------------------------------------------- #
# Gated decoders
# --------------------------------------------------------------------------- #


def _gated_embeddings(seed=0, d=4, k=3):
    """Seeded embeddings of each recording's windows: k separated sticky
    clusters."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(scale=6.0, size=(k, d))
    out = {}
    for key, t in zip(KEYS, LENGTHS):
        n = t - WINDOW + 1
        labels = np.repeat(rng.integers(0, k, n // 15 + 1), 15)[:n]
        out[key] = (centres[labels] + rng.normal(size=(n, d))).astype(np.float32)
    return out


def _same_counts(got, want, tol=PROB_TOL):
    assert list(got) == list(want)
    for gate in want:
        assert list(got[gate]) == list(want[gate])
        for key in want[gate]:
            g, w = np.asarray(got[gate][key]), np.asarray(want[gate][key])
            assert g.dtype == np.float32
            _close(g, w, atol=tol)
            assert (g.argmax(1) == w.argmax(1)).mean() >= 0.999


@pytest.mark.parametrize("decoder", ["gmm", "msm"])
@pytest.mark.parametrize("gates", ["Center", "behaviours"])
def test_gated_decoders_match_jax(project, decoder, gates):
    (j_coords, _), (p_coords, _) = project["jax"], project["port"]
    embs = _gated_embeddings()
    j_sup, p_sup = _behaviour_tables(1) if gates == "behaviours" else (None, None)
    gate_arg = ["B_huddle", "W_sniffing"] if gates == "behaviours" else "Center"
    kw = dict(window_size=WINDOW, N_clusters_per_gate=3, M_gates=3, embedding_gates=gate_arg)
    if decoder == "gmm":
        want = jgating.get_contrastive_soft_counts_gmm(j_coords, embs, supervised_annotations=j_sup, **kw)
        got = gating.get_contrastive_soft_counts_gmm(p_coords, embs, supervised_annotations=p_sup, **kw)
    else:
        kw.update(n_micro=12, lagtime=3)
        want = jgating.get_contrastive_soft_counts_msm_pcca(j_coords, embs, supervised_annotations=j_sup, **kw)
        got = gating.get_contrastive_soft_counts_msm_pcca(p_coords, embs, supervised_annotations=p_sup, **kw)
    _same_counts(got, want)


def test_chaos_gates_match_jax(project):
    """add_chaos_gates on the MSM decoder's counts and the chaos-gated GMM's,
    and its length raises."""
    (j_coords, _), (p_coords, _) = project["jax"], project["port"]
    embs = _gated_embeddings(2)
    kw = dict(window_size=WINDOW, N_clusters_per_gate=3, M_gates=3)
    j_chaos, p_chaos = jgating.get_supervised_chaos(j_coords), gating.get_supervised_chaos(p_coords)
    j_reg = jgating.get_contrastive_soft_counts_msm_pcca(j_coords, embs, n_micro=12, temporal_smooth_win=1, **kw)
    p_reg = gating.get_contrastive_soft_counts_msm_pcca(p_coords, embs, n_micro=12, temporal_smooth_win=1, **kw)
    chaos_kw = dict(kw, embedding_gates=["anychaos"], temporal_smooth_win=1)
    j_c = jgating.get_contrastive_soft_counts_gmm(j_coords, embs, supervised_annotations=j_chaos, **chaos_kw)
    p_c = gating.get_contrastive_soft_counts_gmm(p_coords, embs, supervised_annotations=p_chaos, **chaos_kw)
    _same_counts(p_c, j_c)
    want = jgating.add_chaos_gates(j_coords, j_reg, j_c, j_chaos, WINDOW)
    got = gating.add_chaos_gates(p_coords, p_reg, p_c, p_chaos, WINDOW)
    _same_counts(got, want)
    assert got[("B", "W")]["test"].shape == (LENGTHS[0] - WINDOW + 1, 9 + 3)
    short = {g: TableDict({k: v[:-1] for k, v in td.items()}, typ="unsupervised_counts") for g, td in p_c.items()}
    with pytest.raises(ValueError, match="Length mismatch"):
        gating.add_chaos_gates(p_coords, p_reg, short, p_chaos, WINDOW)


# --------------------------------------------------------------------------- #
# embedding_per_video and recluster
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def served(project):
    """The VaDE carried from flax params in both packages, and
    ``run(method)``: both packages' ``embedding_per_video`` with that
    extraction method, computed on first use and shared by the tests that
    read it."""
    (j_coords, j_ggd), (p_coords, p_ggd) = project["jax"], project["port"]
    j_bundle, p_bundle = _vade_bundles(p_ggd[1], p_ggd[2])
    cache = {}

    def run(method):
        if method not in cache:
            kw = dict(softcounts_extraction_method=method, n_micro=12, batch_size=64)
            env = pytest.MonkeyPatch()
            env.setenv("DEEPOF_TPU_DEVICE_SCALE", "1")
            try:
                want = jax_embed(j_coords, j_ggd[3], j_bundle, j_ggd[1], global_scaler=j_ggd[4], **kw)
            finally:
                env.undo()
            got = embedding_per_video(p_coords, p_ggd[3], p_bundle, p_ggd[1], global_scaler=p_ggd[4], **kw)
            cache[method] = (want, got)
        return cache[method]

    return j_bundle, p_bundle, run


@pytest.mark.parametrize("method", ["gmm", "msm", "hmm", "combined"])
def test_embedding_per_video_extraction_matches_jax(served, method):
    """embedding_per_video of a VaDE carried from flax params with each
    extraction method: the embeddings at 1e-5 and the extracted soft counts
    at the posterior bar, equal shapes ((W, 3 x 4) gated, (W, 4) hmm, (W,
    16) combined)."""
    (j_emb, j_counts), (p_emb, p_counts) = served[2](method)
    width = {"gmm": 12, "msm": 12, "hmm": 4, "combined": 16}[method]
    for key in KEYS:
        _close(p_emb[key], j_emb[key].to_numpy(), atol=1e-5, rtol=1e-5)
        # get_graph_dataset cuts every recording to the shortest
        assert p_counts[key].shape == j_counts[key].shape == (min(LENGTHS) - WINDOW + 1, width)
        want = j_counts[key].to_numpy()
        _close(p_counts[key], want, atol=HMM_E2E_TOL if method == "hmm" else PROB_TOL)
        assert (p_counts[key].argmax(1) == want.argmax(1)).mean() >= 0.99


def test_embedding_per_video_gate_selection(project, served):
    """extract_pair picks the pair's gate (against the shared "gmm" run); a
    behaviour-gated run warns and falls back to its first gate; a bad pair
    raises."""
    p_coords, p_ggd = project["port"]
    _, p_bundle, run = served
    args = (p_coords, p_ggd[3], p_bundle, p_ggd[1])
    kw = dict(global_scaler=p_ggd[4], softcounts_extraction_method="gmm", batch_size=64)
    _, base = run("gmm")[1]
    _, picked = embedding_per_video(*args, extract_pair=["W", "B"], **kw)
    for key in KEYS:
        np.testing.assert_array_equal(picked[key], base[key])
    _, sup = _behaviour_tables()
    with pytest.warns(UserWarning, match="not found among"):
        embedding_per_video(*args, supervised_annotations=sup, embedding_gates=["B_huddle"], **kw)
    with pytest.raises(AssertionError, match="not in"):
        embedding_per_video(*args, extract_pair=["B", "Q"], **kw)
    _, head = embedding_per_video(*args, global_scaler=p_ggd[4], batch_size=64, softcounts_extraction_method="x")
    assert head["test"].shape[1] == 4  # an unknown method keeps the model head's counts


@pytest.mark.parametrize("case", ["int", "aic", "priors"])
def test_recluster_matches_jax(project, case, tmp_path):
    """recluster with an int state count, AIC over 2..3 and soft-count
    priors; the port's pickle round trip through ``pretrained``."""
    (j_coords, _), (p_coords, _) = project["jax"], project["port"]
    # The shapes of the HMM tests above, whose JAX programs are then compiled.
    x, cut = (_sticky_sequences(2, 2, 80), 70) if case == "aic" else (_sticky_sequences(3, 2, 90), 75)
    j_emb = JaxTableDict({"test": x[0], "test2": x[1][:cut]}, typ="unsupervised_embedding")
    p_emb = TableDict({"test": x[0], "test2": x[1][:cut]}, typ="unsupervised_embedding")
    kw = {"int": {"states": 3}, "aic": {"states": "aic", "max_states": 3}, "priors": {}}[case]
    if case == "priors":
        rng = np.random.default_rng(2)
        priors = {"test": rng.dirichlet(np.ones(3) * 0.3, size=100), "test2": rng.dirichlet(np.ones(3), size=cut)}
        kw = {"soft_counts": TableDict(priors, typ="unsupervised_counts")}
        j_kw = {"soft_counts": JaxTableDict(priors, typ="unsupervised_counts")}
    else:
        j_kw = kw
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jph.recluster(j_coords, j_emb, save=False, covariance_type="full", **j_kw)
    with pytest.warns(UserWarning, match="diagonal"):
        got = pph.recluster(p_coords, p_emb, covariance_type="full", **kw)
    for key in ("test", "test2"):
        _close(got[key], np.asarray(want[key]), atol=PROB_TOL)
    if case != "priors":
        path = os.path.join(p_coords._project_path, p_coords._project_name, "Trained_models",
                            f"hmm_trained_{kw['states']}.pkl")
        again = pph.recluster(p_coords, p_emb, pretrained=path, **kw)
        for key in ("test", "test2"):
            np.testing.assert_array_equal(again[key], got[key])
