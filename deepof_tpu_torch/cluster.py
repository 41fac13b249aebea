"""sklearn's ``KMeans``, ``GaussianMixture`` and ``MiniBatchKMeans`` (1.9.0),
restated in torch for the soft-count decoders.

The JAX package fits these sklearn estimators (``deepof_tpu/msm.py`` and
``deepof_tpu/gating.py``); the card's machine has no sklearn. Each estimator
here follows its sklearn counterpart step for step, in the dtype of the data
it is given (float32 embeddings are fitted in float32, as sklearn fits
them), with its arithmetic in torch on the data's device:

- ``KMeans``: the data centred on its mean, then ``n_init`` runs of
  k-means++ seeding (2 + floor(ln k) local trials, squared distances
  computed in float64 and rounded to the data's dtype as sklearn's
  ``_euclidean_distances`` does) and Lloyd's iterations with ``||c||^2 - 2
  x.c`` labels, empty clusters moved to the farthest points, until the
  labels repeat or the centre shift is at most ``tol`` times the mean
  feature variance; a later run replaces the best one where its inertia is
  lower and its labels are no function of the best run's (sklearn's
  ``_is_same_clustering``);
- ``GaussianMixture`` with "full", "tied", "diag" or "spherical"
  covariances and the k-means init: EM until the mean log-likelihood
  changes by less than ``tol``, Cholesky precisions for "full" and "tied"
  (a ValueError on an ill-defined covariance, as sklearn raises);
  ``score``, ``bic`` and ``_n_parameters`` as sklearn counts them;
- ``MiniBatchKMeans``: ``n_init`` k-means++ inits on ``init_size`` rows
  judged on a validation sample, then minibatch steps with the running
  per-centre weights, random reassignment of light centres and the early
  stop on the smoothed batch inertia.

Every random draw comes from numpy on the host, from the ``RandomState``
that sklearn's ``check_random_state`` makes of ``random_state``, in the
order sklearn draws (``GaussianMixture`` hands its instance to its
``KMeans``), so that the same seed gives the same components and centres in
the same order. Float sums run in other orders than sklearn's BLAS and
cython loops; where a comparison decides a draw or a stop (a candidate's
potential, a near tie of two distances) the two can part, in principle.
Each cluster's sum adds its rows in row order on every device
(``gmm.cluster_sums``), so a fit on the card repeats bit for bit. The
labels' distances and the inertia's per-row distances are summed feature
by feature in elementwise operations, which round alike on every device (a
matrix product sums in its library's order, which differs between the
card and the CPU and flipped near-ties of the MSM decoder's 200
microstates, so the two devices' macrostates parted on some fits).

Host reads: k-means++ copies each centre's distances (its draws are
numpy's), each Lloyd or EM iteration reads its convergence scalars, each
minibatch step its batch's cluster counts and inertia (one copy a step).
"""

from __future__ import annotations

import math
import numbers
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from deepof_tpu_torch.device import resolve_device, to_device
from deepof_tpu_torch.train import gmm

ILL_DEFINED = (
    "Fitting the mixture model failed because some components have ill-defined empirical covariance (for "
    "instance caused by singleton or collapsed samples). Try to decrease the number of components, increase "
    "reg_covar, or scale the input data."
)
# Rows a distance block covers, so that (rows, clusters) blocks stay small.
_ROWS = 1 << 16


def check_random_state(seed) -> np.random.RandomState:
    """sklearn's ``check_random_state``: None -> numpy's global RandomState,
    an int -> a new one, a RandomState -> itself."""
    if seed is None or seed is np.random:
        return np.random.mtrand._rand
    if isinstance(seed, numbers.Integral):
        return np.random.RandomState(seed)
    if isinstance(seed, np.random.RandomState):
        return seed
    raise ValueError(f"{seed!r} cannot be used to seed a numpy.random.RandomState instance")


def _np_dtype(x: torch.Tensor):
    return np.float64 if x.dtype == torch.float64 else np.float32


def _as_data(x, device) -> torch.Tensor:
    """float32 or float64 rows on ``device`` (other dtypes to float64)."""
    dev = resolve_device(device)
    if isinstance(x, torch.Tensor):
        dtype = x.dtype if x.dtype in (torch.float32, torch.float64) else torch.float64
    else:
        dtype = torch.float32 if np.asarray(x).dtype == np.float32 else torch.float64
    return to_device(x, dev, dtype).contiguous()


def _upcast_sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(n, m) squared distances of a's rows to b's, ``-2 a.b + |a|^2 + |b|^2``
    in float64, then in a's dtype and clipped at 0 (sklearn's
    ``_euclidean_distances``, its float32 inputs upcast by chunks)."""
    a64, b64 = a.to(torch.float64), b.to(torch.float64)
    d = -2.0 * (a64 @ b64.T)
    d += (a64 * a64).sum(1)[:, None]
    d += (b64 * b64).sum(1)[None, :]
    return d.to(a.dtype).clamp_(min=0.0)


def kmeans_plusplus(x: torch.Tensor, k: int, random_state: np.random.RandomState) -> torch.Tensor:
    """sklearn's ``_kmeans_plusplus`` with unit sample weights -> (k,) row
    indices of x. The first centre is ``random_state.choice(n, p=w/w.sum())``;
    each next one the best of 2 + floor(ln k) candidates drawn as
    ``uniform * potential`` searched in the cumulative squared distances.

    The distances are computed on x's device; the closest distances, their
    cumulative sum and the candidates' potentials are numpy's on the host,
    in x's dtype as sklearn sums them (a float32 cumulative sum drifts from
    an exact one by a fair share of one point's spacing over tens of
    thousands of rows, so any other summation picks other candidates). One
    host copy a centre."""
    n = x.shape[0]
    trials = 2 + int(np.log(k))
    weights = np.ones(n, dtype=_np_dtype(x))
    first = int(random_state.choice(n, p=weights / weights.sum()))
    indices = [first]
    closest = _upcast_sq_dist(x[first:first + 1], x).cpu().numpy()
    pot = closest @ weights
    for _ in range(1, k):
        rand = random_state.uniform(size=trials) * pot
        cand = np.searchsorted(np.cumsum(weights * closest), rand)
        np.clip(cand, None, n - 1, out=cand)
        dist = _upcast_sq_dist(x[torch.as_tensor(cand, device=x.device)], x).cpu().numpy()
        np.minimum(closest, dist, out=dist)
        pots = dist @ weights.reshape(-1, 1)
        best = int(np.argmin(pots))
        pot, closest = pots[best], dist[best]
        indices.append(int(cand[best]))
    return torch.as_tensor(indices, device=x.device)


def _feature_sum(fn, n_features: int) -> torch.Tensor:
    """fn(0) + fn(1) + ... + fn(n_features - 1), added in that order."""
    acc = fn(0)
    for j in range(1, n_features):
        acc = acc + fn(j)
    return acc


def _labels(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Nearest centre by ``|c|^2 - 2 x.c`` in x's dtype (sklearn's
    ``_update_chunk_dense``), the first on a tie; both sums taken feature by
    feature (the same bits on every device)."""
    d = centers.shape[1]
    cn = _feature_sum(lambda j: centers[:, j] * centers[:, j], d)

    def nearest(xs):
        return (cn[None] - 2.0 * _feature_sum(lambda j: xs[:, j, None] * centers[:, j][None], d)).argmin(1)

    return torch.cat([nearest(x[s:s + _ROWS]) for s in range(0, max(x.shape[0], 1), _ROWS)])[:x.shape[0]]


def _inertia(x: torch.Tensor, centers: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Sum of squared distances to the assigned centres (each row's summed
    feature by feature), a float64 sum rounded to x's dtype (a 0-d
    tensor)."""
    diff = x - centers[labels]
    d = _feature_sum(lambda j: diff[:, j] * diff[:, j], x.shape[1])
    return d.to(torch.float64).sum().to(x.dtype)


def labels_inertia(x: torch.Tensor, centers: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(labels, inertia) of x against ``centers`` (sklearn's ``_labels_inertia``)."""
    labels = _labels(x, centers)
    return labels, _inertia(x, centers, labels)


# --------------------------------------------------------------------------- #
# KMeans
# --------------------------------------------------------------------------- #


class KMeans:
    """sklearn's ``KMeans`` with k-means++ and Lloyd's algorithm, dense
    data, unit weights, ``n_init`` runs (sklearn's "auto" is 1 for
    k-means++). Fitted attributes are tensors on the data's device:
    ``cluster_centers_``, ``labels_``, ``inertia_``; ``n_iter_`` an int."""

    def __init__(self, n_clusters: int = 8, max_iter: int = 300, tol: float = 1e-4, random_state=None,
                 n_init: int = 1, device="cuda"):
        self.n_clusters = n_clusters
        self.max_iter = max_iter
        self.tol = tol
        self.random_state = random_state
        self.n_init = n_init
        self.device = device

    def fit(self, x) -> "KMeans":
        x = _as_data(x, self.device)
        n, k = x.shape[0], self.n_clusters
        if n < k:
            raise ValueError(f"n_samples={n} should be >= n_clusters={k}.")
        rs = check_random_state(self.random_state)
        tol = float(x.to(torch.float64).var(0, correction=0).mean().to(x.dtype)) * self.tol if self.tol else 0.0
        mean = x.to(torch.float64).mean(0).to(x.dtype)
        xc = x - mean
        best = None
        for _ in range(self.n_init):
            run = _lloyd(xc, xc[kmeans_plusplus(xc, k, rs)], self.max_iter, tol)
            if best is None or (float(run[1]) < float(best[1]) and not _same_clustering(run[0], best[0], k)):
                best = run
        self.labels_, self.inertia_, centers, self.n_iter_ = best
        self.cluster_centers_ = centers + mean
        return self

    def predict(self, x) -> torch.Tensor:
        return _labels(_as_data(x, self.cluster_centers_.device).to(self.cluster_centers_.dtype),
                       self.cluster_centers_)


def _same_clustering(labels, best, k: int) -> bool:
    """sklearn's ``_is_same_clustering``: ``best`` is a function of
    ``labels`` (each cluster of ``labels`` lies in one cluster of ``best``)."""
    return len(torch.unique(labels * k + best)) == len(torch.unique(labels))


def _lloyd(x, centers, max_iter, tol):
    """sklearn's ``_kmeans_single_lloyd``: (labels, inertia, centers, n_iter)."""
    k = centers.shape[0]
    labels_old = None
    strict = False
    for i in range(max_iter):
        labels = _labels(x, centers)
        counts = torch.bincount(labels, minlength=k).to(x.dtype)
        sums = gmm.cluster_sums(x, labels, k)
        same = labels_old is not None and torch.equal(labels, labels_old)
        empty = np.flatnonzero(counts.cpu().numpy() == 0)
        if empty.size:
            _relocate_empty(x, centers, labels, sums, counts, empty)
        new = _average(sums, counts)
        shift = float(((new - centers) ** 2).sum())
        centers = new
        if same:
            strict = True
            break
        if shift <= tol:
            break
        labels_old = labels
    if not strict:
        labels = _labels(x, centers)
    return labels, _inertia(x, centers, labels), centers, i + 1


def _relocate_empty(x, centers_old, labels, sums, counts, empty):
    """sklearn's ``_relocate_empty_clusters_dense``, in place on the sums and
    counts: each empty cluster takes one of the points farthest from their
    centres (numpy's ``argpartition`` picks them, on the host)."""
    dist = ((x - centers_old[labels]) ** 2).sum(1).cpu().numpy()
    if dist.max() == 0:
        return
    far = np.argpartition(dist, -len(empty))[:-len(empty) - 1:-1]
    for new_id, idx in zip(empty.tolist(), far.tolist()):
        old_id = int(labels[idx])
        sums[old_id] -= x[idx]
        sums[new_id] = x[idx]
        counts[new_id] = 1.0
        counts[old_id] -= 1.0


def _average(sums, counts):
    """sklearn's ``_average_centers``: sums times the reciprocal count; a
    weightless centre takes the heaviest centre's."""
    avg = sums * (1.0 / counts.clamp(min=1))[:, None]
    return torch.where((counts > 0)[:, None], avg, avg[counts.argmax()][None])


# --------------------------------------------------------------------------- #
# GaussianMixture
# --------------------------------------------------------------------------- #


COVARIANCE_TYPES = ("full", "tied", "diag", "spherical")


class GaussianMixture:
    """sklearn's ``GaussianMixture`` with "full", "tied", "diag" or
    "spherical" covariances and ``init_params="kmeans"``, one init. Fitted
    attributes are tensors on the data's device: ``weights_``, ``means_``,
    ``covariances_``, ``precisions_cholesky_``; ``n_iter_``,
    ``converged_``, ``lower_bound_``."""

    def __init__(self, n_components: int = 1, covariance_type: str = "full", tol: float = 1e-3,
                 reg_covar: float = 1e-6, max_iter: int = 100, random_state=None, init_params: str = "kmeans",
                 device="cuda"):
        if covariance_type not in COVARIANCE_TYPES:
            raise ValueError(f"covariance_type={covariance_type!r}: expected one of {COVARIANCE_TYPES}")
        if init_params != "kmeans":
            raise NotImplementedError(f"init_params={init_params!r}: only 'kmeans' is ported")
        self.n_components = n_components
        self.covariance_type = covariance_type
        self.tol = tol
        self.reg_covar = reg_covar
        self.max_iter = max_iter
        self.random_state = random_state
        self.init_params = init_params
        self.device = device

    def fit(self, x) -> "GaussianMixture":
        x = _as_data(x, self.device)
        n, k = x.shape[0], self.n_components
        if n < 2 or n < k:
            raise ValueError(f"Expected n_samples >= n_components but got n_components = {k}, n_samples = {n}")
        rs = check_random_state(self.random_state)
        labels = KMeans(k, random_state=rs, device=x.device).fit(x).labels_
        resp = torch.nn.functional.one_hot(labels, k).to(x.dtype)
        weights, means, cov = _gaussian_parameters(x, resp, self.reg_covar, self.covariance_type)
        self._set(weights / n, means, cov)
        lower = np.float32(-np.inf) if x.dtype == torch.float32 else -np.inf
        cast = np.float32 if x.dtype == torch.float32 else np.float64
        self.converged_ = False
        for n_iter in range(1, self.max_iter + 1):
            prev = lower
            log_norm, log_resp = self._e_step(x)
            weights, means, cov = _gaussian_parameters(x, torch.exp(log_resp), self.reg_covar, self.covariance_type)
            self._set(weights / weights.sum(), means, cov)
            lower = cast(float(log_norm))
            if abs(lower - prev) < self.tol:
                self.converged_ = True
                break
        if not self.converged_:
            warnings.warn("Best performing initialization did not converge. Try different init parameters, "
                          "or increase max_iter, tol, or check for degenerate data.")
        self.n_iter_ = n_iter
        self.lower_bound_ = float(lower)
        return self

    def _set(self, weights, means, cov):
        self.weights_, self.means_, self.covariances_ = weights, means, cov
        self.precisions_cholesky_ = _precision_cholesky(cov, self.covariance_type)

    def _weighted_log_prob(self, x):
        if self.covariance_type == "diag":
            return gmm._weighted_log_prob(x, self.weights_, self.means_, self.covariances_)
        return _log_gaussian_prob(x, self.means_, self.precisions_cholesky_, self.covariance_type) \
            + torch.log(self.weights_)

    def _e_step(self, x):
        """(mean log-likelihood as a float64 sum rounded to x's dtype, log
        responsibilities)."""
        weighted = self._weighted_log_prob(x)
        norm = torch.logsumexp(weighted, dim=1)
        return norm.to(torch.float64).mean().to(x.dtype), weighted - norm[:, None]

    def _data(self, x) -> torch.Tensor:
        return _as_data(x, self.means_.device).to(self.means_.dtype)

    def predict_proba(self, x) -> torch.Tensor:
        return torch.exp(self._e_step(self._data(x))[1])

    def predict(self, x) -> torch.Tensor:
        return self._weighted_log_prob(self._data(x)).argmax(1)

    def score(self, x) -> float:
        """Mean log-likelihood of the rows (a float, as sklearn's)."""
        return float(self._e_step(self._data(x))[0])

    def _n_parameters(self) -> int:
        """Free parameters: covariances by type, means, weights less one."""
        k, d = self.means_.shape
        cov = {"full": k * d * (d + 1) / 2.0, "diag": k * d, "tied": d * (d + 1) / 2.0,
               "spherical": k}[self.covariance_type]
        return int(cov + d * k + k - 1)

    def bic(self, x) -> float:
        """Bayesian information criterion of the rows: ``-2 * score * n +
        n_parameters * log(n)``."""
        n = x.shape[0]
        return -2 * self.score(x) * n + self._n_parameters() * math.log(n)


def _gaussian_parameters(x, resp, reg_covar, covariance_type):
    """sklearn's ``_estimate_gaussian_parameters``: (nk, means, covariances)
    (the diagonal M-step is VaDE's GMM init's, ``train/gmm.py``;
    "spherical" is its mean over the features)."""
    if covariance_type in ("diag", "spherical"):
        nk, means, cov = gmm._gaussian_parameters(x, resp, reg_covar)
        return nk, means, cov if covariance_type == "diag" else cov.mean(1)
    nk = resp.sum(0) + 10 * torch.finfo(resp.dtype).eps
    means = (resp.T @ x) / nk[:, None]
    eye = torch.eye(x.shape[1], dtype=x.dtype, device=x.device)
    if covariance_type == "tied":
        cov = (x.T @ x - (nk * means.T) @ means) / nk.sum()
        return nk, means, cov + reg_covar * eye
    cov = torch.stack([((resp[:, j, None] * (x - means[j])).T @ (x - means[j])) / nk[j]
                       for j in range(means.shape[0])])
    return nk, means, cov + reg_covar * eye


def _precision_cholesky(cov, covariance_type):
    if covariance_type in ("diag", "spherical"):
        if bool((cov <= 0.0).any()):
            raise ValueError(ILL_DEFINED)
        return 1.0 / torch.sqrt(cov)
    chol, info = torch.linalg.cholesky_ex(cov)
    if bool((info != 0).any()):
        raise ValueError(ILL_DEFINED)
    eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device).expand_as(cov)
    return torch.linalg.solve_triangular(chol, eye, upper=False).transpose(-2, -1)


def _log_gaussian_prob(x, means, prec_chol, covariance_type):
    """sklearn's ``_estimate_log_gaussian_prob`` for the "full", "tied" and
    "spherical" types -> (n, k)."""
    d = x.shape[1]
    if covariance_type == "spherical":
        precisions = prec_chol ** 2
        log_prob = ((means ** 2).sum(1) * precisions - 2 * (x @ means.T * precisions)
                    + (x * x).sum(1)[:, None] * precisions[None])
        log_det = d * torch.log(prec_chol)
    elif covariance_type == "tied":
        xp = x @ prec_chol
        log_prob = torch.stack([((xp - means[j] @ prec_chol) ** 2).sum(1) for j in range(means.shape[0])], dim=1)
        log_det = torch.log(torch.diagonal(prec_chol)).sum()
    else:
        log_prob = torch.stack([((x @ prec_chol[j] - means[j] @ prec_chol[j]) ** 2).sum(1)
                                for j in range(means.shape[0])], dim=1)
        log_det = torch.log(torch.diagonal(prec_chol, dim1=1, dim2=2)).sum(1)
    return -0.5 * (d * math.log(2 * math.pi) + log_prob) + log_det


# --------------------------------------------------------------------------- #
# MiniBatchKMeans
# --------------------------------------------------------------------------- #


class MiniBatchKMeans:
    """sklearn's ``MiniBatchKMeans`` with k-means++ inits, dense data, unit
    weights, ``tol=0``. Fitted attributes: ``cluster_centers_``,
    ``labels_`` and ``inertia_`` (tensors on the data's device), ``n_steps_``
    (one host read each), ``n_iter_``; and this port's ``reassigned_``
    (centres reassigned)."""

    def __init__(self, n_clusters: int = 8, random_state=None, n_init: int = 3, batch_size: int = 1024,
                 max_iter: int = 100, max_no_improvement: Optional[int] = 10, reassignment_ratio: float = 0.01,
                 init_size: Optional[int] = None, device="cuda"):
        self.n_clusters = n_clusters
        self.random_state = random_state
        self.n_init = n_init
        self.batch_size = batch_size
        self.max_iter = max_iter
        self.max_no_improvement = max_no_improvement
        self.reassignment_ratio = reassignment_ratio
        self.init_size = init_size
        self.device = device

    def fit(self, x) -> "MiniBatchKMeans":
        x = _as_data(x, self.device)
        n, k = x.shape[0], self.n_clusters
        if n < k:
            raise ValueError(f"n_samples={n} should be >= n_clusters={k}.")
        batch = min(self.batch_size, n)
        init_size = self.init_size
        if init_size is None:
            init_size = 3 * batch if 3 * batch >= k else 3 * k
        elif init_size < k:
            init_size = 3 * k
        init_size = min(init_size, n)
        rs = check_random_state(self.random_state)
        dtype = _np_dtype(x)
        self.reassigned_ = 0

        x_valid = x[torch.as_tensor(rs.randint(0, n, init_size), device=x.device)]
        best = None
        for _ in range(self.n_init):
            xi = x[torch.as_tensor(rs.randint(0, n, init_size), device=x.device)] if init_size < n else x
            centers = xi[kmeans_plusplus(xi, k, rs)]
            inertia = float(labels_inertia(x_valid, centers)[1])
            if best is None or inertia < best[1]:
                best = (centers, inertia)
        centers = best[0]

        counts = np.zeros(k, dtype=dtype)
        self._ewa = self._ewa_min = None
        self._no_improvement = 0
        since_reassign = 0
        weights = np.ones(n, dtype=dtype)
        p = weights / np.sum(weights)
        n_steps = (self.max_iter * n) // batch
        for i in range(n_steps):
            xb = x[torch.as_tensor(rs.choice(n, batch, p=p, replace=True), device=x.device)]
            since_reassign += batch
            reassign = bool((counts == 0).any()) or since_reassign >= 10 * k
            if reassign:
                since_reassign = 0
            labels, inertia = labels_inertia(xb, centers)
            sums = gmm.cluster_sums(xb, labels, k)
            host = torch.cat([torch.bincount(labels, minlength=k).to(x.dtype), inertia[None]]).cpu().numpy()
            batch_counts, batch_inertia = host[:k], float(host[k])
            old = counts.copy()
            counts = counts + batch_counts
            alpha = np.where(batch_counts > 0, dtype(1) / np.where(counts > 0, counts, 1), 0).astype(dtype)
            tensor = torch.as_tensor(np.stack([old, alpha]), device=x.device)
            centers = torch.where(torch.as_tensor(batch_counts > 0, device=x.device)[:, None],
                                  (centers * tensor[0][:, None] + sums) * tensor[1][:, None], centers)
            if reassign and self.reassignment_ratio > 0:
                to_reassign = counts < self.reassignment_ratio * counts.max()
                if to_reassign.sum() > 0.5 * batch:
                    to_reassign[np.argsort(counts)[int(0.5 * batch):]] = False
                n_reassign = int(to_reassign.sum())
                self.reassigned_ += n_reassign
                if n_reassign:
                    picks = rs.choice(batch, replace=False, size=n_reassign)
                    centers = centers.clone()
                    centers[torch.as_tensor(np.flatnonzero(to_reassign), device=x.device)] = \
                        xb[torch.as_tensor(picks, device=x.device)]
                counts[to_reassign] = np.min(counts[~to_reassign])
            if self._converged(i, n, batch, batch_inertia):
                break
        self.cluster_centers_ = centers
        self.n_steps_ = i + 1
        self.n_iter_ = int(np.ceil(((i + 1) * batch) / n))
        self.labels_, self.inertia_ = labels_inertia(x, centers)
        return self

    def _converged(self, step, n, batch, batch_inertia) -> bool:
        """sklearn's ``_mini_batch_convergence`` (``tol=0``): the early stop
        on the exponentially weighted batch inertia."""
        batch_inertia /= batch
        if step + 1 == 1:
            return False
        if self._ewa is None:
            self._ewa = batch_inertia
        else:
            alpha = min(batch * 2.0 / (n + 1), 1)
            self._ewa = self._ewa * (1 - alpha) + batch_inertia * alpha
        if self._ewa_min is None or self._ewa < self._ewa_min:
            self._no_improvement = 0
            self._ewa_min = self._ewa
        else:
            self._no_improvement += 1
        return self.max_no_improvement is not None and self._no_improvement >= self.max_no_improvement

    def predict(self, x) -> torch.Tensor:
        return _labels(_as_data(x, self.cluster_centers_.device).to(self.cluster_centers_.dtype),
                       self.cluster_centers_)
