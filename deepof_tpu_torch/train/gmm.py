"""The GMM init of VaDE's mixture prior, in torch on the fit's device.

The JAX package fits ``sklearn.mixture.GaussianMixture(n_components,
covariance_type="diag", reg_covar=1e-4, random_state=seed)`` to the
pretrained latents (deepof_tpu/train/harness.py:888-901); the card's machine
has no sklearn, so this module follows sklearn's algorithm in float64
tensors:

- ``kmeans``: ``KMeans(n_init=1)``, k-means++ seeding with 2 + floor(ln K)
  local trials, then Lloyd iterations to strict convergence or a centre
  shift of at most 1e-4 of the mean feature variance, at most 300, empty
  clusters moved to the points farthest from their centres;
- ``gaussian_mixture_diag``: from the k-means labels, EM with the diagonal
  M-step and ``reg_covar`` until the mean log-likelihood changes by less
  than 1e-3, at most 100 iterations.

The k-means draws come from a ``torch.Generator``, not sklearn's
``RandomState``: the two start from the same mixture only where the
latents' clusters are well separated (ROADMAP queue 3). Each iteration
reads one scalar on the host to test convergence; all else stays on the
device.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def _sq_dist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(N, D), (K, D) -> (N, K) squared Euclidean distances."""
    return ((x[:, None, :] - c[None]) ** 2).sum(-1)


def kmeans_plusplus(x: torch.Tensor, k: int, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """sklearn's greedy k-means++ seeding (``_kmeans_plusplus``): the first
    centre uniformly, then each next one the best of 2 + floor(ln k)
    candidates drawn with probability proportional to the squared distance
    to the nearest centre. -> (k,) row indices."""
    n = x.shape[0]
    trials = 2 + int(math.log(k))
    idx = torch.randint(n, (1,), generator=generator, device=x.device)
    indices = [idx[0]]
    closest = ((x - x[idx]) ** 2).sum(-1)
    pot = closest.sum()
    for _ in range(1, k):
        rand = torch.rand(trials, generator=generator, device=x.device, dtype=x.dtype) * pot
        cand = torch.searchsorted(torch.cumsum(closest, 0), rand).clamp(max=n - 1)
        dist = torch.minimum(closest[None], _sq_dist(x, x[cand]).T)  # (trials, N)
        pots = dist.sum(-1)
        best = pots.argmin()
        pot, closest = pots[best], dist[best]
        indices.append(cand[best])
    return torch.stack(indices)


def cluster_sums(x: torch.Tensor, labels: torch.Tensor, k: int) -> torch.Tensor:
    """(k, D) sums of the rows of x (N, D) by label, each cluster's rows
    added in row order on every device, so that a fit repeats bit for bit.
    On the CPU ``index_add_`` adds in row order; on CUDA it adds with
    atomics in no fixed order, so there the labels are sorted (stably) and
    each cluster's rows added in turn by ``index_put_(accumulate=True)``."""
    sums = x.new_zeros((k, x.shape[1]))
    if x.is_cuda:
        return sums.index_put_((labels,), x, accumulate=True)
    return sums.index_add_(0, labels, x)


def kmeans(x: torch.Tensor, k: int, generator: Optional[torch.Generator] = None,
           max_iter: int = 300, tol: float = 1e-4) -> Tuple[torch.Tensor, torch.Tensor]:
    """``KMeans(n_clusters=k, n_init=1)`` (Lloyd) on x (N, D) ->
    (labels (N,), centres (k, D))."""
    x = x - x.mean(0)  # as sklearn centres the data for its distances
    tol = float(x.var(0, correction=0).mean()) * tol
    centers = x[kmeans_plusplus(x, k, generator)]
    labels_old = None
    strict = False
    for _ in range(max_iter):
        labels = _sq_dist(x, centers).argmin(1)
        counts = torch.bincount(labels, minlength=k).to(x.dtype)
        sums = cluster_sums(x, labels, k)
        empty = (counts == 0).nonzero().flatten()
        if empty.numel():  # sklearn's _relocate_empty_clusters_dense
            far = ((x - centers[labels]) ** 2).sum(-1).topk(empty.numel()).indices
            for c, i in zip(empty.tolist(), far.tolist()):
                old = int(labels[i])
                sums[old] -= x[i]
                counts[old] -= 1
                sums[c] = x[i]
                counts[c] = 1
        # sklearn's _average_centers divides only where a cluster has weight.
        new = torch.where(counts[:, None] > 0, sums / counts.clamp(min=1)[:, None], sums)
        shift = float(((new - centers) ** 2).sum())
        centers = new
        if labels_old is not None and torch.equal(labels, labels_old):
            strict = True
            break
        if shift <= tol:
            break
        labels_old = labels
    if not strict:
        labels = _sq_dist(x, centers).argmin(1)
    return labels, centers


def _gaussian_parameters(x, resp, reg_covar):
    nk = resp.sum(0) + 10 * torch.finfo(resp.dtype).eps
    means = (resp.T @ x) / nk[:, None]
    covariances = (resp.T @ (x * x)) / nk[:, None] - means ** 2 + reg_covar
    return nk, means, covariances


def _weighted_log_prob(x, weights, means, covariances):
    """(N, K) log densities plus log weights: sklearn's diagonal
    ``_estimate_log_gaussian_prob`` through its precisions."""
    prec_chol = 1.0 / torch.sqrt(covariances)
    precisions = prec_chol ** 2
    log_prob = (torch.sum(means ** 2 * precisions, 1) - 2.0 * (x @ (means * precisions).T)
                + (x ** 2 @ precisions.T))
    return -0.5 * (x.shape[1] * math.log(2 * math.pi) + log_prob) + torch.log(prec_chol).sum(1) \
        + torch.log(weights)


def _e_step(x, weights, means, covariances):
    """(mean log-likelihood, log responsibilities (N, K))."""
    weighted = _weighted_log_prob(x, weights, means, covariances)
    norm = torch.logsumexp(weighted, dim=1)
    return norm.mean(), weighted - norm[:, None]


def gaussian_mixture_diag(x: torch.Tensor, labels: torch.Tensor, n_components: int,
                          reg_covar: float = 1e-4, tol: float = 1e-3, max_iter: int = 100):
    """sklearn's diagonal ``GaussianMixture`` EM from hard labels (its
    k-means init) on x (N, D) -> (weights (K,), means (K, D), covariances
    (K, D), n_iter, converged)."""
    resp = torch.nn.functional.one_hot(labels, n_components).to(x.dtype)
    weights, means, covariances = _gaussian_parameters(x, resp, reg_covar)
    weights = weights / x.shape[0]
    lower_bound = -math.inf
    converged = False
    for n_iter in range(1, max_iter + 1):
        prev = lower_bound
        log_norm, log_resp = _e_step(x, weights, means, covariances)
        weights, means, covariances = _gaussian_parameters(x, torch.exp(log_resp), reg_covar)
        weights = weights / weights.sum()
        lower_bound = float(log_norm)
        if abs(lower_bound - prev) < tol:
            converged = True
            break
    return weights, means, covariances, n_iter, converged


def fit_gmm_init(latents: torch.Tensor, n_components: int, seed: int = 0,
                 max_rows: int = 100_000) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mixture prior's init from the first ``max_rows`` latents (float64
    on their device): (means (K, D), log-variances (K, D))."""
    x = latents[:max_rows].to(torch.float64)
    generator = torch.Generator(device=x.device).manual_seed(seed)
    labels, _ = kmeans(x, n_components, generator)
    _, means, covariances, _, _ = gaussian_mixture_diag(x, labels, n_components)
    return means, torch.log(covariances)
