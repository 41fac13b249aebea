"""Embedding-quality metrics and the bootstrap BIC scan of Gaussian
mixtures (port of ``deepof_tpu/evaluation.py``: ``gmm_compute`` :17,
``gmm_model_selection`` :32, ``_total_variance`` :69,
``compute_compactness`` :81, ``_stratified_folds`` :96,
``_average_precision`` :111, ``_fit_logreg_weighted`` :127,
``compute_separability_logreg`` :162, ``compute_knn_agreement`` :217).

Every entry point takes ``device`` (default "cuda"; it raises without a GPU
unless given "cpu"). The arithmetic runs on the device: compactness and
the class-balanced Newton/IRLS logistic fit in float64 (the JAX package
casts to float64 and runs with x64 on), the kNN agreement in float32 with
the similarity product in full float32. The random draws (bootstrap rows,
subsamples, folds) are numpy's on the host, in the JAX package's order, and
the average precision ranks scores with numpy's stable argsort on the host
(one copy of the scores a fold).

The kNN similarities are float32 dot products summed feature by feature
in elementwise operations (the embedding is a few dimensions wide), of
rows normalised in float64, which round alike on every device: a matrix
product sums in its library's order, and the card's float32 square root
and division round otherwise than the CPU's; on overlapping windows, whose
embeddings sit a few float32 ulps apart, each moved the neighbour sets
(kNN agreement 5.0e-4, then 7.7e-5 apart card vs CPU on chip_smoke.py's
cohort, NVIDIA H100 80GB HBM3). No matrix product, so no TF32 either. Ties follow ``jax.lax.top_k``:
among equal similarities the lower reference index ranks first. Exact
duplicate rows, which idle stretches of a recording give, hold such ties;
the rule decides which duplicate is dropped as the query's own match.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from deepof_tpu_torch.cluster import GaussianMixture, _feature_sum
from deepof_tpu_torch.device import host_array, resolve_device, to_device

# Queries a kNN similarity block covers, as in the JAX package.
KNN_CHUNK = 4096


def gmm_compute(x, n_components: int, cv_type: str, device="cuda") -> list:
    """Fit one Gaussian mixture (``max_iter=100000``, the k-means init,
    ``random_state=0``) and return [model, BIC on x]."""
    model = GaussianMixture(n_components=n_components, covariance_type=cv_type, max_iter=100000,
                            init_params="kmeans", random_state=0, device=device).fit(x)
    return [model, model.bic(x)]


def gmm_model_selection(
    x,
    n_components_range,
    part_size: int,
    n_runs: int = 100,
    n_cores: int = 0,
    cv_types: Tuple = ("spherical", "tied", "diag", "full"),
    device="cuda",
) -> Tuple[List[list], List[float], object]:
    """Bootstrap BIC scan over covariance types and component counts:
    ``n_runs`` fits a setting, each on ``part_size`` rows drawn with
    replacement by ``np.random.choice`` from numpy's global state (the draw
    of ``DataFrame.sample(part_size, replace=True)``), one draw a run in the
    JAX package's order. Returns (every BIC a setting, the median BICs, the
    first run's model of the setting with the lowest median). ``n_cores``
    is accepted; the fits run in turn on the device."""
    dev = resolve_device(device)
    rows = host_array(x)
    data = to_device(rows, dev, torch.float32 if rows.dtype == np.float32 else torch.float64)
    bic, m_bic = [], []
    lowest_bic, best = np.inf, None
    for cv_type in cv_types:
        for n_components in n_components_range:
            res = []
            for _ in range(n_runs):
                idx = np.random.choice(len(rows), part_size, replace=True)
                res.append(gmm_compute(data[torch.as_tensor(idx, device=dev)], n_components, cv_type, dev))
            bic.append([r[1] for r in res])
            m_bic.append(float(np.median(bic[-1])))
            if m_bic[-1] < lowest_bic:
                lowest_bic = m_bic[-1]
                best = res[0][0]
    return bic, m_bic, best


def _total_variance(z: torch.Tensor) -> float:
    """Sum of the per-dimension unbiased variances (the covariance's trace)
    of a float64 point cloud."""
    if z.shape[0] < 2:
        return float("nan")
    return float(torch.var(z, dim=0, correction=1).sum())


def compute_compactness(z_pos, z_all, eps: float = 1e-12, device="cuda") -> Dict[str, float]:
    """Spread of the positive embeddings, alone and over the whole set's."""
    dev = resolve_device(device)
    tr_p = _total_variance(to_device(z_pos, dev, torch.float64))
    return {"trace_cov_pos": tr_p,
            "trace_cov_pos_norm_global": tr_p / max(eps, _total_variance(to_device(z_all, dev, torch.float64)))}


def _stratified_folds(labels: np.ndarray, n_splits: int, rng: np.random.Generator) -> np.ndarray:
    """A fold id a sample: each class shuffled, then dealt round-robin."""
    fold_of = np.empty(labels.shape[0], dtype=np.int64)
    for cls in np.unique(labels):
        members = rng.permutation(np.flatnonzero(labels == cls))
        fold_of[members] = np.arange(members.size) % n_splits
    return fold_of


def _average_precision(y_true: np.ndarray, score: np.ndarray) -> float:
    """Area under the precision-recall curve (step interpolation), the
    scores ranked from high to low by a stable sort."""
    order = np.argsort(-score, kind="stable")
    hits = y_true[order].astype(np.float64)
    tp = np.cumsum(hits)
    precision = tp / np.arange(1, hits.size + 1)
    n_pos = tp[-1]
    if n_pos == 0:
        return float("nan")
    return float((precision * hits).sum() / n_pos)


def _fit_logreg_weighted(x: torch.Tensor, y: torch.Tensor, l2: float, steps: int = 200) -> torch.Tensor:
    """Class-balanced L2 logistic regression by ``steps`` full Newton steps
    (the intercept unpenalised, a 1e-6 damping of the Hessian), in x's
    dtype on x's device with no host read between steps. Returns the
    (d + 1,) coefficients, the intercept last."""
    n, d = x.shape
    n_pos = y.sum()
    w_pos = n / (2.0 * torch.clamp(n_pos, min=1.0))
    w_neg = n / (2.0 * torch.clamp(n - n_pos, min=1.0))
    sw = torch.where(y > 0.5, w_pos, w_neg)
    xb = torch.cat([x, torch.ones((n, 1), dtype=x.dtype, device=x.device)], dim=1)
    eye = torch.eye(d + 1, dtype=x.dtype, device=x.device)
    reg = l2 * eye
    reg[d, d] = 0.0
    beta = torch.zeros(d + 1, dtype=x.dtype, device=x.device)
    for _ in range(steps):
        p = torch.sigmoid(xb @ beta)
        grad = xb.T @ (sw * (p - y)) + reg @ beta
        h = (xb * (sw * p * (1.0 - p))[:, None]).T @ xb + reg
        beta = beta - torch.linalg.solve(h + 1e-6 * eye, grad)
    return beta


def compute_separability_logreg(
    x,
    y,
    n_splits: int = 5,
    seed: int = 0,
    c: float = 1.0,
    max_train: int = 100_000,
    device="cuda",
) -> Dict[str, float]:
    """Class separability: the average precision of a class-balanced
    logistic regression over stratified folds, features standardised on
    each training fold. Past ``max_train`` rows a class-proportional
    subsample is drawn first. ``x`` may be a host array or a tensor."""
    dev = resolve_device(device)
    yb = (host_array(y) > 0.5).astype(np.int32)
    if yb.min() == yb.max():
        return {"ap_mean": float("nan"), "ap_std": float("nan"), "n_used": 0}

    rng = np.random.default_rng(seed)
    xd = to_device(x, dev, torch.float64)
    if yb.size > max_train:
        keep = []
        for cls in (0, 1):
            members = np.flatnonzero(yb == cls)
            quota = int(round(max_train * members.size / yb.size))
            keep.append(rng.choice(members, size=min(quota, members.size), replace=False))
        idx = rng.permutation(np.concatenate(keep))
        xd, yb = xd[torch.as_tensor(idx, device=dev)], yb[idx]

    fold_of = _stratified_folds(yb, n_splits, rng)
    n_iter = max(25, int(round(25 * np.log10(10 * c + 1))))
    y_dev = torch.as_tensor(yb, dtype=torch.float64, device=dev)
    folds = torch.as_tensor(fold_of, device=dev)
    aps = []
    for f in range(n_splits):
        te, tr = folds == f, folds != f
        xtr = xd[tr]
        mu, sd = xtr.mean(dim=0), xtr.std(dim=0, correction=0) + 1e-12
        beta = _fit_logreg_weighted((xtr - mu) / sd, y_dev[tr], l2=1.0 / c, steps=n_iter)
        score = ((xd[te] - mu) / sd) @ beta[:-1] + beta[-1]
        aps.append(_average_precision(yb[fold_of == f], score.cpu().numpy()))
    return {"ap_mean": float(np.mean(aps)), "ap_std": float(np.std(aps)), "n_used": int(yb.size)}


def _dot_rows(xq: torch.Tensor, ref_t: torch.Tensor) -> torch.Tensor:
    """(q, r) dot products of xq's rows with the columns of ``ref_t`` (d,
    r), summed feature by feature in elementwise float32 operations: the
    same bits on every device."""
    acc = xq[:, 0, None] * ref_t[0][None, :]
    term = torch.empty_like(acc)
    for j in range(1, xq.shape[1]):
        torch.mul(xq[:, j, None], ref_t[j][None, :], out=term)
        acc.add_(term)
    return acc


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    """x's rows over their norms (+ 1e-12), formed in float64 and rounded
    to float32: the same bits on every device (the card's float32 square
    root and division round otherwise than the CPU's)."""
    x64 = x.to(torch.float64)
    norm = torch.sqrt(_feature_sum(lambda j: x64[:, j] * x64[:, j], x.shape[1]))[:, None]
    return (x64 / (norm + 1e-12)).to(torch.float32)


def _neighbour_fraction(sim: torch.Tensor, y_ref: torch.Tensor, n_neigh: int) -> torch.Tensor:
    """(q,) float32 share of positives among each row's ``n_neigh`` most
    similar references less the most similar one, ties ranked lower index
    first (``jax.lax.top_k``): every reference above the ``n_neigh``-th
    similarity, then the lowest-index references equal to it; the dropped
    one is the first maximum (``argmax``)."""
    kth = torch.topk(sim, n_neigh, dim=1).values[:, -1:]
    above = sim > kth
    at = sim == kth
    slots = n_neigh - above.sum(dim=1, keepdim=True, dtype=torch.int32)
    chosen = above | (at & (torch.cumsum(at, dim=1, dtype=torch.int32) <= slots))
    hits = torch.where(chosen, y_ref, 0.0).sum(dim=1) - y_ref[sim.argmax(dim=1)]
    return hits / (n_neigh - 1)


def compute_knn_agreement(
    x,
    y,
    k: int = 25,
    seed: int = 0,
    max_points: int = 50_000,
    max_pos_queries: int = 10_000,
    metric: str = "cosine",
    device="cuda",
) -> Dict[str, float]:
    """The share of positives among each positive query's k nearest
    references (its own nearest match dropped), in float32: cosine
    similarity, or the negative squared euclidean distance up to a per-query
    constant, in blocks of KNN_CHUNK queries. At most ``max_points``
    references and ``max_pos_queries`` queries are drawn."""
    dev = resolve_device(device)
    yb = (host_array(y) > 0.5).astype(np.int32)
    pos = np.flatnonzero(yb == 1)
    n_rows = x.shape[0]
    if pos.size == 0 or n_rows < k + 2:
        return {"k": int(k), "pos_knn_agree_mean": float("nan"), "pos_knn_agree_std": float("nan"),
                "n_ref": 0, "n_pos_queries": 0}

    rng = np.random.default_rng(seed)
    ref = rng.choice(n_rows, size=max_points, replace=False) if n_rows > max_points else np.arange(n_rows)
    queries = rng.choice(pos, size=max_pos_queries, replace=False) if pos.size > max_pos_queries else pos

    xd = to_device(x, dev, torch.float32)
    x_ref = xd[torch.as_tensor(ref, device=dev)]
    y_ref = torch.as_tensor(yb[ref], dtype=torch.float32, device=dev)
    if metric == "cosine":
        x_ref = _unit_rows(x_ref)
    ref_t = x_ref.T.contiguous()
    ref_sq = _feature_sum(lambda j: x_ref[:, j] * x_ref[:, j], x_ref.shape[1])
    n_neigh = min(k + 1, int(x_ref.shape[0]))
    fracs = []
    for start in range(0, queries.size, KNN_CHUNK):
        xq = xd[torch.as_tensor(queries[start:start + KNN_CHUNK], device=dev)]
        if metric == "cosine":
            sim = _dot_rows(_unit_rows(xq), ref_t)
        else:
            sim = 2.0 * _dot_rows(xq, ref_t) - ref_sq[None, :]
        fracs.append(_neighbour_fraction(sim, y_ref, n_neigh))
    frac = torch.cat(fracs).cpu().numpy()
    return {"k": int(k), "pos_knn_agree_mean": float(frac.mean()), "pos_knn_agree_std": float(frac.std()),
            "n_ref": int(ref.size), "n_pos_queries": int(queries.size)}
