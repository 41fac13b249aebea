"""Gaussian HMMs and Markov state models for soft-count extraction (port of
``deepof_tpu/msm.py``).

- A diagonal-covariance Gaussian HMM trained by log-space forward-backward
  EM, batched over sequences: each EM iteration is one launch of the HMM
  recursion kernel over all sequences (``ops/hmm_kernels.py``) and a pooled
  M-step in torch on the device, with no host read until the fit ends.
- The MSM pipeline: standardise, k-means microstates
  (``cluster.MiniBatchKMeans``), a lagged transition matrix counted on the
  device, PCCA+ coarse-graining, the membership decode.
- The sticky-HMM extractor of contrastive embeddings
  (``get_contrastive_soft_counts``): diagonal-GMM emissions, a sticky
  transition matrix, AIC/BIC state selection, optional per-frame priors.

On the host, as in the JAX package: numpy's seeded draws, and the small
eigenproblems of PCCA+ and the stationary distribution (n_micro x n_micro),
in float64 with numpy's ``eig`` and ``pinv``. Entry points take ``device``
(default "cuda"; without a GPU they raise unless given "cpu"); each
recording's posteriors come back in one host copy.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from deepof_tpu_torch.cluster import GaussianMixture, MiniBatchKMeans
from deepof_tpu_torch.core.storage import get_dt, save_dt
from deepof_tpu_torch.device import fetch_together, resolve_device, to_device
from deepof_tpu_torch.ops.hmm_kernels import forward_backward
from deepof_tpu_torch.ops.scaling import StandardScaler

# --------------------------------------------------------------------------- #
# Gaussian HMM (diagonal covariance), log-space EM
# --------------------------------------------------------------------------- #


def _log_gaussian(x: torch.Tensor, means: torch.Tensor, log_vars: torch.Tensor) -> torch.Tensor:
    """(..., T, D) observations vs (K, D) diagonal Gaussians -> (..., T, K)
    log densities."""
    diff = x[..., None, :] - means
    return -0.5 * torch.sum(math.log(2 * math.pi) + log_vars + diff ** 2 * torch.exp(-log_vars), dim=-1)


def _forward_backward(log_b, log_pi, log_a, with_xi: bool = True):
    """Batched ``_forward_backward`` (``deepof_tpu/msm.py:39``): log_b (N, T, K)
    -> (gamma (N, T, K), xi_sum (N, K, K) or None, log-likelihoods (N,)),
    the recursions through the kernel on a CUDA tensor."""
    return forward_backward(log_b.contiguous(), log_pi.contiguous(), log_a.contiguous(), with_xi)


def _hmm_em(x, means, log_vars, log_pi, log_a, n_iter: int):
    """``n_iter`` EM iterations over equal-length sequences x (N, T, D):
    the updated (means, log_vars, log_pi, log_a) and the (n_iter,)
    log-likelihoods, all on x's device."""
    lls = []
    for _ in range(n_iter):
        gamma, xi, ll = _forward_backward(_log_gaussian(x, means, log_vars), log_pi, log_a)
        gsum = gamma.sum(dim=(0, 1))
        gx = torch.einsum("ntk,ntd->kd", gamma, x)
        means = gx / torch.clamp(gsum[:, None], min=1e-8)
        gx2 = torch.einsum("ntk,ntd->kd", gamma, x ** 2)
        var = gx2 / torch.clamp(gsum[:, None], min=1e-8) - means ** 2
        log_vars = torch.log(torch.clamp(var, min=1e-5))
        new_pi = torch.clamp(gamma[:, 0].mean(0), min=1e-8)
        log_pi = torch.log(new_pi / new_pi.sum())
        a = xi.sum(0)
        a = a / torch.clamp(a.sum(1, keepdim=True), min=1e-8)
        log_a = torch.log(torch.clamp(a, min=1e-8))
        lls.append(ll.sum())
    return means, log_vars, log_pi, log_a, torch.stack(lls) if lls else x.new_zeros(0)


class GaussianHMM:
    """Diagonal-covariance Gaussian HMM trained with batched log-space EM.

    ``params`` are numpy arrays (means, log_vars, log_pi, log_a), so that a
    pickled model carries no device tensors; they go to ``device`` for each
    call."""

    def __init__(self, n_states: int, n_iter: int = 50, seed: int = 0, device="cuda"):
        self.n_states = n_states
        self.n_iter = n_iter
        self.seed = seed
        self.device = device
        self.params = None

    def _dev(self) -> torch.device:
        return resolve_device(self.device)

    def _tensors(self):
        dev = self._dev()
        return tuple(torch.as_tensor(p, device=dev) for p in self.params)

    def fit(self, x) -> "GaussianHMM":
        """x: (N, T, D) batch of sequences."""
        x = to_device(x, self._dev(), torch.float32)
        n, t, d = x.shape
        k = self.n_states
        rng = np.random.default_rng(self.seed)
        flat = x.reshape(-1, d)
        init_idx = rng.choice(len(flat), size=k, replace=False)
        means = flat[torch.as_tensor(init_idx, device=x.device)]
        log_vars = torch.log(flat.var(0, correction=0) + 1e-3)[None].repeat(k, 1)
        log_pi = torch.log(torch.ones(k, dtype=torch.float32, device=x.device) / k)
        off = 0.1 / max(k - 1, 1)
        log_a = torch.log(torch.as_tensor(np.full((k, k), off) + np.eye(k) * (0.9 - off), dtype=torch.float32,
                                          device=x.device))
        *params, lls = _hmm_em(x, means, log_vars, log_pi, log_a, self.n_iter)
        *params, lls = fetch_together([*params, lls])
        self.params = tuple(params)
        self.log_likelihoods_ = lls
        return self

    def log_probability(self, x) -> float:
        m, lv, lp, la = self._tensors()
        x = to_device(x, m.device, torch.float32)
        _, _, ll = _forward_backward(_log_gaussian(x, m, lv), lp, la, with_xi=False)
        return float(ll.sum())

    def predict_proba(self, seq, log_bias: Optional[np.ndarray] = None) -> np.ndarray:
        """State posteriors of one sequence (T, D) -> (T, K).

        ``log_bias`` (T, K) is added to the log emissions before smoothing
        (the prior-biased decode: log_emiss += prior_weight * log(P))."""
        return self._decode([seq], [log_bias])[0]

    def _decode(self, seqs: List, log_biases: List) -> List[np.ndarray]:
        """Posteriors of several sequences: those of one length share one
        launch; all come back in one host copy."""
        m, lv, lp, la = self._tensors()
        groups: Dict[int, List[int]] = {}
        for i, s in enumerate(seqs):
            groups.setdefault(int(np.shape(s)[0]), []).append(i)
        out = [None] * len(seqs)
        for idx in groups.values():
            x = torch.stack([to_device(seqs[i], m.device, torch.float32) for i in idx])
            log_b = _log_gaussian(x, m, lv)
            bias = [log_biases[i] for i in idx]
            if any(b is not None for b in bias):
                log_b = log_b + torch.stack([to_device(b, m.device, torch.float32) if b is not None
                                             else torch.zeros_like(log_b[0]) for b in bias])
            gamma, _, _ = _forward_backward(log_b, lp, la, with_xi=False)
            for j, i in enumerate(idx):
                out[i] = gamma[j]
        return fetch_together(out)

    def n_params(self, d: int) -> int:
        k = self.n_states
        return k * (2 * d) + k * (k - 1)

    def __getstate__(self):
        state = dict(self.__dict__)
        if state.get("params") is not None:
            state["params"] = tuple(np.asarray(p) for p in state["params"])
        return state

    def __setstate__(self, state):
        params = state.get("params")
        if params is not None and not all(isinstance(p, np.ndarray) for p in params):
            raise TypeError("not a deepof_tpu_torch GaussianHMM pickle: its parameters are not numpy arrays "
                            "(a JAX package pickle holds jax arrays and is not read, ROADMAP queue 3)")
        self.__dict__.update(state)


def _sequences(embeddings) -> Dict[str, np.ndarray]:
    return {k: np.asarray(get_dt(embeddings, k), np.float32) for k in embeddings.keys()}


def _stack_prefix(seqs) -> np.ndarray:
    min_t = min(s.shape[0] for s in seqs)
    return np.stack([s[:min_t] for s in seqs])


def fit_hmm_range(
    embeddings: Dict[str, np.ndarray],
    states: str = "bic",
    min_states: int = 2,
    max_states: int = 15,
    n_iter: int = 30,
    device="cuda",
) -> Tuple[GaussianHMM, list]:
    """Fit HMMs across a state range, select by AIC/BIC (every sequence cut
    to the shortest, as the JAX package does)."""
    seqs = [np.asarray(v, np.float32) for v in embeddings.values()]
    d = seqs[0].shape[1]
    x = to_device(_stack_prefix(seqs), resolve_device(device), torch.float32)
    n_obs = x.shape[0] * x.shape[1]
    scores, best, best_score = [], None, np.inf
    for k in range(min_states, max_states + 1):
        model = GaussianHMM(k, n_iter=n_iter, device=device).fit(x)
        ll = model.log_probability(x)
        p = model.n_params(d)
        score = 2 * p - 2 * ll if states == "aic" else p * np.log(n_obs) - 2 * ll
        scores.append(score)
        if score < best_score:
            best, best_score = model, score
    return best, scores


def _align_prior(p, t: int, k: int, min_confidence: Optional[float], eps: float = 1e-12) -> np.ndarray:
    """A (T', K) per-frame prior aligned to T rows: shorter priors padded
    with uniform rows, longer ones truncated, rows clipped and renormalised,
    rows whose max <= ``min_confidence`` replaced by 1/K."""
    p = np.asarray(p, np.float64)
    if p.ndim != 2:
        raise ValueError(f"soft-count priors must be (T, K); got {p.shape}")
    if p.shape[1] != k:
        raise ValueError(f"K mismatch: prior has {p.shape[1]} states, expected {k}")
    if p.shape[0] < t:
        p = np.vstack([p, np.full((t - p.shape[0], k), 1.0 / k)])
    elif p.shape[0] > t:
        p = p[:t]
    p = np.maximum(p, eps)
    p = p / p.sum(axis=1, keepdims=True)
    if min_confidence is not None:
        low = p.max(axis=1) <= float(min_confidence)
        p[low] = 1.0 / k
    return p


def _prior_k(soft_counts, keys) -> int:
    k0 = next((k for k in keys if k in soft_counts), None)
    if k0 is None:
        raise ValueError("soft_counts provided but no keys overlap with embeddings")
    return int(np.asarray(get_dt(soft_counts, k0)).shape[1])


def get_soft_counts_hmm(
    embeddings,
    states="bic",
    min_states: int = 2,
    max_states: int = 15,
    n_states: Optional[int] = None,
    soft_counts: Optional[Dict[str, np.ndarray]] = None,
    min_confidence: Optional[float] = 0.75,
    prior_weight: float = 1.0,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """Per-experiment HMM state posteriors as soft counts.

    With ``soft_counts`` priors, K is the priors' width (no state
    selection), rows with max prior <= ``min_confidence`` fall back to
    uniform, and the decode adds ``prior_weight * log(prior)`` to the log
    emissions."""
    seqs = _sequences(embeddings)
    if soft_counts is not None:
        k_prior = _prior_k(soft_counts, seqs)
        if n_states is not None and int(n_states) != k_prior:
            raise ValueError(f"n_states={n_states} but soft_counts implies K={k_prior}; they must match")
        n_states = k_prior
    if n_states is not None:
        model = GaussianHMM(n_states, device=device).fit(_stack_prefix(list(seqs.values())))
    else:
        model, _ = fit_hmm_range(seqs, states, min_states, max_states, device=device)
    biases = []
    for k, s in seqs.items():
        if soft_counts is not None and k in soft_counts:
            prior = _align_prior(np.asarray(get_dt(soft_counts, k)), s.shape[0], model.n_states, min_confidence)
            biases.append(float(prior_weight) * np.log(prior))
        else:
            biases.append(None)
    return dict(zip(seqs, model._decode(list(seqs.values()), biases)))


# --------------------------------------------------------------------------- #
# MSM + PCCA+
# --------------------------------------------------------------------------- #


def estimate_transition_matrix(dtrajs, n_states: int, lagtime: int = 1, reversible: bool = True) -> np.ndarray:
    """Row-stochastic transition matrix (float64, host) from discrete
    trajectories (tensors or arrays): every trajectory's lagged pairs
    ``(d[t], d[t + lag])`` counted by one ``bincount`` of ``d[t] * n +
    d[t + lag]`` over the trajectories laid end to end (pair starts indexed
    on the host from their lengths), then symmetrised and normalised."""
    trajs = [torch.as_tensor(d).reshape(-1).to(torch.int64) for d in dtrajs]
    trajs = [d for d in trajs if d.numel() > lagtime]
    c = np.zeros(n_states * n_states)
    if trajs:
        flat = torch.cat([d.to(trajs[0].device) for d in trajs])
        ends = np.cumsum([d.numel() for d in trajs])
        src = np.concatenate([np.arange(e - d.numel(), e - lagtime) for d, e in zip(trajs, ends)])
        src = torch.as_tensor(src, device=flat.device)
        c = torch.bincount(flat[src] * n_states + flat[src + lagtime], minlength=n_states * n_states)
        c = c.cpu().numpy().astype(np.float64)
    c = c.reshape(n_states, n_states)
    if reversible:
        c = 0.5 * (c + c.T)
    c += 1e-8
    return c / c.sum(1, keepdims=True)


def stationary_distribution(p: np.ndarray) -> np.ndarray:
    """Stationary distribution of a row-stochastic matrix (left Perron
    eigenvector, normalised to a probability vector)."""
    vals, vecs = np.linalg.eig(p.T)
    pi = np.real(vecs[:, np.argmax(np.real(vals))])
    pi = np.abs(pi)
    return pi / pi.sum()


def coarse_grain_transition(p: np.ndarray, chi: np.ndarray, pi: Optional[np.ndarray] = None) -> np.ndarray:
    """PCCA+ coarse-grained transition matrix
    ``P_c = (chi^T D chi)^{-1} chi^T D P chi`` with ``D = diag(pi)``."""
    if pi is None:
        pi = stationary_distribution(p)
    d = chi * pi[:, None]
    m = chi.T @ d
    return np.linalg.solve(m, d.T @ p @ chi)


def pcca_plus(p: np.ndarray, n_macro: int) -> np.ndarray:
    """PCCA+ fuzzy coarse-graining: micro-to-macro memberships chi
    (n_micro, n_macro), rows summing to 1 (the Deuflhard-Weber inner simplex
    on the dominant eigenvectors)."""
    n = p.shape[0]
    n_macro = min(n_macro, n)
    vals, vecs = np.linalg.eig(p)
    order = np.argsort(-np.real(vals))
    x = np.real(vecs[:, order[:n_macro]])
    x[:, 0] = 1.0
    idx = np.zeros(n_macro, dtype=int)
    d = np.linalg.norm(x - x.mean(0), axis=1)
    idx[0] = int(np.argmax(d))
    ortho = x - x[idx[0]]
    for k in range(1, n_macro):
        norms = np.linalg.norm(ortho, axis=1)
        idx[k] = int(np.argmax(norms))
        v = ortho[idx[k]]
        nv = np.linalg.norm(v)
        if nv > 1e-12:
            ortho = ortho - np.outer(ortho @ v, v) / (nv ** 2)
    a = np.linalg.pinv(x[idx])
    chi = np.clip(x @ a, 0.0, None)
    rs = chi.sum(1, keepdims=True)
    return chi / np.maximum(rs, 1e-12)


def standardize(scaler: StandardScaler, z: torch.Tensor) -> torch.Tensor:
    """sklearn's ``StandardScaler.transform`` of float32 rows: the float64
    mean subtracted and rounded to float32, then the division by the float64
    scale rounded again."""
    z64 = (z.to(torch.float64) - scaler.mean_.to(z.device)).to(torch.float32).to(torch.float64)
    return (z64 / scaler.scale_.to(z.device)).to(torch.float32)


def fit_msm_pcca(
    embeddings: Dict[str, np.ndarray],
    n_macro: int = 10,
    n_micro: int = 200,
    lagtime: int = 3,
    sample_size: int = 200_000,
    random_state: int = 0,
    device="cuda",
):
    """The k-means microstate MSM + PCCA+: {"scaler", "kmeans", "transition",
    "chi"}, the embeddings pooled (subsampled to ``sample_size`` rows by
    ``np.random.default_rng(random_state)``)."""
    dev = resolve_device(device)
    seqs = [to_device(np.asarray(v, np.float32), dev, torch.float32) for v in embeddings.values()]
    pooled = torch.cat(seqs)
    if len(pooled) > sample_size:
        rng = np.random.default_rng(random_state)
        pooled_fit = pooled[torch.as_tensor(rng.choice(len(pooled), sample_size, replace=False), device=dev)]
    else:
        pooled_fit = pooled
    n_micro = min(n_micro, max(n_macro, len(pooled_fit) // 5))
    scaler = StandardScaler().fit(pooled_fit)
    kmeans = MiniBatchKMeans(n_clusters=n_micro, random_state=random_state, n_init=3, device=dev).fit(
        standardize(scaler, pooled_fit))
    dtrajs = [kmeans.predict(standardize(scaler, v)) for v in seqs]
    p = estimate_transition_matrix(dtrajs, n_micro, lagtime=lagtime)
    return {"scaler": scaler, "kmeans": kmeans, "transition": p, "chi": pcca_plus(p, n_macro)}


def _temporal_smooth(p: torch.Tensor, win: int) -> torch.Tensor:
    """Each column's 'same'-mode moving average over ``win`` rows, as
    ``np.convolve(p[:, j], ones(win) / win, mode="same")``: shifted sums of
    the zero-padded rows times 1/win."""
    t = p.shape[0]
    lo = (win - 1) // 2
    pad = torch.cat([p.new_zeros((win - 1 - lo, p.shape[1])), p, p.new_zeros((lo, p.shape[1]))])
    acc = p.new_zeros(p.shape)
    for i in range(win):
        acc = acc + pad[i:i + t] * (1.0 / win)
    return acc


def get_soft_counts_msm(
    embeddings,
    n_components: int = 10,
    n_micro: int = 200,
    lagtime: int = 3,
    temporal_smooth_win: Optional[int] = 3,
    random_state: int = 0,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """Per-experiment MSM/PCCA+ macro-state memberships as soft counts."""
    seqs = _sequences(embeddings)
    model = fit_msm_pcca(seqs, n_macro=n_components, n_micro=n_micro, lagtime=lagtime,
                         random_state=random_state, device=device)
    return decode_msm(model, seqs, temporal_smooth_win)


def decode_msm(model, seqs: Dict[str, np.ndarray], temporal_smooth_win: Optional[int] = 3) -> Dict[str, np.ndarray]:
    """Each sequence's macro-state memberships under a :func:`fit_msm_pcca`
    model: chi of each frame's microstate, smoothed and normalised on the
    model's device, all fetched in one host copy."""
    kmeans = model["kmeans"]
    chi = torch.as_tensor(model["chi"], device=kmeans.cluster_centers_.device)
    out = []
    for z in seqs.values():
        z = to_device(z, chi.device, torch.float32)
        p = chi[kmeans.predict(standardize(model["scaler"], z))]
        if temporal_smooth_win and temporal_smooth_win > 1:
            p = _temporal_smooth(p, temporal_smooth_win)
        out.append((p / torch.clamp(p.sum(1, keepdim=True), min=1e-12)).to(torch.float32))
    return dict(zip(seqs, fetch_together(out)))


# --------------------------------------------------------------------------- #
# Sticky-HMM contrastive extractor
# --------------------------------------------------------------------------- #


class StickyHMM(NamedTuple):
    """A fitted sticky HMM: (K, D) emission means and log variances, (K,) log
    initial probabilities and the (K, K) log transition matrix, float32."""

    means: torch.Tensor
    log_vars: torch.Tensor
    log_pi: torch.Tensor
    log_a: torch.Tensor

    @property
    def k(self) -> int:
        return int(self.means.shape[0])


def fit_sticky_hmm(
    embeddings,
    states="bic",
    min_states: int = 2,
    max_states: int = 25,
    reg_covar: float = 1e-5,
    sample_size: int = 500000,
    random_state: int = 0,
    p_stay: float = 0.95,
    soft_counts: Optional[Dict[str, np.ndarray]] = None,
    device="cuda",
) -> StickyHMM:
    """The model of :func:`get_contrastive_soft_counts`: diagonal-GMM
    emissions fitted on pooled samples (no HMM EM), the sticky transition
    matrix ``A = p_stay*I + (1-p_stay)*1 pi^T``, K from ``states`` (an int,
    or AIC/BIC by the forward log-likelihood over ``min_states`` to
    ``max_states``), or from ``soft_counts``' width when priors are given."""
    keys = list(embeddings.keys())
    if not keys:
        raise ValueError("Embeddings are empty.")
    dev = resolve_device(device)
    seqs = {k: np.asarray(get_dt(embeddings, k), np.float32) for k in keys}

    rows = None
    if hasattr(embeddings, "sample_windows_from_data"):
        per = max(int(sample_size / len(keys)), 1)
        z = np.asarray(embeddings.sample_windows_from_data(n_windows=per, seed=random_state)[0], np.float32)
        if z.ndim > 2:
            z = z.reshape(len(z), -1)
        if len(z):
            rows = to_device(z, dev, torch.float32)
    if rows is None:
        pooled = torch.cat([to_device(s, dev, torch.float32) for s in seqs.values()])
        if len(pooled) > sample_size:
            rng = np.random.default_rng(random_state)
            pooled = pooled[torch.as_tensor(rng.choice(len(pooled), sample_size, replace=False), device=dev)]
        rows = pooled

    def hmm_terms(k: int):
        gm = GaussianMixture(n_components=k, covariance_type="diag", reg_covar=reg_covar, max_iter=200, tol=1e-3,
                             random_state=random_state, init_params="kmeans", device=dev).fit(rows)
        mu, var = gm.means_.to(torch.float32), gm.covariances_.to(torch.float32)
        pi = gm.weights_.to(torch.float64)
        eye = torch.eye(k, dtype=torch.float64, device=dev)
        a = float(p_stay) * eye + (1.0 - float(p_stay)) * (torch.ones((k, 1), dtype=torch.float64, device=dev)
                                                         @ pi[None, :])
        a = torch.clamp(a, min=1e-12)
        a = a / a.sum(1, keepdim=True)
        return (mu, torch.log(torch.clamp(var, min=1e-10)).to(torch.float32),
                torch.log(torch.clamp(pi, min=1e-12)).to(torch.float32), torch.log(a).to(torch.float32))

    d = seqs[keys[0]].shape[1]
    if soft_counts is not None:
        k_prior = _prior_k(soft_counts, keys)
        if isinstance(states, int) and int(states) != k_prior:
            raise ValueError(f"states={states} but soft_counts implies K={k_prior}; they must match")
        k_best = k_prior
    elif isinstance(states, int):
        k_best = int(states)
    else:
        crit = str(states).lower()
        if crit not in ("aic", "bic"):
            raise NotImplementedError('invalid states type; try "aic", "bic" or an int')
        t_total = sum(len(s) for s in seqs.values())
        groups: Dict[int, List[str]] = {}
        for key, s in seqs.items():
            groups.setdefault(len(s), []).append(key)
        stacked = [torch.stack([to_device(seqs[key], dev, torch.float32) for key in g]) for g in groups.values()]
        best_score = k_best = None
        for k in range(max(2, min_states), max(min_states, max_states) + 1):
            mu, lv, lp, la = hmm_terms(k)
            ll = sum(float(_forward_backward(_log_gaussian(x, mu, lv), lp, la, with_xi=False)[2].to(
                torch.float64).sum()) for x in stacked)
            p = 2 * k * d + (k - 1)
            score = 2 * p - 2 * ll if crit == "aic" else p * np.log(max(t_total, 1)) - 2 * ll
            if best_score is None or score < best_score:
                best_score, k_best = score, k

    return StickyHMM(*hmm_terms(k_best))


def sticky_hmm_posteriors(
    model: StickyHMM,
    embeddings,
    soft_counts: Optional[Dict[str, np.ndarray]] = None,
    min_confidence: Optional[float] = 0.75,
    prior_weight: float = 1.0,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """{key: (T, K) posteriors} of each recording under ``model``: the
    Gaussian log densities, plus ``prior_weight`` times the log of a
    per-frame prior where ``soft_counts`` has the key, smoothed by
    forward-backward through the kernel."""
    dev = resolve_device(device)
    mu, lv, lp, la = (t.to(dev) for t in model)
    pending = []
    keys = list(embeddings.keys())
    for key in keys:
        s = to_device(np.asarray(get_dt(embeddings, key), np.float32), dev, torch.float32)
        log_b = _log_gaussian(s, mu, lv)
        if soft_counts is not None and key in soft_counts:
            prior = _align_prior(np.asarray(get_dt(soft_counts, key)), s.shape[0], model.k, min_confidence)
            log_b = log_b + torch.as_tensor(float(prior_weight) * np.log(prior), dtype=torch.float32, device=dev)
        pending.append(_forward_backward(log_b[None], lp, la, with_xi=False)[0][0])
    return {str(key): g for key, g in zip(keys, fetch_together(pending))}


def get_contrastive_soft_counts(
    coordinates,
    embeddings,
    states="bic",
    min_states: int = 2,
    max_states: int = 25,
    reg_covar: float = 1e-5,
    sample_size: int = 500000,
    random_state: int = 0,
    p_stay: float = 0.95,
    soft_counts: Optional[Dict[str, np.ndarray]] = None,
    min_confidence: Optional[float] = 0.75,
    prior_weight: float = 1.0,
    device="cuda",
):
    """Sticky-HMM soft counts for contrastive embeddings: the model of
    :func:`fit_sticky_hmm` (diagonal-GMM emissions fitted on pooled samples,
    a sticky transition matrix, AIC/BIC state selection) and the posteriors
    of :func:`sticky_hmm_posteriors` (optional per-frame priors with
    confidence gating, forward-backward smoothing through the kernel).

    Returns a TableDict of (T, K) posteriors when ``coordinates`` is given
    (for a very large project, pointers to
    ``{project}/Tables/{key}/{key}_soft_counts``), else a plain dict."""
    model = fit_sticky_hmm(embeddings, states=states, min_states=min_states, max_states=max_states,
                           reg_covar=reg_covar, sample_size=sample_size, random_state=random_state,
                           p_stay=p_stay, soft_counts=soft_counts, device=device)
    out = sticky_hmm_posteriors(model, embeddings, soft_counts=soft_counts, min_confidence=min_confidence,
                                prior_weight=prior_weight, device=device)
    if coordinates is None:
        return out

    from deepof_tpu_torch.core.table_dict import TableDict

    saved = {key: save_dt(counts, os.path.join(coordinates._table_path, key, f"{key}_soft_counts"),
                          coordinates._very_large_project)
             for key, counts in out.items()}
    return TableDict(saved, typ="unsupervised_counts", table_path=coordinates._table_path,
                     exp_conditions=coordinates.get_exp_conditions)
