"""Kernel SHAP (Lundberg & Lee 2017, the algorithm of
``shap.KernelExplainer``) over a weighted k-means background (port of
``deepof_tpu/shap_kernel.py``: ``BackgroundData`` :33,
``kmeans_background`` :44, ``_shapley_kernel_weight`` :63,
``_build_coalitions`` :68, ``KernelExplainer`` :140).

The estimator solves the Shapley-kernel-weighted least squares

    min_phi  sum_z pi(z) * (f(h_x(z)) - phi_0 - sum_i z_i phi_i)^2
    s.t.     phi_0 = E_bg[f],  sum_i phi_i = f(x) - phi_0

with the interventional value function v(S) = E_bg[f(x_S, bg_!S)], a
weighted mean over the background. Where the sample budget covers all 2^M
- 2 non-trivial coalitions the solution is the exact Shapley values of v.

The coalitions are numpy's on the host, drawn from
``np.random.default_rng(random_state)`` as the JAX package draws them (the
same masks). The model is called with float64 tensors on the explainer's
device (it may return a tensor or a numpy array); the coalition values of
several rows come from one model call, as many (row, coalition) pairs a
call as keep its input under ``SYNTH_ELEMENTS`` values, and the weighted
least squares of every row and output is one ``torch.linalg.solve``: the
system's matrix depends on the coalitions only.
"""

from __future__ import annotations

from itertools import combinations
from math import comb
from typing import Callable, List, Optional, Tuple, Union

import numpy as np
import torch

from deepof_tpu_torch.cluster import KMeans
from deepof_tpu_torch.device import host_array, resolve_device

# Values (rows x background x features) of one model call's synthetic input.
SYNTH_ELEMENTS = 1 << 23


class BackgroundData:
    """A weighted background sample (shap's ``DenseData``): float64 rows
    and weights normalised to sum 1."""

    def __init__(self, data, weights: Optional[np.ndarray] = None):
        self.data = np.asarray(data, float)
        if weights is None:
            weights = np.ones(len(self.data))
        w = np.asarray(weights, float)
        self.weights = w / w.sum()


def kmeans_background(X, k: int, round_values: bool = True, device="cuda") -> BackgroundData:
    """The k-means summary of ``X`` (``shap.kmeans``): the centres of
    ``KMeans(k, n_init=10, random_state=0)``, each coordinate snapped on
    the device to the nearest observed value of its column (the first on a
    tie), weighted by cluster population."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(host_array(X), float), device=dev)
    k = min(int(k), len(x))
    km = KMeans(n_clusters=k, n_init=10, random_state=0, device=dev).fit(x)
    centers = km.cluster_centers_
    if round_values:
        block = max(1, SYNTH_ELEMENTS // max(1, len(x) * k))
        snapped = []
        for j in range(0, x.shape[1], block):
            cols = x[:, j:j + block]
            nearest = (cols[:, None, :] - centers[None, :, j:j + block]).abs().argmin(dim=0)  # (k, block)
            snapped.append(cols.gather(0, nearest))
        centers = torch.cat(snapped, dim=1)
    weights = torch.bincount(km.labels_, minlength=k).to(torch.float64)
    return BackgroundData(centers.cpu().numpy(), weights.cpu().numpy())


def _shapley_kernel_weight(m: int, s: int) -> float:
    """pi(z) of a coalition of size s out of m features."""
    return (m - 1) / (comb(m, s) * s * (m - s))


def _build_coalitions(m: int, nsamples: int, rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray, bool]:
    """(masks (S, m) bool, kernel weights (S,), exact): every coalition
    where the budget covers them all; else whole subset-size pairs (s, m -
    s) from the outside in while the budget allows, then random masks over
    the remaining sizes, the leftover kernel mass spread over the draws."""
    total = 2 ** m - 2
    if total <= nsamples:
        bits = np.arange(1, 2 ** m - 1)[:, None]
        masks = ((bits >> np.arange(m)[None, :]) & 1).astype(bool)
        weights = np.array([_shapley_kernel_weight(m, int(s)) for s in masks.sum(axis=1)])
        return masks, weights, True

    size_mass = np.array([comb(m, s) * _shapley_kernel_weight(m, s) for s in range(1, m)])
    size_mass = size_mass / size_mass.sum()
    order: List[int] = []
    lo, hi = 1, m - 1
    while lo <= hi:
        order.append(lo)
        if hi != lo:
            order.append(hi)
        lo += 1
        hi -= 1

    masks_list: List[np.ndarray] = []
    weights_list: List[float] = []
    budget = nsamples
    remaining_sizes: List[int] = []
    for s in order:
        n_s = comb(m, s)
        if n_s <= budget - len(remaining_sizes):
            # The size's mass spread over its C(m, s) coalitions, on the
            # scale of the sampled ones.
            w = size_mass[s - 1] / n_s
            for idx in combinations(range(m), s):
                row = np.zeros(m, bool)
                row[list(idx)] = True
                masks_list.append(row)
                weights_list.append(w)
            budget -= n_s
        else:
            remaining_sizes.append(s)
    if remaining_sizes and budget > 0:
        rem_mass = sum(size_mass[s - 1] for s in remaining_sizes)
        probs = np.array([size_mass[s - 1] / rem_mass for s in remaining_sizes])
        sizes = rng.choice(remaining_sizes, size=budget, p=probs)
        w_each = rem_mass / budget
        for s in sizes:
            idx = rng.choice(m, size=int(s), replace=False)
            row = np.zeros(m, bool)
            row[idx] = True
            masks_list.append(row)
            weights_list.append(w_each)
    return np.asarray(masks_list), np.asarray(weights_list), False


class KernelExplainer:
    """``shap.KernelExplainer`` for a model of float64 rows (a single
    output, or several as ``predict_proba`` gives them) over a weighted
    background, ``shap_values(X, nsamples=...)``. The identity link only."""

    def __init__(
        self,
        model: Callable,
        data: Union[np.ndarray, BackgroundData, Tuple[np.ndarray, np.ndarray]],
        normalize: bool = False,
        link: str = "identity",
        device="cuda",
    ):
        if link != "identity":
            raise NotImplementedError("only the identity link is supported")
        self.device = resolve_device(device)
        self.model = model
        if isinstance(data, tuple):
            data = BackgroundData(*data)
        elif not isinstance(data, BackgroundData):
            if hasattr(data, "data") and hasattr(data, "weights"):
                data = BackgroundData(np.asarray(data.data), np.asarray(data.weights))
            else:
                data = BackgroundData(np.asarray(data, float))
        self.bg = data
        self._bg = torch.as_tensor(self.bg.data, device=self.device)
        self._bgw = torch.as_tensor(self.bg.weights, device=self.device)
        out = self._predict(self._bg)
        self._single_output = out.ndim == 1
        expected = self._bgw @ (out[:, None] if self._single_output else out)  # (K,)
        self.expected_value = float(expected[0]) if self._single_output else expected.cpu().numpy()

    def _predict(self, x: torch.Tensor) -> torch.Tensor:
        """The model's outputs on float64 rows, as a float64 tensor on the
        explainer's device."""
        out = self.model(x)
        if isinstance(out, torch.Tensor):
            return out.to(self.device, torch.float64)
        return torch.as_tensor(np.asarray(out, float), device=self.device)

    def shap_values(self, X, nsamples: Union[int, str] = "auto", n_jobs: int = -1, random_state: int = 0):
        """Shapley value estimates for each row of ``X`` (a numpy array, a
        tensor, or anything with ``.values``): (n, M) for a single-output
        model, else a list of (n, M) arrays, one an output. ``n_jobs`` is
        accepted; the rows are batched on the device."""
        X = np.atleast_2d(np.asarray(host_array(X), float))
        n, m = X.shape
        if nsamples == "auto" or nsamples is None:
            nsamples = 2048 + 2 * m
        masks, kweights, _ = _build_coalitions(m, int(nsamples), np.random.default_rng(random_state))
        phis = self._explain(torch.as_tensor(X, device=self.device), torch.as_tensor(masks, device=self.device),
                             torch.as_tensor(kweights, device=self.device)).cpu().numpy()  # (n, m, K)
        if self._single_output:
            return phis[:, :, 0]
        return [phis[:, :, j] for j in range(phis.shape[2])]

    def _coalition_values(self, x: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        """(n, S, K): v(z) = sum_b w_b f(where(z, x, bg_b)) of every row and
        coalition, as many (row, coalition) pairs a model call as
        SYNTH_ELEMENTS allows."""
        n, s, m, b = x.shape[0], masks.shape[0], x.shape[1], self._bg.shape[0]
        per_call = max(1, SYNTH_ELEMENTS // max(b * m, 1))
        out = []
        for lo in range(0, n * s, per_call):
            pair = torch.arange(lo, min(lo + per_call, n * s), device=self.device)
            rows, coal = pair // s, pair % s
            synth = torch.where(masks[coal][:, None, :], x[rows][:, None, :], self._bg[None, :, :]).reshape(-1, m)
            f = self._predict(synth)
            f = f.reshape(len(pair), b, -1)
            out.append(torch.einsum("cbk,b->ck", f, self._bgw))
        return torch.cat(out).reshape(n, s, -1)

    def _explain(self, x: torch.Tensor, masks: torch.Tensor, kweights: torch.Tensor) -> torch.Tensor:
        """(n, m, K) Shapley values: the constrained weighted least squares
        of every row and output, the last feature eliminated by phi_last =
        (f(x) - phi_0) - sum(others), solved at once with a 1e-12 ridge
        (random coalition sets can be rank-deficient)."""
        m = x.shape[1]
        y = self._coalition_values(x, masks)  # (n, S, K)
        fx = self._predict(x)
        fx = fx[:, None] if fx.ndim == 1 else fx  # (n, K)
        fnull = torch.as_tensor(np.atleast_1d(np.asarray(self.expected_value, float)), device=self.device)
        z = masks.to(torch.float64)
        zlast = z[:, -1]
        a = z[:, :-1] - zlast[:, None]  # (S, m - 1)
        rhs = y - fnull - zlast[None, :, None] * (fx - fnull)[:, None, :]  # (n, S, K)
        aw = a * kweights[:, None]
        ata = a.T @ aw
        atb = torch.einsum("sj,nsk->jnk", aw, rhs)  # (m - 1, n, K)
        eye = torch.eye(m - 1, dtype=torch.float64, device=self.device)
        phi_rest = torch.linalg.solve(ata + 1e-12 * eye, atb.reshape(m - 1, -1)).reshape(atb.shape)
        phi_last = (fx - fnull) - phi_rest.sum(dim=0)  # (n, K)
        return torch.cat([phi_rest.permute(1, 0, 2), phi_last[:, None, :]], dim=1)
