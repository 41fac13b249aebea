"""SMOTE, the resampled classifier and the small estimator plumbing the
cluster detectors stand on (port of ``deepof_tpu/legacy_compat.py``:
``SimpleSMOTE`` :20, ``ResampledClassifier`` :72 and the pickle shims), with
sklearn's ``Pipeline``, ``StandardScaler`` and ``clone`` restated for them:
the machine with the card has no sklearn.

Rows travel as float64 tensors on the estimator's device; a numpy input
gives numpy results and a tensor input tensors on that device. The pickle
shims rebuild estimators pickled against sklearn and imblearn, so they
import sklearn (lazily, on the host) and raise an ImportError naming it
where it is missing.
"""

from __future__ import annotations

import pickle
from typing import Any, Optional

import numpy as np
import torch

from deepof_tpu_torch.device import host_array, resolve_device

# Values (rows x rows) of one block of the neighbour search.
NEIGHBOUR_BLOCK_ELEMENTS = 1 << 25


def _as_tensor(x, dev: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dev, torch.float64)
    return torch.as_tensor(np.asarray(host_array(x), np.float64), device=dev)


def _like(out: torch.Tensor, ref):
    return out if isinstance(ref, torch.Tensor) else out.cpu().numpy()


def clone(estimator):
    """sklearn's ``clone``: a new, unfitted estimator of the same type from
    ``get_params(deep=False)``, nested estimators (and a pipeline's steps)
    cloned in turn."""
    if estimator is None:
        return None
    if not hasattr(estimator, "get_params"):
        raise TypeError(f"cannot clone {estimator!r}: it has no get_params")

    def copy(value):
        if hasattr(value, "get_params") and not isinstance(value, type):
            return clone(value)
        if isinstance(value, list) and value and all(isinstance(v, tuple) and len(v) == 2 for v in value):
            return [(name, clone(step)) for name, step in value]
        return value

    return type(estimator)(**{k: copy(v) for k, v in estimator.get_params(deep=False).items()})


def kneighbors(x: torch.Tensor, k: int) -> torch.Tensor:
    """(n, k) indices of each row's k nearest rows of ``x`` (itself
    included), nearest first, ties toward the lower index: ranked by
    ``|y|^2 - 2 x.y`` in float64 (sklearn's euclidean ``ArgKmin``, which
    leaves out the row's own norm), blocks of rows at a time."""
    sq = (x * x).sum(dim=1)
    block = max(1, NEIGHBOUR_BLOCK_ELEMENTS // max(1, len(x)))
    out = []
    for lo in range(0, len(x), block):
        dist = sq[None, :] - 2.0 * (x[lo:lo + block] @ x.T)
        out.append(torch.sort(dist, dim=1, stable=True).indices[:, :k])
    return torch.cat(out) if out else torch.zeros((0, k), dtype=torch.int64, device=x.device)


class SimpleSMOTE:
    """Minimal SMOTE: each class short of the majority is topped up with
    points interpolated between a member and one of its k nearest
    same-class neighbours. Draws from ``np.random.default_rng(random_state)``
    in the JAX package's order (a class at a time: the members, the
    neighbours, the gaps); the interpolation runs on ``device``."""

    def __init__(self, k_neighbors: int = 5, random_state: Optional[int] = None, device="cuda"):
        self.k_neighbors = k_neighbors
        self.random_state = random_state
        self.device = device

    def get_params(self, deep: bool = True):
        return {"k_neighbors": self.k_neighbors, "random_state": self.random_state, "device": self.device}

    def fit_resample(self, x, y):
        dev = resolve_device(self.device)
        xt = _as_tensor(x, dev)
        y = np.asarray(host_array(y))
        rng = np.random.default_rng(self.random_state)
        classes, counts = np.unique(y, return_counts=True)
        if len(classes) < 2:
            return _like(xt, x), y
        majority = counts.max()
        xs, ys = [xt], [y]
        for cls, count in zip(classes, counts):
            need = int(majority - count)
            if need <= 0:
                continue
            x_cls = xt[torch.as_tensor(np.flatnonzero(y == cls), device=dev)]
            k = min(self.k_neighbors + 1, len(x_cls))
            if k < 2:
                idx = rng.integers(0, len(x_cls), size=need)
                xs.append(x_cls[torch.as_tensor(idx, device=dev)])
                ys.append(np.full(need, cls, dtype=y.dtype))
                continue
            neigh = kneighbors(x_cls, k)[:, 1:]
            base = rng.integers(0, len(x_cls), size=need)
            col = rng.integers(0, neigh.shape[1], size=need)
            gap = torch.as_tensor(rng.random((need, 1)), device=dev)
            base_t = torch.as_tensor(base, device=dev)
            pick = neigh[base_t, torch.as_tensor(col, device=dev)]
            start = x_cls[base_t]
            xs.append(start + gap * (x_cls[pick] - start))
            ys.append(np.full(need, cls, dtype=y.dtype))
        return _like(torch.cat(xs), x), np.concatenate(ys)


class ResampledClassifier:
    """A classifier that resamples (X, y) inside ``fit`` before training
    (``deepof_tpu/legacy_compat.py:72``): fitted ``estimator_``,
    ``resampler_`` and ``classes_``, prediction delegated to the fitted
    estimator."""

    def __init__(self, estimator=None, resampler: Optional[Any] = None):
        self.estimator = estimator
        self.resampler = resampler

    def get_params(self, deep: bool = True):
        return {"estimator": self.estimator, "resampler": self.resampler}

    def fit(self, x, y):
        self.estimator_ = clone(self.estimator)
        if self.resampler is None:
            xr, yr = x, np.asarray(host_array(y))
        else:
            self.resampler_ = clone(self.resampler)
            xr, yr = self.resampler_.fit_resample(x, y)
        self.estimator_.fit(xr, yr)
        self.classes_ = getattr(self.estimator_, "classes_", np.unique(yr))
        return self

    def predict(self, x):
        return self.estimator_.predict(x)

    def predict_proba(self, x):
        return self.estimator_.predict_proba(x)


class StandardScaler:
    """sklearn's ``StandardScaler`` (with mean and std): per-column float64
    means and variances over the non-NaN rows, the variance with sklearn's
    correction term (``_incremental_mean_and_var``), ddof 0; a column
    indistinguishable from a constant is scaled by 1 (``posthoc._standard_scale``'s
    rule); NaNs pass through."""

    def __init__(self, device="cuda"):
        self.device = device

    def get_params(self, deep: bool = True):
        return {"device": self.device}

    def fit(self, x, y=None) -> "StandardScaler":
        dev = resolve_device(self.device)
        xt = _as_tensor(x, dev)
        nan = torch.isnan(xt)
        n = (~nan).sum(dim=0).to(torch.float64)
        filled = torch.where(nan, 0.0, xt)
        mean = filled.sum(dim=0) / n
        temp = torch.where(nan, 0.0, xt - mean)
        correction = temp.sum(dim=0)
        var = ((temp * temp).sum(dim=0) - correction * correction / n) / n
        eps = torch.finfo(torch.float64).eps
        constant = var <= n * eps * var + (n * mean * eps) ** 2
        self._mean, self._scale = mean, torch.where(constant, 1.0, torch.sqrt(var))
        return self

    def transform(self, x):
        xt = _as_tensor(x, self._mean.device)
        return _like((xt - self._mean) / self._scale, x)

    def fit_transform(self, x, y=None):
        return self.fit(x, y).transform(x)


class Pipeline:
    """sklearn's ``Pipeline`` over named steps: every step but the last
    transforms, the last predicts; ``named_steps`` by name."""

    def __init__(self, steps):
        self.steps = list(steps)

    def get_params(self, deep: bool = True):
        return {"steps": self.steps}

    @property
    def named_steps(self) -> dict:
        return dict(self.steps)

    def _transform(self, x):
        for _, step in self.steps[:-1]:
            x = step.transform(x)
        return x

    def fit(self, x, y) -> "Pipeline":
        for _, step in self.steps[:-1]:
            x = step.fit_transform(x, y)
        self.steps[-1][1].fit(x, y)
        return self

    def predict(self, x):
        return self.steps[-1][1].predict(self._transform(x))

    def predict_proba(self, x):
        return self.steps[-1][1].predict_proba(self._transform(x))

    @property
    def classes_(self):
        return self.steps[-1][1].classes_


# --------------------------------------------------------------------------- #
# Pickle shims (host only: they rebuild sklearn objects)
# --------------------------------------------------------------------------- #

_SHIMS = {
    ("imblearn.pipeline", "Pipeline"): ("sklearn.pipeline", "Pipeline"),
    ("imblearn.over_sampling._smote.base", "SMOTE"): (__name__, "SimpleSMOTE"),
    ("imblearn.over_sampling", "SMOTE"): (__name__, "SimpleSMOTE"),
    ("deepof.legacy_smote_handling", "SimpleSMOTE"): (__name__, "SimpleSMOTE"),
    ("deepof.legacy_smote_handling", "ResampledClassifier"): (__name__, "ResampledClassifier"),
}


def _require_sklearn() -> None:
    try:
        import sklearn  # noqa: F401
    except ImportError as e:
        raise ImportError("loading a legacy pickle needs scikit-learn (sklearn), which is not installed") from e


class _CompatUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        target = _SHIMS.get((module, name))
        if target is not None:
            module, name = target
        return super().find_class(module, name)


def load_pickle_compat(path: str) -> Any:
    """Unpickle with the legacy-class shims (``legacy_smote_handling.py:74-94``)."""
    _require_sklearn()
    with open(path, "rb") as f:
        return _CompatUnpickler(f).load()
