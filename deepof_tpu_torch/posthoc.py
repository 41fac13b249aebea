"""Post-hoc statistics over the served embeddings, soft counts and
supervised tags, and the kinematics tables the supervised engine reads
(port of ``deepof_tpu/posthoc.py``: ``_kinematics_table_views`` :76, the
cluster usage statistics :222-421, transitions :423-571, condition
separability :574-736 and HMM reclustering :1114). The gating API and
``get_contrastive_soft_counts`` are re-exported here, where the JAX package
exposes them (:30-38).

Every entry point takes ``device`` (default "cuda"; it raises without a GPU
unless given "cpu"). Each recording's table is uploaded once per call in
float64; hard labels, valid-row masks, per-cluster and transition counts,
NaN-aware means and medians, ROI masks and the per-experiment algebra (PCA,
the standard scaler, the logistic regression, matrix powers) run as tensor
ops on the device, and each call's per-experiment results come back in one
host copy. The KDE draw and the sliced Wasserstein distance run in numpy on
the host, from numpy's seeded streams as the JAX package's do.

Results are numpy arrays with their labels, not DataFrames: a
:class:`Labelled` (values, index, columns) for a per-experiment table, a
dict of named columns for the long-form enrichment table. Row ranges follow
``core.storage``: a bare 2-element ``bin_info`` array is the inclusive span
[start, end]; a dict entry (an array, or a dict's ``"time"``) is always an
array of row indices (the JAX package reads a 2-element one as a span).
"""

from __future__ import annotations

import os
import pickle
import warnings
from typing import Dict, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from deepof_tpu_torch.core.storage import DeviceTable, _slice_obj, _take, get_dt
from deepof_tpu_torch.core.table_dict import TableDict
from deepof_tpu_torch.device import fetch_together, resolve_device
from deepof_tpu_torch.gating import (  # noqa: F401 -- the JAX package's post-hoc names
    add_chaos_gates,
    compute_gate_edges,
    get_contrastive_soft_counts_gmm,
    get_contrastive_soft_counts_msm_pcca,
    get_pairwise_distances,
    get_supervised_chaos,
)
from deepof_tpu_torch.msm import GaussianHMM, fit_hmm_range, get_contrastive_soft_counts, get_soft_counts_hmm  # noqa: F401
from deepof_tpu_torch.utils import (
    filter_columns,
    get_behavior_frames_in_roi,
    get_supervised_behaviors_in_roi,
    get_unsupervised_behaviors_in_roi,
)


def _kinematics_table_views(
    coordinates, views: Sequence[Optional[str]], key: str, center: str = "Center", align: str = "Spine_1",
    distance_pairs=None,
) -> Dict[Optional[str], DeviceTable]:
    """One recording's kinematics table for each animal view (None = every
    animal), from one set of device tables: the bodypart distances (only
    ``distance_pairs`` when given, else every pair) and the body areas with
    the suffix ``_raw``, then the speeds of the coordinates centred on
    ``center`` and aligned on ``align`` with ``_speed``. A view keeps its
    animal's columns (areas by prefix). This is the JAX function at
    ``kin_derivative=1`` with no angles and no feature derivatives."""
    parts = (
        (*coordinates.get_distances_at_key(key, filter_on_graph=False, pairs=distance_pairs, _device=True),
         "_raw", False),
        (*coordinates.get_areas_at_key(key, _device=True), "_raw", True),
        (*coordinates.get_coords_at_key(key, center=center, align=align, speed=1, _device=True), "_speed", False),
    )
    out = {}
    for view in views:
        values, names = [], []
        for arr, cols, suffix, is_areas in parts:
            if view is None:
                keep = list(range(len(cols)))
            elif is_areas:
                keep = [i for i, c in enumerate(cols) if c.startswith(view)]
            else:
                kept = set(filter_columns(cols, view))
                keep = [i for i, c in enumerate(cols) if c in kept]
            values.append(arr[:, keep])
            names += [f"{cols[i]}{suffix}" for i in keep]
        out[view] = DeviceTable(torch.cat(values, dim=1), names)
    return out


# --------------------------------------------------------------------------- #
# Tables on the device
# --------------------------------------------------------------------------- #


class Labelled(NamedTuple):
    """A per-experiment table: float64 ``values`` (n_rows, n_cols), row
    labels ``index`` (experiment ids) and column labels ``columns``."""

    values: np.ndarray
    index: list
    columns: list


def _resolve_range(bin_info, key):
    if isinstance(bin_info, np.ndarray):
        return bin_info
    if isinstance(bin_info, dict):
        entry = bin_info[key]
        return entry["time"] if isinstance(entry, dict) else entry
    return None


class _DeviceTables:
    """The recordings of a TableDict, each uploaded to ``dev`` in float64 on
    first use, with their column labels (None for a bare array)."""

    def __init__(self, tab_dict, dev: torch.device):
        self.tab_dict, self.dev, self._cache = tab_dict, dev, {}

    def keys(self):
        return self.tab_dict.keys()

    def columns(self, key):
        return get_dt(self.tab_dict, key, only_metainfo=True)["columns"]

    def full(self, key) -> torch.Tensor:
        if key not in self._cache:
            self._cache[key] = torch.as_tensor(np.asarray(get_dt(self.tab_dict, key), np.float64), device=self.dev)
        return self._cache[key]

    def rows(self, key, bin_info=None):
        """(rows of the recording, their frame indices or None): a bare
        array is a span, a dict entry an array of row indices."""
        load_range = _resolve_range(bin_info, key)
        if load_range is None:
            return self.full(key), None
        if isinstance(bin_info, dict):
            idx = np.asarray(load_range).astype(np.int64)
            return _take(self.full(key), idx), idx
        table = _slice_obj(self.full(key), load_range)
        if len(load_range) == 2 and len(table) != 2:
            return table, np.arange(int(load_range[0]), int(load_range[1]) + 1)
        return table, np.asarray(load_range)


def _hard_labels(arr: torch.Tensor, nan_wins: bool) -> torch.Tensor:
    """Row argmax, the first maximum winning. ``nan_wins``: a row's first
    NaN is its maximum (``np.argmax``); else NaN counts as -inf."""
    isnan = torch.isnan(arr)
    hard = torch.argmax(torch.where(isnan, -torch.inf, arr), dim=1)
    if nan_wins:
        hard = torch.where(isnan.any(dim=1), torch.argmax(isnan.to(torch.uint8), dim=1), hard)
    return hard


def _nanmedian(x: torch.Tensor) -> torch.Tensor:
    """Column medians skipping NaN, the middle pair averaged (``np.nanmedian``;
    ``torch.nanmedian`` takes the lower one)."""
    s = torch.sort(x, dim=0).values  # NaN sorts last
    n = (~torch.isnan(x)).sum(dim=0)
    lo, hi = ((n - 1).clamp(min=0) // 2)[None], (n // 2)[None]
    med = (s.gather(0, lo) + s.gather(0, hi))[0] / 2
    return torch.where(n > 0, med, torch.nan)


def _standard_scale(x: torch.Tensor) -> torch.Tensor:
    """sklearn's ``StandardScaler().fit_transform``: ddof 0, a feature
    indistinguishable from a constant scaled by 1."""
    n = x.shape[0]
    mean = x.mean(dim=0)
    var = ((x - mean) ** 2).mean(dim=0)
    eps = torch.finfo(torch.float64).eps
    constant = var <= n * eps * var + (n * mean * eps) ** 2
    scale = torch.where(constant, 1.0, torch.sqrt(var))
    return (x - mean) / scale


def _pca2_scaled(x: torch.Tensor) -> torch.Tensor:
    """sklearn's ``Pipeline([PCA(n_components=2), StandardScaler()])``:
    the centred rows projected on the first two right singular vectors,
    each signed so that its largest-magnitude entry is positive
    (``svd_flip(u_based_decision=False)``), then standard-scaled."""
    if min(x.shape) < 2:
        raise ValueError(f"n_components=2 must be between 0 and min(n_samples, n_features)={min(x.shape)}")
    centred = x - x.mean(dim=0)
    vt = torch.linalg.svd(centred, full_matrices=False).Vh[:2]
    signs = torch.sign(vt.gather(1, vt.abs().argmax(dim=1, keepdim=True)))
    return _standard_scale(centred @ (vt * signs).T)


def _plain_condition(value):
    """The first value of a one-row condition table (the port's
    ``ConditionTable`` or a DataFrame), else the value itself."""
    if hasattr(value, "columns"):
        column = value[list(value.columns)[0]]
        return column.iloc[0] if hasattr(column, "iloc") else column[0]
    return value


# --------------------------------------------------------------------------- #
# Cluster usage statistics
# --------------------------------------------------------------------------- #


def _time_on_cluster(tables: _DeviceTables, normalize, reduce_dim, bin_info, roi_number, animals_in_roi):
    keys, counts = list(tables.keys()), []
    for key in keys:
        arr, _ = tables.rows(key, bin_info)
        hard = _hard_labels(arr, nan_wins=False).to(torch.float64)
        hard = torch.where(torch.isnan(arr).all(dim=1), torch.nan, hard)
        if roi_number is not None:
            hard = get_unsupervised_behaviors_in_roi(hard, bin_info[key], animals_in_roi)
        counts.append(torch.bincount(hard[hard >= 0].long(), minlength=arr.shape[1]))
    counts = torch.stack(counts).to(torch.float64)
    present = counts.sum(dim=0) > 0
    if normalize:
        total = counts.sum(dim=1, keepdim=True)
        counts = torch.where(total > 0, counts / total, counts)
    if reduce_dim:
        values, present = fetch_together([_pca2_scaled(counts[:, present]), present])
        return Labelled(values, keys, [0, 1])
    values, present = fetch_together([counts, present])
    return Labelled(values[:, present], keys, [float(c) for c in np.flatnonzero(present)])


def get_time_on_cluster(
    soft_counts, normalize: bool = True, reduce_dim: bool = False, bin_info=None, roi_number=None,
    animals_in_roi=None, device="cuda",
) -> Labelled:
    """Share (or count) of each experiment's frames on each cluster
    (``deepof_tpu/posthoc.py:231``): a frame's cluster is its soft counts'
    argmax (NaN as -inf), all-NaN rows and, with ``roi_number``, frames
    with a requested animal outside the ROI (``bin_info`` entries from
    ``apply_rois_to_bin_info``) left out. Columns are the float ids of the
    clusters that occur in some experiment, sorted; with ``reduce_dim``,
    PCA to 2 components then standard scaling, columns [0, 1]."""
    tables = _DeviceTables(soft_counts, resolve_device(device))
    return _time_on_cluster(tables, normalize, reduce_dim, bin_info, roi_number, animals_in_roi)


def _aggregated_embedding(tables: _DeviceTables, reduce_dim, agg, bin_info, roi_number, animals_in_roi,
                          roi_mode):
    keys, rows, columns = list(tables.keys()), [], None
    for key in keys:
        cur, _ = tables.rows(key, bin_info)
        columns = tables.columns(key)
        if roi_number is not None:
            if columns is not None:
                cur = get_supervised_behaviors_in_roi(cur, columns, bin_info[key], animals_in_roi, roi_mode)
            else:
                cur = get_unsupervised_behaviors_in_roi(cur, bin_info[key], animals_in_roi)
        rows.append(torch.nanmean(cur, dim=0) if agg == "mean" else _nanmedian(cur))
    columns = list(range(len(rows[0]))) if columns is None else list(columns)
    keep = [i for i, c in enumerate(columns) if "distance" not in str(c)]
    values = torch.stack(rows)[:, keep]
    columns = [columns[i] for i in keep]
    complete = ~torch.isnan(values).any(dim=1)
    if reduce_dim:
        out, complete = fetch_together([_pca2_scaled(values[complete]), complete])
        return Labelled(out, [k for k, c in zip(keys, complete) if c], [0, 1])
    values, complete = fetch_together([values, complete])
    return Labelled(values[complete], [k for k, c in zip(keys, complete) if c], columns)


def get_aggregated_embedding(
    embedding, reduce_dim: bool = False, agg: str = "mean", bin_info=None, roi_number=None,
    animals_in_roi=None, roi_mode: str = "mousewise", device="cuda",
) -> Labelled:
    """One row per experiment: the NaN-skipping mean or median of its
    embedding rows over the time bin (``deepof_tpu/posthoc.py:274``). With
    ``roi_number``, rows (or, for a labelled table, detections) outside the
    ROI are NaN first. Columns whose label holds "distance" are dropped,
    then experiments with a NaN; ``reduce_dim`` as in
    :func:`get_time_on_cluster`."""
    tables = _DeviceTables(embedding, resolve_device(device))
    return _aggregated_embedding(tables, reduce_dim, agg, bin_info, roi_number, animals_in_roi, roi_mode)


# Behaviors reported as continuous traces rather than binary flags
# (deepof_tpu/posthoc.py:328); they are excluded from enrichment counts.
CONTINUOUS_BEHAVIORS = ["distance", "cum-distance", "speed"]


def enrichment_across_conditions(
    embedding=None,
    soft_counts=None,
    supervised_annotations=None,
    exp_conditions: dict = None,
    plot_speed: bool = False,
    bin_info=None,
    normalize: bool = False,
    roi_number=None,
    animals_in_roi=None,
    roi_mode: str = "mousewise",
    custom_continuous_behavior_names: list = (),
    device="cuda",
) -> Dict[str, np.ndarray]:
    """Long-form usage of each cluster (soft counts) or behavior
    (supervised tags) per experiment with its condition
    (``deepof_tpu/posthoc.py:331``): named columns ``exp_id``, ``exp
    condition``, ``cluster`` and ``time on cluster``, cluster-major. A
    behavior's usage is its tag sum over the bin (NaN skipped), divided by
    the bin's frames with ``normalize`` or ``plot_speed``; continuous
    behaviors are left out (with ``plot_speed``, only the speeds are kept).
    ``cluster`` is float when the first cluster is 0, else str."""
    dev = resolve_device(device)
    if supervised_annotations is not None:
        tables = _DeviceTables(supervised_annotations, dev)
        keys, sums, names = list(tables.keys()), [], []
        drop = tuple(CONTINUOUS_BEHAVIORS) + tuple(custom_continuous_behavior_names)
        for key in keys:
            tab, _ = tables.rows(key, bin_info)
            cols = tables.columns(key)
            cols = list(range(tab.shape[1])) if cols is None else list(cols)
            if roi_number is not None:
                tab = get_supervised_behaviors_in_roi(tab, cols, bin_info[key], animals_in_roi, roi_mode)
            selected = [i for i, c in enumerate(cols) if (str(c).endswith("speed") if plot_speed
                                                           else not str(c).endswith(drop))]
            names.append([cols[i] for i in selected])
            total = torch.nansum(tab[:, selected], dim=0)
            sums.append(total / len(tab) if normalize or plot_speed else total)
        columns = names[0] if all(n == names[0] for n in names) else sorted({c for n in names for c in n})
        table = torch.full((len(keys), len(columns)), torch.nan, dtype=torch.float64, device=dev)
        for i, (n, total) in enumerate(zip(names, sums)):  # as pandas aligns the rows: a union, NaN-filled
            table[i, [columns.index(c) for c in n]] = total
        counts = Labelled(fetch_together([table])[0], keys, columns)
    else:
        counts = get_time_on_cluster(soft_counts, normalize=normalize, bin_info=bin_info, roi_number=roi_number,
                                     animals_in_roi=animals_in_roi, device=device)
    conditions = exp_conditions or {}
    n_exp, n_cols = counts.values.shape
    clusters = list(counts.columns)
    if clusters and clusters[0] == 0:
        cluster = np.repeat(np.asarray(clusters, np.float64), n_exp)
    else:
        cluster = np.repeat(np.asarray([str(c) for c in clusters], dtype=object), n_exp)
    return {
        "exp_id": np.asarray(list(counts.index) * n_cols, dtype=object),
        "exp condition": np.asarray([str(_plain_condition(conditions.get(k))) for k in counts.index] * n_cols,
                                    dtype=object),
        "cluster": cluster,
        "time on cluster": counts.values.T.reshape(-1),
    }


# --------------------------------------------------------------------------- #
# Transitions
# --------------------------------------------------------------------------- #


def _transition_counts(hard: torch.Tensor, n_states: int, index_sequence=None) -> torch.Tensor:
    """(n_states, n_states) float64 counts of consecutive label pairs, a pair
    skipped where the frame indices are not adjacent."""
    if len(hard) < 2:
        return torch.zeros((n_states, n_states), dtype=torch.float64, device=hard.device)
    pairs = hard[:-1] * n_states + hard[1:]
    if index_sequence is not None:
        idx = torch.as_tensor(np.asarray(index_sequence), device=hard.device)
        pairs = pairs[(idx[1:] - idx[:-1]) == 1]
    return torch.bincount(pairs, minlength=n_states * n_states).to(torch.float64).reshape(n_states, n_states)


def get_transitions(state_sequence, n_states: int, index_sequence=None, device="cuda") -> np.ndarray:
    """Transition counts of a hard state sequence
    (``deepof_tpu/posthoc.py:423``); with ``index_sequence`` (the frames the
    states were taken at), pairs across a gap are skipped."""
    dev = resolve_device(device)
    seq = torch.as_tensor(np.asarray(state_sequence).astype(np.int64), device=dev)
    return _transition_counts(seq, n_states, index_sequence).cpu().numpy()


def cluster_transition_matrix(cluster_sequence, nclusts: int, autocorrelation: bool = True,
                              return_graph: bool = False, device="cuda"):
    """Row-normalised transition matrix of a hard cluster sequence, NaN
    labels dropped (``deepof_tpu/posthoc.py:449``): counts over row sums +
    1e-5, rounded to 3 decimals; with ``autocorrelation``, also the lag-1
    correlation matrix (2, 2) of the sequence. ``return_graph`` gives the
    matrix as a networkx graph (networkx is imported for it)."""
    dev = resolve_device(device)
    seq = torch.as_tensor(np.asarray(cluster_sequence, np.float64), device=dev)
    seq = seq[~torch.isnan(seq)].long()
    trans = _transition_counts(seq, nclusts)
    normed = torch.round(trans / (trans.sum(dim=1, keepdim=True) + 1e-5), decimals=3)
    out = [normed]
    if autocorrelation:
        out.append(torch.corrcoef(torch.stack([seq[:-1], seq[1:]]).to(torch.float64)))
    out = fetch_together(out)
    if return_graph:
        try:
            import networkx as nx
        except ImportError as e:
            raise ImportError("cluster_transition_matrix(return_graph=True) needs the networkx package") from e
        out[0] = nx.Graph(out[0])
    return tuple(out) if autocorrelation else out[0]


def compute_transition_matrix_per_condition(
    soft_counts,
    exp_conditions: dict,
    silence_diagonal: bool = False,
    bin_info=None,
    roi_number=None,
    animals_in_roi=None,
    aggregate: bool = True,
    normalize: bool = True,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """Transition counts per condition (or per experiment without
    ``aggregate``; ``deepof_tpu/posthoc.py:478``): each experiment's hard
    labels (``np.argmax`` of its soft counts, a NaN winning), pairs across
    gaps of the time bin or the ROI skipped, the diagonal zeroed with
    ``silence_diagonal``, summed over the experiments of a condition, then
    row-normalised (0 for an empty row)."""
    tables = _DeviceTables(soft_counts, resolve_device(device))
    matrices: Dict[str, torch.Tensor] = {}
    for key in tables.keys():
        if roi_number is not None:
            idx = get_behavior_frames_in_roi(None, bin_info[key], animals_in_roi).astype(np.int64)
            arr = _take(tables.full(key), idx)
        else:
            arr, idx = tables.rows(key, bin_info)
        trans = _transition_counts(_hard_labels(arr, nan_wins=True), arr.shape[1], idx)
        if silence_diagonal:
            trans.fill_diagonal_(0)
        if aggregate:
            cond = str(_plain_condition(exp_conditions.get(key)))
            matrices[cond] = matrices[cond] + trans if cond in matrices else trans
        else:
            matrices[key] = trans
    if normalize:
        matrices = {k: torch.nan_to_num(v / v.sum(dim=1, keepdim=True)) for k, v in matrices.items()}
    return dict(zip(matrices, fetch_together(list(matrices.values()))))


def compute_steady_state(transition_matrices: Dict[str, np.ndarray], return_entropy: bool = False,
                         n_iters: int = 100000, device="cuda") -> Dict[str, object]:
    """Stationary distribution of each transition matrix
    (``deepof_tpu/posthoc.py:549``): the column sums of its ``n_iters``-th
    power (repeated squaring, float64) over their total; with
    ``return_entropy``, its Shannon entropy (nats) instead."""
    dev = resolve_device(device)
    out = []
    for trans in transition_matrices.values():
        power = torch.linalg.matrix_power(torch.as_tensor(np.asarray(trans, np.float64), device=dev), n_iters)
        steady = torch.nan_to_num(power.sum(dim=0) / power.sum())
        if return_entropy:
            pk = steady / steady.sum()
            steady = torch.special.entr(pk).sum()
        out.append(steady)
    host = fetch_together(out)
    return {k: float(v) if return_entropy else v for k, v in zip(transition_matrices, host)}


# --------------------------------------------------------------------------- #
# Condition separability
# --------------------------------------------------------------------------- #


def _sliced_wasserstein(a: np.ndarray, b: np.ndarray, n_projections: int = 10000, seed: int = 0) -> float:
    """Sliced 2-Wasserstein distance between equal-size samples
    (``deepof_tpu/posthoc.py:652``): the root mean square of the exact 1-D
    distances along ``n_projections`` random unit directions of
    ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    proj = rng.normal(size=(a.shape[1], n_projections))
    proj /= np.maximum(np.linalg.norm(proj, axis=0, keepdims=True), 1e-30)
    pa = np.sort(a @ proj, axis=0)
    pb = np.sort(b @ proj, axis=0)
    return float(np.sqrt(np.mean((pa - pb) ** 2)))


def _kde_sample(data: np.ndarray, n_samples: int = 100, seed: int = 0) -> np.ndarray:
    """sklearn's ``KernelDensity().fit(data).sample(n_samples,
    random_state=seed)`` (Gaussian kernel, bandwidth 1): rows drawn by
    ``RandomState(seed).uniform``, then normal noise around them."""
    rng = np.random.RandomState(seed)
    i = (rng.uniform(0, 1, size=n_samples) * data.shape[0]).astype(np.int64)
    return np.atleast_2d(rng.normal(data[i], 1.0))


def _logistic_auc(x: torch.Tensor, y: torch.Tensor) -> float:
    """In-sample ROC-AUC of an unpenalised logistic regression with an
    intercept, fitted by Newton's method with backtracking (at most 100
    steps, sklearn's ``max_iter``), in float64: the share of (positive,
    negative) pairs whose predicted probabilities are ordered right, ties
    counting half."""
    a = torch.cat([x, torch.ones_like(x[:, :1])], dim=1)
    w = torch.zeros(a.shape[1], dtype=torch.float64, device=x.device)

    def loss(w):
        z = a @ w
        return (torch.nn.functional.softplus(z) - y * z).sum()

    current = loss(w)
    for _ in range(100):
        p = torch.sigmoid(a @ w)
        grad = a.T @ (p - y)
        if float(grad.abs().max()) <= 1e-10:
            break
        hess = a.T @ (a * (p * (1 - p))[:, None])
        step = torch.linalg.pinv(hess) @ grad
        t = 1.0
        while t > 1e-12:
            trial = loss(w - t * step)
            if float(trial) < float(current):
                break
            t /= 2
        else:
            break
        w, current = w - t * step, trial
    p = torch.sigmoid(a @ w)
    pos, neg = p[y == 1], p[y == 0]
    order = (pos[:, None] > neg[None, :]).to(torch.float64) + 0.5 * (pos[:, None] == neg[None, :])
    return float(order.mean())


def _separation(emb_tables, count_tables, bin_info, exp_conditions, agg, metric):
    if agg == "time_on_cluster":
        aggregated = _time_on_cluster(count_tables, True, True, bin_info, None, None)
    elif agg in ("mean", "median"):
        aggregated = _aggregated_embedding(emb_tables, True, agg, bin_info, None, None, "mousewise")
    else:
        raise ValueError(f"Unknown aggregation method: {agg}")
    labels = [_plain_condition(exp_conditions[k]) for k in aggregated.index]

    if metric == "auc":
        classes = sorted(set(labels))
        if len(classes) != 2:
            raise ValueError(f"the AUC needs exactly two conditions among the experiments, got {classes}")
        dev = emb_tables.dev if emb_tables is not None else count_tables.dev
        x = torch.as_tensor(aggregated.values, device=dev)
        y = torch.as_tensor([float(classes.index(v)) for v in labels], dtype=torch.float64, device=dev)
        return _logistic_auc(x, y)
    if metric == "wasserstein":
        conditions = sorted({_plain_condition(v) for v in exp_conditions.values()})
        if len(conditions) != 2:
            raise ValueError("Exactly two conditions are required.")
        labels = np.asarray(labels)
        arrays = [_kde_sample(aggregated.values[labels == cond]) for cond in conditions]
        return _sliced_wasserstein(*arrays)
    raise ValueError(f"Unknown metric: {metric}")


def separation_between_conditions(cur_embedding, cur_soft_counts, bin_info, exp_conditions: dict, agg: str,
                                  metric: str = "auc", device="cuda") -> float:
    """Distance between the conditions' experiments in one time bin
    (``deepof_tpu/posthoc.py:668``), over their soft counts
    (``agg="time_on_cluster"``) or their mean or median embeddings, always
    reduced to 2 scaled PCA components. ``metric="auc"``: the in-sample
    ROC-AUC of an unpenalised logistic regression (labels in sorted order);
    ``"wasserstein"``: 100 KDE draws a condition (sklearn's
    ``KernelDensity().sample(100, random_state=0)``), then the sliced
    2-Wasserstein distance over 10,000 projections."""
    dev = resolve_device(device)
    emb = _DeviceTables(cur_embedding, dev) if cur_embedding is not None else None
    counts = _DeviceTables(cur_soft_counts, dev) if cur_soft_counts is not None else None
    return _separation(emb, counts, bin_info, exp_conditions, agg, metric)


def condition_distance_binning(
    embedding,
    soft_counts,
    exp_conditions: dict,
    start_bin: int = None,
    end_bin: int = None,
    step_bin: int = None,
    scan_mode: str = "growing_window",
    precomputed_bins: np.ndarray = None,
    agg: str = "mean",
    metric: str = "auc",
    n_jobs: int = 1,
    device="cuda",
) -> np.ndarray:
    """Separability of the conditions over time bins
    (``deepof_tpu/posthoc.py:574``), one :func:`separation_between_conditions`
    a bin, each recording uploaded once for all bins. ``growing_window``:
    spans [0, i] for i in range(start_bin, end_bin, step_bin);
    ``per-bin``: [i * step_bin, (i + 1) * step_bin - 1]; otherwise
    ``precomputed_bins`` holds bin sizes and bin i spans [cumsum[i],
    cumsum[i + 1]] (consecutive bins share a frame, as in the JAX package).
    ``end_bin`` defaults to the shortest soft-count table, ``start_bin`` and
    ``step_bin`` to max(10, end_bin // 10)."""
    if scan_mode in ("growing_window", "per-bin"):
        if end_bin is None:
            end_bin = min(int(get_dt(soft_counts, k, only_metainfo=True)["num_rows"]) for k in soft_counts.keys())
        if start_bin is None:
            start_bin = max(10, end_bin // 10)
        if step_bin is None:
            step_bin = max(10, end_bin // 10)
    if scan_mode == "per-bin":
        bin_infos = [np.array([i * step_bin, (i + 1) * step_bin - 1]) for i in range(end_bin // step_bin)]
    elif scan_mode == "growing_window":
        bin_infos = [np.array([0, i]) for i in range(start_bin, end_bin, step_bin)]
    else:
        if precomputed_bins is None:
            raise ValueError("For precomputed binning, provide a numpy array with bin IDs under the "
                             "precomputed_bins parameter")
        cumsums = np.insert(np.cumsum(precomputed_bins), 0, 0)
        bin_infos = [np.array([cumsums[i], cumsums[i + 1]]) for i in range(len(precomputed_bins))]
    dev = resolve_device(device)
    emb = _DeviceTables(embedding, dev) if embedding is not None else None
    counts = _DeviceTables(soft_counts, dev)
    return np.asarray([_separation(emb, counts, b, exp_conditions, agg, metric) for b in bin_infos])


def recluster(
    coordinates,
    embeddings: TableDict,
    soft_counts: TableDict = None,
    min_confidence: float = 0.75,
    states: Union[int, str] = "aic",
    pretrained: Union[bool, str] = False,
    covariance_type: str = "diag",
    min_states: int = 2,
    max_states: int = 12,
    save: bool = True,
    device=None,
) -> TableDict:
    """HMM reclustering of the embedding space (``deepof_tpu/posthoc.py:1114``).

    With ``soft_counts``, the decode of an HMM of their width is biased by
    them (rows below ``min_confidence`` fall back to a uniform prior).
    Otherwise the state count is ``states`` when an int, else chosen by
    "aic" / "bic" over [min_states, max_states]. The HMM is diagonal
    (:class:`msm.GaussianHMM`). ``pretrained`` is a pickle path, or True for
    ``Trained_models/hmm_trained_{states}.pkl`` of the project, which
    ``save`` writes. Pickles are this package's own (numpy parameters).
    ``device`` defaults to the project's."""
    if covariance_type != "diag":
        warnings.warn(f"deepof_tpu_torch HMMs are diagonal-covariance; ignoring covariance_type={covariance_type!r}.")
    dev = resolve_device(coordinates._device if device is None and coordinates is not None else (device or "cuda"))

    def model_path():
        return os.path.join(coordinates._project_path, coordinates._project_name, "Trained_models",
                            f"hmm_trained_{states}.pkl")

    seqs = {k: np.asarray(get_dt(embeddings, k), np.float32) for k in embeddings.keys()}
    model = None
    if pretrained:
        with open(pretrained if isinstance(pretrained, str) else model_path(), "rb") as f:
            model = pickle.load(f)[0]
        model.device = dev
    if model is None and soft_counts is not None:
        out = get_soft_counts_hmm(embeddings, soft_counts={k: np.asarray(get_dt(soft_counts, k))
                                                           for k in soft_counts.keys()},
                                  min_confidence=min_confidence, device=dev)
    else:
        if model is None:
            if isinstance(states, int):
                min_t = min(s.shape[0] for s in seqs.values())
                model = GaussianHMM(int(states), device=dev).fit(np.stack([s[:min_t] for s in seqs.values()]))
            else:
                model, _ = fit_hmm_range(seqs, states, min_states=min_states, max_states=max_states, device=dev)
            if save and coordinates is not None:
                os.makedirs(os.path.dirname(model_path()), exist_ok=True)
                with open(model_path(), "wb") as f:
                    pickle.dump([model], f)
        out = dict(zip(seqs, model._decode(list(seqs.values()), [None] * len(seqs))))
    return TableDict(out, typ="unsupervised_counts", table_path=embeddings._table_path,
                     animal_ids=embeddings._animal_ids, exp_conditions=embeddings._exp_conditions)
