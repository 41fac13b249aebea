"""Post-hoc statistics over the served embeddings, soft counts and
supervised tags, and the kinematics tables the supervised engine reads
(port of ``deepof_tpu/posthoc.py``: ``align_deepof_kinematics_with_unsupervised_labels``
:46 and ``_kinematics_table_views`` :76, the cluster usage statistics
:222-421, transitions :423-571, condition separability :574-736, the
normative KDE :739-770, chunk statistics and annotation :786-905, the
grouped CV folds :909, the cluster detectors and their explanations
:932-1062, the LDA projection ``compute_UMAP`` :1064 and HMM reclustering
:1114). The gating API and ``get_contrastive_soft_counts`` are re-exported
here, where the JAX package exposes them (:30-38).

Every entry point takes ``device`` (default "cuda"; it raises without a GPU
unless given "cpu"). Each recording's table is uploaded once per call in
float64; hard labels, valid-row masks, per-cluster and transition counts,
NaN-aware means and medians, ROI masks and the per-experiment algebra (PCA,
the standard scaler, the logistic regression, matrix powers) run as tensor
ops on the device, and each call's per-experiment results come back in one
host copy. The KDE draw and the sliced Wasserstein distance run in numpy on
the host, from numpy's seeded streams as the JAX package's do, and so do
the chunk draw and the CV folds; the chunk windows, their statistics and
the normative KDE's fold scores are formed on the device.

The cluster detectors restate what the JAX package takes from sklearn (the
machine with the card has none): ``gbm.HistGradientBoostingClassifier``
(its trees grown by the kernels of ``ops.gbm_kernels``), SMOTE, the
scaler, the pipeline and ``clone`` from ``legacy_compat``, and here
``cross_validate`` (folds fitted in series) and the weighted OVO / OVR ROC
AUC (sklearn's ``roc_auc_score``, on the host in numpy). The Shapley values
always come from the port's Kernel SHAP (``shap_kernel``); the LDA's class
means and scaling run on the device and its two SVDs in scipy on the host.

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
import time
import warnings
from itertools import combinations
from typing import Dict, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from deepof_tpu_torch.core.storage import (
    DeviceTable, LazyFrame, _slice_obj, _take, get_dt, get_dt_rows, is_pointer, save_dt,
)
from deepof_tpu_torch.core.table_dict import TableDict
from deepof_tpu_torch.device import fetch_together, host_array, resolve_device
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
    distance_pairs=None, kin_derivative: int = 1, include_feature_derivatives: bool = False,
    include_distances: bool = True, include_angles: bool = False, include_areas: bool = True,
) -> Dict[Optional[str], DeviceTable]:
    """One recording's kinematics table for each animal view (None = every
    animal), from one set of device tables (``deepof_tpu/posthoc.py:76``).
    For each derivative order from 0 to ``kin_derivative``, with the
    suffix ``_raw``, ``_speed``, ``_acceleration`` or ``_kinematics_{n}``:
    the coordinates centred on ``center`` and aligned on ``align`` (orders
    from 1), then the bodypart distances (only ``distance_pairs`` when
    given, else every pair), the bridge angles and the body areas, each at
    order 0 and, with ``include_feature_derivatives``, at every order. A
    view keeps its animal's columns (areas by prefix). The defaults are the
    supervised engine's table (no angles)."""
    parts = []  # (values, columns, suffix, is_areas)
    for der in range(kin_derivative + 1):
        suffix = {0: "_raw", 1: "_speed", 2: "_acceleration"}.get(der, f"_kinematics_{der}")
        if der:
            parts.append((*coordinates.get_coords_at_key(key, center=center, align=align, speed=der, _device=True),
                          suffix, False))
        if der and not include_feature_derivatives:
            continue
        if include_distances:
            parts.append((*coordinates.get_distances_at_key(key, speed=der, filter_on_graph=False,
                                                            pairs=distance_pairs, _device=True), suffix, False))
        if include_angles:
            parts.append((*coordinates.get_angles_at_key(key, speed=der, _device=True), suffix, False))
        if include_areas:
            parts.append((*coordinates.get_areas_at_key(key, speed=der, _device=True), suffix, True))
    if not parts:
        raise ValueError("no kinematic feature selected: raise kin_derivative or include distances, angles or areas")
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


def align_deepof_kinematics_with_unsupervised_labels(
    deepof_project,
    kin_derivative: int = 1,
    center: str = "Center",
    align: str = "Spine_1",
    include_feature_derivatives: bool = False,
    include_distances: bool = True,
    include_angles: bool = True,
    include_areas: bool = True,
    animal_id: str = None,
    file_name: Optional[str] = "kinematics",
    return_path: bool = False,
    device="cuda",
) -> TableDict:
    """Each recording's kinematics table (``deepof_tpu/posthoc.py:46``): see
    :func:`_kinematics_table_views` for the columns; ``animal_id`` keeps one
    animal's. The tables are computed on the project's device and read back
    from ``device`` as float64 LazyFrames; with ``return_path`` (and a
    ``file_name``) each is written to ``{table_path}/{key}/{key}_{file_name}``
    (``deepof_tpu/posthoc.py:195-208``) and the value is its pointer."""
    dev = resolve_device(device)
    tabs = {}
    for key in deepof_project.get_table_keys():
        table = _kinematics_table_views(
            deepof_project, [animal_id], key, center=center, align=align, kin_derivative=kin_derivative,
            include_feature_derivatives=include_feature_derivatives, include_distances=include_distances,
            include_angles=include_angles, include_areas=include_areas)[animal_id]
        host = np.array(table.values.to(dev).cpu().numpy(), dtype=np.float64)
        path = os.path.join(deepof_project._table_path, key, f"{key}_{file_name}") if file_name else None
        tabs[key] = save_dt(LazyFrame(lambda arr=host: arr, table.columns, len(host)), path, return_path)
    return TableDict(tabs, typ="annotations", table_path=deepof_project._table_path)


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
    first use, with their column labels (None for a bare array). A pointer's
    rows of a bin are read from its maps alone and uploaded."""

    def __init__(self, tab_dict, dev: torch.device):
        self.tab_dict, self.dev, self._cache = tab_dict, dev, {}

    def keys(self):
        return self.tab_dict.keys()

    def columns(self, key):
        return get_dt(self.tab_dict, key, only_metainfo=True)["columns"]

    def _upload(self, table) -> torch.Tensor:
        return torch.as_tensor(np.asarray(table, np.float64), device=self.dev)

    def full(self, key) -> torch.Tensor:
        if key not in self._cache:
            self._cache[key] = self._upload(get_dt(self.tab_dict, key))
        return self._cache[key]

    def rows(self, key, bin_info=None):
        """(rows of the recording, their frame indices or None): a bare
        array is a span, a dict entry an array of row indices."""
        load_range = _resolve_range(bin_info, key)
        if load_range is None:
            return self.full(key), None
        if isinstance(bin_info, dict):
            idx = np.asarray(load_range).astype(np.int64)
            if is_pointer(self.tab_dict[key]) and key not in self._cache:
                return self._upload(get_dt_rows(self.tab_dict, key, idx)), idx
            return _take(self.full(key), idx), idx
        if is_pointer(self.tab_dict[key]) and key not in self._cache:
            table = self._upload(get_dt(self.tab_dict, key, load_range=load_range))
        else:
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


def _nanmedian(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Medians along ``dim`` skipping NaN, the middle pair averaged
    (``np.nanmedian``; ``torch.nanmedian`` takes the lower one)."""
    s = torch.sort(x, dim=dim).values  # NaN sorts last
    n = (~torch.isnan(x)).sum(dim=dim, keepdim=True)
    med = (s.gather(dim, (n - 1).clamp(min=0) // 2) + s.gather(dim, n // 2)).squeeze(dim) / 2
    return torch.where(n.squeeze(dim) > 0, med, torch.nan)


def _nan_extreme(x: torch.Tensor, largest: bool, dim: int = 1) -> torch.Tensor:
    """NaN-skipping max or min along ``dim``; NaN for an all-NaN slice
    (``np.nanmax`` / ``np.nanmin``)."""
    isnan = torch.isnan(x)
    filled = torch.where(isnan, -torch.inf if largest else torch.inf, x)
    out = filled.amax(dim=dim) if largest else filled.amin(dim=dim)
    return torch.where(isnan.all(dim=dim), torch.nan, out)


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


# --------------------------------------------------------------------------- #
# Normative modeling
# --------------------------------------------------------------------------- #

# The bandwidths the normative fit searches (deepof's post_hoc.py:2097).
NORMATIVE_BANDWIDTHS = np.linspace(0.1, 10, 200)


def _sq_distances(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(n, m) squared euclidean distances, summed over the features of the
    differences (no cancellation)."""
    return ((a[:, None, :] - b[None, :, :]) ** 2).sum(dim=-1)


class GaussianKDE:
    """sklearn's ``KernelDensity(kernel="gaussian", bandwidth=...)`` in
    float64 on ``device``: ``fit(x)`` keeps the rows, ``score_samples(x)``
    gives their log densities (a numpy array)."""

    def __init__(self, bandwidth: float = 1.0, device="cuda"):
        self.bandwidth = float(bandwidth)
        self.device = resolve_device(device)

    def fit(self, x) -> "GaussianKDE":
        self.data_ = torch.as_tensor(host_array(x), dtype=torch.float64, device=self.device)
        return self

    def score_samples(self, x) -> np.ndarray:
        q = torch.as_tensor(host_array(x), dtype=torch.float64, device=self.device)
        return _log_densities(_sq_distances(q, self.data_), [self.bandwidth], q.shape[1])[0].cpu().numpy()


def _log_densities(sq_dist: torch.Tensor, bandwidths, d: int) -> torch.Tensor:
    """(h, n) Gaussian-kernel log densities of n points of width d from
    their (n, m) squared distances to the m training rows, for each
    bandwidth: a ``logsumexp`` of the kernel logs (sklearn's tree sums in
    log space too, so far points keep finite logs), then sklearn's
    normalisation ``-d/2 log(2 pi) - d log(h) - log(m)``."""
    h = torch.as_tensor(np.asarray(bandwidths, np.float64), device=sq_dist.device)[:, None]
    log_sum = torch.logsumexp(-0.5 * sq_dist[None] / (h * h)[:, :, None], dim=-1)
    return log_sum - (0.5 * d * np.log(2 * np.pi) + d * torch.log(h) + np.log(sq_dist.shape[1]))


def fit_normative_global_model(global_normal_embeddings, device="cuda") -> GaussianKDE:
    """A Gaussian KDE of the control experiments' embeddings
    (``deepof_tpu/posthoc.py:739``), its bandwidth searched over
    ``linspace(0.1, 10, 200)`` as sklearn's ``GridSearchCV`` searches it
    with ``cv=min(10, n_rows)``: unshuffled ``KFold`` folds (the first
    n % k one row longer), each bandwidth's mean held-out log-likelihood,
    the first best, then a refit on every row. Every fold's distances are
    computed once and the whole grid scored from them on the device."""
    dev = resolve_device(device)
    x = torch.as_tensor(host_array(global_normal_embeddings), dtype=torch.float64, device=dev)
    n = x.shape[0]
    n_splits = int(min(10, n))
    if n_splits < 2:
        raise ValueError(f"k-fold cross-validation needs at least 2 folds: {n} control row(s)")
    sizes = np.full(n_splits, n // n_splits)
    sizes[:n % n_splits] += 1
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    scores = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        train = torch.cat([x[:lo], x[hi:]])
        scores.append(_log_densities(_sq_distances(x[lo:hi], train), NORMATIVE_BANDWIDTHS, x.shape[1]).sum(dim=1))
    mean = fetch_together([torch.stack(scores, dim=1)])[0].mean(axis=1)
    best = float(NORMATIVE_BANDWIDTHS[int(np.argmax(mean))])
    return GaussianKDE(best, dev).fit(x)


def score_against_normative(model: GaussianKDE, embeddings) -> Labelled:
    """Each experiment's log-likelihood under the normative KDE
    (``deepof_tpu/posthoc.py:760``): a :class:`Labelled` with the
    experiments of ``embeddings`` (a :class:`Labelled` from
    :func:`get_aggregated_embedding`) as rows and one column, 0."""
    index = list(embeddings.index) if hasattr(embeddings, "index") else list(range(len(host_array(embeddings))))
    return Labelled(model.score_samples(embeddings)[:, None], index, [0])


# --------------------------------------------------------------------------- #
# Chunk statistics and annotation
# --------------------------------------------------------------------------- #


def _central_moments(x: torch.Tensor):
    """(mean, m2, m3, m4) along dim 1 over the non-NaN values, as scipy's
    ``_moment`` forms them (d^2 * d and (d^2)^2)."""
    valid = ~torch.isnan(x)
    n = valid.sum(dim=1).to(x.dtype)
    mean = torch.where(valid, x, 0.0).sum(dim=1) / n
    d = torch.where(valid, x - mean[:, None], 0.0)
    d2 = d * d
    return mean, d2.sum(dim=1) / n, (d2 * d).sum(dim=1) / n, (d2 * d2).sum(dim=1) / n


def _skew(x: torch.Tensor) -> torch.Tensor:
    """scipy's ``skew(axis=1, nan_policy="omit")`` (bias on): m3 / m2^1.5,
    NaN where m2 <= (eps * mean)^2 (a constant slice, one value) or the
    slice is empty."""
    mean, m2, m3, _ = _central_moments(x)
    zero = m2 <= (torch.finfo(x.dtype).eps * mean) ** 2
    return torch.where(zero | torch.isnan(mean), torch.nan, m3 / m2 ** 1.5)


def _kurt(x: torch.Tensor) -> torch.Tensor:
    """scipy's ``kurtosis(axis=1, nan_policy="omit")`` (Fisher, bias on):
    m4 / m2^2 - 3, NaN as in :func:`_skew`."""
    mean, m2, _, m4 = _central_moments(x)
    zero = m2 <= (torch.finfo(x.dtype).eps * mean) ** 2
    return torch.where(zero | torch.isnan(mean), torch.nan, m4 / m2 ** 2.0) - 3


def _nan_var(x: torch.Tensor) -> torch.Tensor:
    mean = torch.nanmean(x, dim=1, keepdim=True)
    return torch.nanmean((x - mean) ** 2, dim=1)


# The seglearn base features, each over the time axis (dim 1) of (n, t).
_BASE_FEATURES = {
    "mean": lambda x: torch.nanmean(x, dim=1),
    "median": lambda x: _nanmedian(x, dim=1),
    "abs_energy": lambda x: torch.nansum(x ** 2, dim=1),
    "std": lambda x: torch.sqrt(_nan_var(x)),
    "var": _nan_var,
    "min": lambda x: _nan_extreme(x, largest=False),
    "max": lambda x: _nan_extreme(x, largest=True),
    "skew": _skew,
    "kurt": _kurt,
    "mse": lambda x: torch.nanmean(x ** 2, dim=1),
    "mnx": lambda x: torch.nanmean(torch.abs(torch.diff(x, dim=1)), dim=1),
}


def _chunk_statistics(chunks: torch.Tensor) -> torch.Tensor:
    """(n, 11 f) float64: every base feature of every feature column,
    feature-major (each statistic over all columns, then the next)."""
    flat = chunks.permute(0, 2, 1).reshape(-1, chunks.shape[1])  # (n f, t)
    n, f = chunks.shape[0], chunks.shape[2]
    return torch.cat([fn(flat).reshape(n, f) for fn in _BASE_FEATURES.values()], dim=1)


def chunk_summary_statistics(chunked_dataset, body_part_names: list, device="cuda") -> Labelled:
    """Summary statistics of each chunk and feature
    (``deepof_tpu/posthoc.py:798``), in float64 on ``device``: mean,
    median, abs_energy, std, var, min, max, skew, kurt, mse and mnx of each
    (n, t, f) chunk's feature over time, NaN skipped (an all-NaN slice
    gives NaN, abs_energy 0). Columns ``{name}_{statistic}``,
    statistic-major."""
    dev = resolve_device(device)
    chunks = (chunked_dataset.to(dev, torch.float64) if isinstance(chunked_dataset, torch.Tensor)
              else torch.as_tensor(np.asarray(chunked_dataset, np.float64), device=dev))
    values = fetch_together([_chunk_statistics(chunks)])[0]
    columns = [f"{bp}_{feat}" for feat in _BASE_FEATURES for bp in body_part_names]
    return Labelled(values, list(range(len(values))), columns)


def annotate_time_chunks(
    deepof_project,
    soft_counts,
    supervised_annotations=None,
    window_size: int = None,
    window_step: int = 1,
    animal_id: str = None,
    samples: int = 10000,
    min_confidence: float = 0.0,
    kin_derivative: int = 1,
    include_distances: bool = False,
    include_angles: bool = False,
    include_areas: bool = False,
    aggregate: str = "mean",
    device="cuda",
):
    """Kinematic chunks annotated with hard cluster labels
    (``deepof_tpu/posthoc.py:820``).

    Each recording's kinematics table (:func:`_kinematics_table_views`,
    with the supervised tags appended as columns when given) is cut into
    windows of ``window_size`` frames (default: the frame rate) every
    ``window_step`` frames; the first min(windows, soft-count rows) are
    kept where their soft counts' maximum exceeds ``min_confidence``. With
    more than ``samples`` kept chunks, ``np.random.choice(kept, samples,
    replace=False)`` (numpy's global state) picks which, sorted, and only
    those windows are gathered on the device. Returns (statistics: a
    :class:`Labelled` of the chunks' NaN-skipping means, or with another
    ``aggregate`` their :func:`chunk_summary_statistics`; the hard label
    of each chunk; ``bin_info``: each recording's window starts, offset by
    the frames of the recordings before it). Column labels are the last
    recording's."""
    dev = resolve_device(device)
    if window_size is None:
        window_size = int(np.round(deepof_project._frame_rate))
    tables, counted = [], []
    for key in soft_counts.keys():
        kin = _kinematics_table_views(
            deepof_project, [animal_id], key, kin_derivative=kin_derivative, include_distances=include_distances,
            include_angles=include_angles, include_areas=include_areas)[animal_id]
        values, columns = kin.values.to(dev, torch.float64), list(kin.columns)
        if supervised_annotations is not None:
            sup = get_dt(supervised_annotations, key)
            sup_cols = get_dt(supervised_annotations, key, only_metainfo=True)["columns"]
            sup = torch.as_tensor(np.asarray(sup, np.float64), device=dev)
            m = min(len(values), len(sup))
            values = torch.cat([values[:m], sup[:m]], dim=1)
            columns += list(sup_cols if sup_cols is not None else range(sup.shape[1]))
        counts = torch.as_tensor(np.asarray(get_dt(soft_counts, key), np.float64), device=dev)
        n_windows = max(0, (len(values) - window_size) // window_step + 1)
        cnt = counts[:min(n_windows, len(counts))]
        tables.append((key, values))
        counted += [cnt.max(dim=1).values > min_confidence, _hard_labels(cnt, nan_wins=True)]

    host = fetch_together(counted) if counted else []
    bin_info, labels, starts, offset = {}, [], [], 0
    for i, (key, _) in enumerate(tables):
        keep, hard = host[2 * i], host[2 * i + 1]
        local = np.flatnonzero(keep) * window_step
        bin_info[key] = offset + local
        starts.append(local)
        labels.append(hard[keep])
        offset += len(keep) * window_step
    y = np.concatenate(labels) if labels else np.zeros(0)
    n_kept = len(y)
    chosen = None
    if samples is not None and n_kept > samples:
        chosen = np.sort(np.random.choice(n_kept, samples, replace=False))
        y = y[chosen]
        flat = np.concatenate([bin_info[k] for k in bin_info])
        bounds = np.cumsum([0] + [len(bin_info[k]) for k in bin_info])
        for i, k in enumerate(bin_info):
            bin_info[k] = flat[chosen[(chosen >= bounds[i]) & (chosen < bounds[i + 1])]]

    # Gather only the chosen windows: (chunks, window, features).
    steps = torch.arange(window_size, device=dev)
    chunks, first = [], 0
    for (key, values), local in zip(tables, starts):
        pick = local if chosen is None else local[chosen[(chosen >= first) & (chosen < first + len(local))] - first]
        first += len(local)
        rows = torch.as_tensor(pick, device=dev)[:, None] + steps[None, :]
        chunks.append(values[rows])
    x = torch.cat(chunks) if chunks else torch.zeros((0, window_size, 1), dtype=torch.float64, device=dev)

    names = [str(c) for c in columns] if tables else []
    if aggregate == "mean":
        stats = Labelled(fetch_together([torch.nanmean(x, dim=1)])[0], list(range(len(x))), names)
    else:
        stats = chunk_summary_statistics(x, names, device=dev)
    return stats, y, bin_info


def chunk_cv_splitter(chunk_stats, bin_info: dict, n_folds: int = None) -> list:
    """Grouped CV folds that never split one experiment across train and
    test (``deepof_tpu/posthoc.py:909``): sklearn's ``GroupKFold`` (no
    shuffle) restated in numpy on the host. The chunks are taken to be
    ordered by experiment; the experiments, as groups, go largest first
    (a stable sort of their sizes, reversed) to the lightest fold. One fold
    an experiment by default. Returns [(train indices, test indices)]."""
    n_splits = n_folds if n_folds is not None else len(bin_info)
    if n_splits < 2:
        raise ValueError(f"k-fold cross-validation requires at least one train/test split by setting "
                         f"n_splits=2 or more, got n_splits={n_splits}.")
    sizes = np.array([len(value) for value in bin_info.values()])
    groups = np.repeat(np.arange(len(bin_info)), sizes)
    n_rows = len(chunk_stats.values) if isinstance(chunk_stats, Labelled) else len(chunk_stats)
    if len(groups) != n_rows:
        raise ValueError(f"bin_info holds {len(groups)} chunks, the statistics {n_rows}")
    unique, group_idx = np.unique(groups, return_inverse=True)
    if n_splits > len(unique):
        raise ValueError(f"Cannot have number of splits n_splits={n_splits} greater than the number of groups: "
                         f"{len(unique)}.")
    per_group = np.bincount(group_idx)
    order = np.argsort(per_group, kind="stable")[::-1]
    per_fold = np.zeros(n_splits)
    group_to_fold = np.zeros(len(unique))
    for g, weight in zip(order, per_group[order]):
        lightest = np.argmin(per_fold)
        per_fold[lightest] += weight
        group_to_fold[g] = lightest
    fold_of = group_to_fold[group_idx]
    indices = np.arange(len(groups))
    return [(indices[fold_of != f], indices[fold_of == f]) for f in range(n_splits)]


# --------------------------------------------------------------------------- #
# Cluster detectors and their explanations
# --------------------------------------------------------------------------- #

DETECTOR_SCORING = ("roc_auc_ovo_weighted", "roc_auc_ovr_weighted")


def _binary_roc_auc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """sklearn's ``_binary_roc_auc_score``: NaN unless both classes are
    present; the ROC curve at the distinct scores (descending), collinear
    points dropped, its area by the trapezoid rule, in float64."""
    y_true = np.asarray(y_true).astype(bool)
    if len(np.unique(y_true)) != 2:
        warnings.warn("Only one class is present in y_true. ROC AUC score is not defined in that case.")
        return float("nan")
    y_score = np.asarray(y_score, np.float64)
    order = np.flip(np.argsort(np.flip(y_score), kind="stable"))
    order = len(y_score) - 1 - order
    y_score, y_sorted = y_score[order], y_true[order].astype(np.float64)
    idx = np.concatenate([np.nonzero(np.diff(y_score))[0], [len(y_sorted) - 1]])
    tps = np.cumsum(y_sorted)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    if fps.shape[0] > 2:
        keep = np.where(np.concatenate([[True], np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), [True]]))[0]
        fps, tps = fps[keep], tps[keep]
    fpr = np.concatenate([[0.0], fps]) / fps[-1]
    tpr = np.concatenate([[0.0], tps]) / tps[-1]
    return float(np.add.reduce(np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0))


def roc_auc_weighted(y_true, y_score, multi_class: str) -> float:
    """sklearn's ``roc_auc_score(y_true, y_score, multi_class=...,
    average="weighted")`` for the scorers ``roc_auc_ovo_weighted`` and
    ``roc_auc_ovr_weighted``: a 1-d ``y_score`` (a binary classifier's
    second column) against the larger label of ``y_true``; a 2-d one
    (n, K > 2) needs every one of its K classes in ``y_true`` (else
    ValueError, as sklearn raises), then Hand & Till's pairs weighted by
    their prevalence ("ovo") or each class against the rest weighted by its
    count ("ovr")."""
    y_true = np.asarray(host_array(y_true))
    y_score = np.asarray(host_array(y_score), np.float64)
    classes = np.unique(y_true)
    if y_score.ndim == 1:
        if len(classes) > 2:
            raise ValueError("`y_score` needs to be of shape `(n_samples, n_classes)`, since `y_true` contains "
                             "multiple classes.")
        return _binary_roc_auc(y_true == classes[-1], y_score)
    if len(classes) <= 2 and y_score.shape[1] <= 2:
        raise ValueError("y should be a 1d array for a binary y_true")
    if len(classes) != y_score.shape[1]:
        raise ValueError("Number of classes in y_true not equal to the number of columns in 'y_score'")
    if not np.allclose(1, y_score.sum(axis=1)):
        raise ValueError("Target scores need to be probabilities for multiclass roc_auc, i.e. they should sum up to "
                         "1.0 over classes")
    encoded = np.searchsorted(classes, y_true)
    if multi_class == "ovo":
        pairs = list(combinations(range(len(classes)), 2))
        scores, prevalence = np.empty(len(pairs)), np.empty(len(pairs))
        for ix, (a, b) in enumerate(pairs):
            a_mask, b_mask = encoded == a, encoded == b
            ab = a_mask | b_mask
            prevalence[ix] = np.average(ab)
            scores[ix] = (_binary_roc_auc(a_mask[ab], y_score[ab, a]) + _binary_roc_auc(b_mask[ab], y_score[ab, b])) / 2
        return float(np.average(scores, weights=prevalence))
    if multi_class != "ovr":
        raise ValueError(f"multi_class must be 'ovo' or 'ovr', got {multi_class!r}")
    onehot = encoded[:, None] == np.arange(len(classes))[None, :]
    weights = onehot.sum(axis=0)
    scores = np.array([_binary_roc_auc(onehot[:, c], y_score[:, c]) for c in range(len(classes))])
    scores[weights == 0] = 0
    return float(np.average(scores, weights=weights))


def _detector_score(estimator, x, y, scorer: str) -> float:
    """A scorer ``roc_auc_{ovo,ovr}_weighted`` on ``predict_proba``: the
    positive class's column for a binary classifier, all columns else."""
    proba = estimator.predict_proba(x)
    proba = proba.cpu().numpy() if isinstance(proba, torch.Tensor) else np.asarray(proba)
    if len(estimator.classes_) == 2:
        proba = proba[:, 1]
    return roc_auc_weighted(y, proba, scorer.split("_")[2])


def cross_validate(estimator, x, y, cv, verbose: int = 0) -> dict:
    """sklearn's ``cross_validate`` as the detectors call it (the
    ``DETECTOR_SCORING`` scorers, train scores and estimators returned),
    the folds fitted in series: a clone of ``estimator`` fitted on each
    fold's train rows and scored on its test and train rows; a score that
    cannot be formed (a fold lacking a class) is NaN with a warning
    (``error_score=nan``). Keys as sklearn's: ``fit_time``,
    ``score_time``, ``estimator``, ``test_{scorer}`` and ``train_{scorer}``."""
    from deepof_tpu_torch.legacy_compat import clone

    y = np.asarray(host_array(y))
    out = {"fit_time": [], "score_time": [], "estimator": []}
    for name in DETECTOR_SCORING:
        out[f"test_{name}"] = []
        out[f"train_{name}"] = []

    def score(est, rows, name):
        try:
            return _detector_score(est, x[rows], y[rows], name)
        except ValueError as e:
            warnings.warn(f"Scoring failed. The score on this train-test partition for these parameters will be set "
                          f"to nan. Details: {e}")
            return float("nan")

    for i, (train, test) in enumerate(cv):
        est = clone(estimator)
        t0 = time.perf_counter()
        est.fit(x[train], y[train])
        out["fit_time"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        for name in DETECTOR_SCORING:
            out[f"test_{name}"].append(score(est, test, name))
        out["score_time"].append(time.perf_counter() - t0)
        for name in DETECTOR_SCORING:
            out[f"train_{name}"].append(score(est, train, name))
        out["estimator"].append(est)
        if verbose:
            print(f"[CV] fold {i}: " + ", ".join(f"{k}={v[-1]:.3f}" for k, v in out.items() if k.startswith("test_")))
    return {k: (v if k == "estimator" else np.asarray(v, np.float64)) for k, v in out.items()}


def _make_cluster_detector(verbose: int, device="cuda"):
    """Scaler -> SMOTE-resampled gradient boosting (``deepof_tpu/posthoc.py:932``):
    :class:`~deepof_tpu_torch.legacy_compat.StandardScaler`, then
    :class:`~deepof_tpu_torch.legacy_compat.ResampledClassifier` of
    :class:`~deepof_tpu_torch.gbm.HistGradientBoostingClassifier` (max_iter
    200) over ``SimpleSMOTE(random_state=42)``, all on ``device``.
    ``verbose`` is the JAX package's argument; the port's estimator prints
    nothing a fit."""
    from deepof_tpu_torch.gbm import HistGradientBoostingClassifier
    from deepof_tpu_torch.legacy_compat import Pipeline, ResampledClassifier, SimpleSMOTE, StandardScaler

    return Pipeline([
        ("normalization", StandardScaler(device=device)),
        ("classifier", ResampledClassifier(
            estimator=HistGradientBoostingClassifier(max_iter=200, device=device),
            resampler=SimpleSMOTE(random_state=42, device=device),
        )),
    ])


def train_supervised_cluster_detectors(chunk_stats, hard_counts, bin_info: dict, n_folds: int = None,
                                       verbose: int = 1, device="cuda"):
    """Supervised cluster detectors from kinematic chunk features
    (``deepof_tpu/posthoc.py:955``): :func:`cross_validate` of
    :func:`_make_cluster_detector` over :func:`chunk_cv_splitter`'s folds
    (leave one experiment out by default), scored by the weighted OVO and
    OVR ROC AUCs on train and test, then the same pipeline fitted on every
    chunk. The statistics go to ``device`` once; the folds are fitted in
    series there, each fit drawing its two seeds from numpy's global state
    in fold order.

    Returns (the pipeline fitted on all chunks, the cross-validation dict,
    the folds)."""
    dev = resolve_device(device)
    groups = chunk_cv_splitter(chunk_stats, bin_info, n_folds=n_folds)
    x = torch.as_tensor(np.asarray(host_array(chunk_stats), np.float64), device=dev)
    y = np.asarray(host_array(hard_counts))
    if verbose:
        print("Training cross-validated models for performance estimation...")
    performance = cross_validate(_make_cluster_detector(verbose, dev), x, y, cv=groups, verbose=int(verbose > 1))
    if verbose:
        print("Training on full dataset for feature importance estimation...")
    full_cluster_clf = _make_cluster_detector(verbose, dev)
    full_cluster_clf.fit(x, y)
    if verbose:
        print("Done!")
    return full_cluster_clf, performance, groups


def explain_clusters(chunk_stats, hard_counts, full_cluster_clf, samples: int = 10000, n_jobs: int = -1,
                     device="cuda"):
    """Kernel SHAP values of the fitted detectors (``deepof_tpu/posthoc.py:1007``),
    always through the port's :class:`~deepof_tpu_torch.shap_kernel.KernelExplainer`:
    the chunk statistics scaled by the pipeline's scaler and resampled by a
    clone of its fitted SMOTE (as the detectors were trained), a k-means
    background of one centre a cluster, and, past ``samples`` rows,
    ``np.random.choice(rows, samples, replace=False)`` of the resampled rows
    (pandas' ``DataFrame.sample`` draw) explained with ``nsamples=samples``
    coalitions.

    Returns (a list of (samples, features) arrays, one a class; the
    explainer; the explained rows as a :class:`Labelled` whose index holds
    their row numbers in the resampled table)."""
    from deepof_tpu_torch.legacy_compat import clone
    from deepof_tpu_torch.shap_kernel import KernelExplainer, kmeans_background

    dev = resolve_device(device)
    values = np.asarray(host_array(chunk_stats), np.float64)
    columns = list(chunk_stats.columns) if hasattr(chunk_stats, "columns") else list(range(values.shape[1]))
    hard = np.asarray(host_array(hard_counts))
    scaler = full_cluster_clf.named_steps["normalization"]
    clfwrap = full_cluster_clf.named_steps["classifier"]
    x_scaled = scaler.transform(torch.as_tensor(values, device=dev))
    resampler = getattr(clfwrap, "resampler_", None) or getattr(clfwrap, "resampler", None)
    if resampler is not None:
        x_scaled, _ = clone(resampler).fit_resample(x_scaled, hard)
    n_clusters = len(np.unique(hard))
    explainer = KernelExplainer(clfwrap.predict_proba, data=kmeans_background(x_scaled, n_clusters, device=dev),
                                normalize=False, device=dev)
    index = np.arange(len(x_scaled))
    if samples is not None and samples < values.shape[0]:
        index = np.random.choice(len(x_scaled), samples, replace=False)
        x_scaled = x_scaled[torch.as_tensor(index, device=dev)]
    rows = x_scaled.cpu().numpy()
    shap_values = explainer.shap_values(rows, nsamples=samples, n_jobs=n_jobs)
    return shap_values, explainer, Labelled(rows, [int(i) for i in index], columns)


def _lda_transform(x: torch.Tensor, labels: np.ndarray, n_components: int) -> np.ndarray:
    """sklearn's ``LinearDiscriminantAnalysis(solver="svd", n_components).fit_transform``
    in float64: the class means (rows added in order) and the within-class
    centring and scaling on the device, the two SVDs in scipy on the host
    (sklearn's, so the components' signs are LAPACK's), the projection on
    the device."""
    import scipy.linalg

    tol = 1e-4
    classes, y_idx, counts = np.unique(labels, return_inverse=True, return_counts=True)
    n, d = x.shape
    k = len(classes)
    if n == k:
        raise ValueError("The number of samples must be more than the number of classes.")
    if n_components > min(k - 1, d):
        raise ValueError("n_components cannot be larger than min(n_features, n_classes - 1).")
    from deepof_tpu_torch.train.gmm import cluster_sums

    dev = x.device
    priors = counts.astype(np.float64) / float(n)
    y_t = torch.as_tensor(y_idx, device=dev)
    means = cluster_sums(x, y_t, k) / torch.as_tensor(counts, dtype=torch.float64, device=dev)[:, None]
    order = torch.as_tensor(np.argsort(y_idx, kind="stable"), device=dev)
    xc = x[order] - means[y_t[order]]
    xbar = torch.as_tensor(priors, device=dev) @ means
    std = xc.std(dim=0, correction=0)
    std = torch.where(std == 0, 1.0, std)
    scaled = (np.sqrt(1.0 / (n - k)) * (xc / std)).cpu().numpy()
    _, s, vt = scipy.linalg.svd(scaled, full_matrices=False)
    rank = int(np.sum(s > tol))
    std_h, means_h, xbar_h = std.cpu().numpy(), means.cpu().numpy(), xbar.cpu().numpy()
    scalings = (vt[:rank, :] / std_h).T / s[:rank]
    fac = 1.0 if k == 1 else 1.0 / (k - 1)
    centers = ((np.sqrt((n * priors) * fac)) * (means_h - xbar_h).T).T @ scalings
    _, s, vt = scipy.linalg.svd(centers, full_matrices=False)
    rank = int(np.sum(s > tol * s[0]))
    projection = torch.as_tensor(scalings @ vt.T[:, :rank], device=dev)
    return ((x - xbar) @ projection)[:, :n_components].cpu().numpy()


def compute_UMAP(embeddings, cluster_assignments, random_state: int = 0, reducer=None, device="cuda"):
    """LDA-then-UMAP 2-d projection of embeddings (``deepof_tpu/posthoc.py:1064``):
    a supervised LDA (:func:`_lda_transform`, min(width, clusters - 1)
    components), then ``reducer.fit_transform`` (any object with one), by
    default umap-learn's ``UMAP(min_dist=0.99, n_components=2, init="random")``
    seeded with ``random_state``. Raises ValueError for a single cluster
    (the JAX package asserts)."""
    labels = np.asarray(host_array(cluster_assignments))
    if np.unique(labels).size <= 1:
        raise ValueError("LDA could not be computed, as these soft_counts correspond to a collapsed model that only "
                         "contains a single cluster!")
    dev = resolve_device(device)
    x = (embeddings.to(dev, torch.float64) if isinstance(embeddings, torch.Tensor)
         else torch.as_tensor(np.asarray(host_array(embeddings), np.float64), device=dev))
    reduced = _lda_transform(x, labels, int(min(x.shape[1], len(set(labels.tolist())) - 1)))
    if reducer is None:
        try:
            import umap
        except ImportError as e:
            raise ImportError("compute_UMAP requires the optional 'umap-learn' package (or pass reducer=...).") from e
        reducer = umap.UMAP(min_dist=0.99, n_components=2, random_state=random_state,
                            n_jobs=1 if random_state is not None else -1, transform_seed=random_state, init="random")
    return reducer.fit_transform(reduced)
