"""Gated soft-count extraction: distance and behaviour gates, tracking-chaos
labels, and the per-gate GMM and MSM decoders of embeddings (port of
``deepof_tpu/gating.py``).

The gating series are per window: the moving average of an animal pair's
bodypart distance (the distance on the device from the project's
coordinates, the gaps filled with ``np.interp`` and the moving mean a
float64 cumulative sum on the host, as the JAX package takes them), a
behaviour's windowed any, the combination code of several behaviours, or a
single "" gate. Quantile edges, masks, runs and reservoir samples are numpy
on the host (small (T',) series; bins and masks equal the JAX package's on
equal series). Each (gate, bin) model is fitted on the device with the
restated sklearn estimators (``cluster.py``), and each recording's soft
counts are decoded, smoothed and normalised on the device and come back in
one host copy. Entry points take ``device`` (default: the project's).
"""

from __future__ import annotations

from itertools import combinations
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from deepof_tpu_torch.cluster import GaussianMixture, MiniBatchKMeans
from deepof_tpu_torch.core.storage import LazyFrame, get_dt
from deepof_tpu_torch.core.table_dict import TableDict
from deepof_tpu_torch.device import fetch_together, resolve_device, to_device
from deepof_tpu_torch.msm import _temporal_smooth, estimate_transition_matrix, pcca_plus, standardize
from deepof_tpu_torch.ops.scaling import StandardScaler


def _device(coordinates, device):
    return resolve_device(coordinates._device if device is None else device)


def _columns(tab_dict, key) -> list:
    return list(get_dt(tab_dict, key, only_metainfo=True)["columns"])


# --------------------------------------------------------------------------- #
# Windowed reductions (cumsum-based "valid" moving windows)
# --------------------------------------------------------------------------- #


def _moving_mean_valid(x, w: int) -> np.ndarray:
    x = np.asarray(x, np.float64)
    if w <= 1:
        return x.astype(np.float32)
    c = np.concatenate([[0.0], np.cumsum(x)])
    return ((c[w:] - c[:-w]) / w).astype(np.float32)


def _moving_any_valid(x, w: int) -> np.ndarray:
    """1 where any of the w frames in the window is truthy."""
    x = np.nan_to_num(np.asarray(x, np.float64), nan=0.0)
    if w <= 1:
        return (x > 0).astype(np.int32)
    c = np.concatenate([[0.0], np.cumsum(x)])
    return ((c[w:] - c[:-w]) > 0).astype(np.int32)


# --------------------------------------------------------------------------- #
# Chaos labels
# --------------------------------------------------------------------------- #


def get_supervised_chaos(
    coordinates,
    quality_threshold: float = 0.75,
    frac_bps_below: float = 0.5,
    chaos_suffix: str = "chaos",
    device=None,
) -> TableDict:
    """Per-animal tracking-chaos flags from the likelihood tables: a frame
    is chaotic for an animal when at least ``frac_bps_below`` of its body
    parts have likelihood below ``quality_threshold`` (or are missing).
    Adds an ``anychaos`` column OR-ing all animals. Values are float64
    (T, C) frames with those column labels."""
    dev = _device(coordinates, device)
    quality = coordinates.get_quality()
    animal_ids = coordinates._animal_ids or [""]
    prefixes = [aid + "_" for aid in animal_ids] if len(animal_ids) > 1 else [""]
    pending, columns = {}, [f"{mid}{chaos_suffix}" for mid in prefixes] + ["anychaos"]
    for key in quality.keys():
        cols = _columns(quality, key)
        q = to_device(get_dt(quality, key), dev, torch.float32)
        flags = []
        for mid in prefixes:
            idx = [i for i, c in enumerate(cols) if str(c).startswith(mid)]
            if not idx:
                raise ValueError(f"Animal prefix {mid!r} not found in quality table {key!r}")
            arr = q[:, idx]
            bad = (~torch.isfinite(arr)) | (arr < float(quality_threshold))
            flags.append(bad.to(torch.float64).mean(1) >= float(frac_bps_below))
        pending[key] = torch.stack(flags + [torch.stack(flags).any(0)], dim=1).to(torch.float64)
    out = {key: LazyFrame(lambda a=a: a, columns, len(a))
           for key, a in zip(pending, fetch_together(list(pending.values())))}
    return TableDict(out, typ="supervised_annotation", exp_conditions=coordinates.get_exp_conditions)


# --------------------------------------------------------------------------- #
# Gating series
# --------------------------------------------------------------------------- #


def get_pairwise_distances(
    coordinates,
    window_len: int,
    supervised_annotations=None,
    embedding_gates: Any = "Nose",
    behavior_combinations: bool = True,
    device=None,
) -> Dict[str, Dict]:
    """Per-window gating series, keyed experiment -> gate -> (T',) array.

    - distances: 2-4 animals, no supervised annotations, a bodypart name ->
      the moving-average distance of each animal pair's bodypart;
    - behaviours: supervised annotations given -> each behaviour's windowed
      any, or their binary combination codes with ``behavior_combinations``;
    - fallback: a single "" gate of ones.
    """
    dev = _device(coordinates, device)
    animal_ids = list(coordinates._animal_ids or [""])
    keys = list(coordinates._tables)

    if animal_ids != [""] and 2 <= len(animal_ids) <= 4 and supervised_annotations is None \
            and isinstance(embedding_gates, str):
        pairs = list(combinations(animal_ids, 2))
        pending = []
        for key in keys:
            tab, cols = coordinates.get_coords_at_key(key, center=False, _device=True)
            tab = tab.to(dev)
            col = {c: i for i, c in enumerate(cols)}
            dists = []
            for a_id, b_id in pairs:
                ca, cb = f"{a_id}_{embedding_gates}", f"{b_id}_{embedding_gates}"
                if (ca, "x") not in col:
                    raise KeyError(f"Bodypart column {(ca, 'x')} not found in table {key!r}")
                a = tab[:, [col[(ca, "x")], col[(ca, "y")]]].to(torch.float64)
                b = tab[:, [col[(cb, "x")], col[(cb, "y")]]].to(torch.float64)
                dists.append(torch.sqrt(((a - b) ** 2).sum(1)))
            pending.append(torch.stack(dists))
        out: Dict[str, Dict] = {}
        for key, dists in zip(keys, fetch_together(pending)):
            out[key] = {}
            for pair, d in zip(pairs, dists):
                mask = np.isfinite(d)
                if mask.any():
                    idx = np.arange(d.size)
                    d = np.interp(idx, idx[mask], d[mask])
                else:
                    d = np.zeros_like(d)
                out[key][pair] = _moving_mean_valid(d, window_len)
        return out

    if supervised_annotations is not None:
        if isinstance(embedding_gates, str):
            embedding_gates = [embedding_gates]
        requested = sorted(set(embedding_gates))
        first_key = list(supervised_annotations.keys())[0]
        available = set(_columns(supervised_annotations, first_key))
        valid = [b for b in requested if b in available]
        dropped = [b for b in requested if b not in available]
        if dropped:
            print(f"[gating] Dropped unavailable behaviors: {dropped}")
        if valid:
            out = {}
            for key in keys:
                sup = get_dt(supervised_annotations, key)
                cols = _columns(supervised_annotations, key)
                out[key] = {}
                wins = []
                for beh in valid:
                    win = _moving_any_valid(np.asarray(sup)[:, cols.index(beh)], window_len)
                    if behavior_combinations:
                        wins.append(win)
                    else:
                        out[key][beh] = win
                if behavior_combinations and wins:
                    powers = 2 ** np.arange(len(wins), dtype=np.int64)
                    out[key]["behavior_combinations"] = (powers @ np.array(wins, dtype=np.int64)).astype(np.int32)
            return out
        print("[gating] No valid behaviors remain; falling back to no gating.")

    return {key: {"": np.ones(max(len(coordinates._tables[key]) - window_len + 1, 0), np.float32)}
            for key in keys}


def _get_gating_series_and_gates(coordinates, animal_ids, window_size: int, supervised_annotations=None,
                                 embedding_gates: Any = "Center", device=None) -> Tuple[Dict[str, Dict], list]:
    series = get_pairwise_distances(coordinates, window_size, supervised_annotations=supervised_annotations,
                                    embedding_gates=embedding_gates, behavior_combinations=True, device=device)
    first_key = list(series.keys())[0]
    gates = list(series[first_key].keys())
    if len(animal_ids) == 1 or len(animal_ids) > 4:
        gates = gates[:1] if gates else [""]
    return series, gates


def _quantile_edges(series, keys, gates, m_gates) -> Dict[Any, np.ndarray]:
    qs = np.linspace(0, 1, m_gates + 1)
    gate_edges = {}
    for gate in gates:
        edges = np.nanquantile(np.concatenate([series[key][gate] for key in keys]), qs).astype(np.float64)
        edges[0], edges[-1] = -np.inf, np.inf
        gate_edges[gate] = edges
    return gate_edges


def compute_gate_edges(
    coordinates,
    animal_ids: Optional[list] = None,
    *,
    keys: Optional[list] = None,
    window_size: int = 12,
    supervised_annotations=None,
    M_gates: int = 3,
    embedding_gates: Any = "Center",
    fixed_edges: Optional[list] = None,
    device=None,
) -> Optional[Dict[Any, np.ndarray]]:
    """Quantile bin edges of the gating series; None for behaviour gating
    (its series are already integer bin codes)."""
    if animal_ids is None:
        animal_ids = list(coordinates._animal_ids or [""])
    if not isinstance(embedding_gates, str):
        M_gates = 2 ** len(set(embedding_gates))
    series, gates = _get_gating_series_and_gates(coordinates, animal_ids, window_size,
                                                 supervised_annotations=supervised_annotations,
                                                 embedding_gates=embedding_gates, device=device)
    if keys is None:
        keys = list(series.keys())
    if len(animal_ids) == 1 or len(animal_ids) > 4:
        M_gates = 1
    if supervised_annotations is not None:
        return None
    if fixed_edges is not None:
        if len(fixed_edges) != M_gates + 1:
            raise ValueError('fixed_edges must have length "M_gates"+1')
        edges = np.asarray(fixed_edges, np.float64).copy()
        edges[0], edges[-1] = -np.inf, np.inf
        return {gate: edges.copy() for gate in gates}
    return _quantile_edges(series, keys, gates, M_gates)


def _build_gate_masks(
    keys: list,
    emb_len: Dict[str, int],
    series: Dict[str, Dict],
    gates: list,
    M_gates: int,
    supervised_annotations=None,
    gate_edges: Optional[Dict[Any, np.ndarray]] = None,
) -> Dict[Any, Dict[int, Dict[str, np.ndarray]]]:
    """Boolean masks per (gate, bin, experiment) over embedding rows (each
    series cut to its recording's embedding length)."""
    gate_masks: Dict[Any, Dict[int, Dict[str, np.ndarray]]] = {}
    for gate in gates:
        full_g = np.concatenate([series[key][gate][: emb_len[key]] for key in keys])
        gate_masks[gate] = {}
        for b in range(M_gates):
            if supervised_annotations is not None:
                in_bin = full_g == b
            else:
                edges = np.asarray(gate_edges[gate], np.float64)
                if len(edges) != M_gates + 1:
                    raise ValueError(f"gate_edges[{gate!r}] must have length {M_gates + 1}")
                in_bin = (full_g > edges[b]) & (full_g <= edges[b + 1])
            gate_masks[gate][b] = {}
            cum = 0
            for key in keys:
                t = emb_len[key]
                gate_masks[gate][b][key] = in_bin[cum:cum + t]
                cum += t
    return gate_masks


def _gate_to_tag(gate: Any) -> str:
    if isinstance(gate, tuple):
        return "_".join(map(str, gate))
    if gate in ("", None):
        return "all"
    return str(gate).replace("/", "-").replace(" ", "_")


def _reservoir_sample(segments: List, n: int, seed: int = 0):
    """Uniform sample of up to n rows from a list of 2-D arrays or tensors,
    drawn with ``np.random.default_rng(seed)`` (the picks from the
    segments' lengths on the host, the rows gathered where they lie)."""
    cat = torch.cat if isinstance(segments[0], torch.Tensor) else np.concatenate
    rng = np.random.default_rng(seed)
    total = sum(s.shape[0] for s in segments)
    if total <= n:
        return cat(segments)
    pick = np.sort(rng.choice(total, size=n, replace=False))
    out, cum, j = [], 0, 0
    for s in segments:
        hi = cum + s.shape[0]
        lo_j = j
        while j < len(pick) and pick[j] < hi:
            j += 1
        if j > lo_j:
            rows = pick[lo_j:j] - cum
            out.append(s[torch.as_tensor(rows, device=s.device)] if isinstance(s, torch.Tensor) else s[rows])
        cum = hi
    return cat(out)


def _mask_to_runs(mask: np.ndarray, min_len: int = 2) -> List[Tuple[int, int]]:
    """Contiguous [start, end) runs of True at least min_len long."""
    m = np.asarray(mask, bool)
    if not m.any():
        return []
    d = np.diff(m.astype(np.int8))
    starts = np.flatnonzero(d == 1) + 1
    ends = np.flatnonzero(d == -1) + 1
    if m[0]:
        starts = np.concatenate([[0], starts])
    if m[-1]:
        ends = np.concatenate([ends, [m.size]])
    return [(int(s), int(e)) for s, e in zip(starts, ends) if e - s >= min_len]


def _preprocess_gates(coordinates, embeddings, animal_ids, window_size, supervised_annotations, M_gates,
                      embedding_gates, gate_edges, device):
    """(keys, gates, masks, {key: (T, D) float32 embeddings on the device},
    effective bins). Edges default to the quantiles of the full series."""
    keys = list(embeddings.keys())
    if not keys:
        raise ValueError("Embeddings are empty.")
    if animal_ids is None:
        animal_ids = list(coordinates._animal_ids or [""])
    z_by_key = {k: to_device(np.asarray(get_dt(embeddings, k), np.float32), device, torch.float32) for k in keys}
    emb_len = {k: z.shape[0] for k, z in z_by_key.items()}
    m_eff = int(M_gates)
    if not isinstance(embedding_gates, str):
        m_eff = 2 ** len(set(embedding_gates))
    if supervised_annotations is None and (len(animal_ids) == 1 or len(animal_ids) > 4):
        # Distance gating needs an animal pair; behaviour gating keeps its
        # combination bins whatever the number of animals.
        m_eff = 1
    series, gates = _get_gating_series_and_gates(coordinates, animal_ids, window_size,
                                                 supervised_annotations=supervised_annotations,
                                                 embedding_gates=embedding_gates, device=device)
    if supervised_annotations is None and gate_edges is None:
        gate_edges = _quantile_edges(series, keys, gates, m_eff)
    gate_masks = _build_gate_masks(keys, emb_len, series, gates, m_eff,
                                   supervised_annotations=supervised_annotations, gate_edges=gate_edges)
    return keys, gates, gate_masks, z_by_key, m_eff


def _rows(mask, device) -> torch.Tensor:
    return torch.as_tensor(np.flatnonzero(mask), device=device)


def _decode(coordinates, keys, gates, gate_masks, z_by_key, m_eff, n_clusters, models, block_fn,
            temporal_smooth_win) -> Dict[Any, TableDict]:
    """Every recording's (T, m_eff * n_clusters) soft counts of each gate:
    1e-4 where no bin's model speaks, ``block_fn(model, rows)`` on a bin's
    rows, a bin without a model uniform; smoothed, normalised, and fetched
    in one host copy."""
    pending = []
    for key in keys:
        z0 = z_by_key[key]
        for gate in gates:
            p = torch.full((z0.shape[0], m_eff * n_clusters), 1e-4, dtype=torch.float32, device=z0.device)
            for b in range(m_eff):
                idx = _rows(gate_masks[gate][b][key], z0.device)
                block = slice(b * n_clusters, (b + 1) * n_clusters)
                if idx.numel():
                    model = models[gate][b]
                    p[idx, block] = 1.0 / n_clusters if model is None else block_fn(model, z0[idx]).to(torch.float32)
            if temporal_smooth_win and temporal_smooth_win > 1:
                p = _temporal_smooth(p, temporal_smooth_win)
            pending.append(p / torch.clamp(p.sum(1, keepdim=True), min=1e-12))
    host = iter(fetch_together(pending))
    out = {gate: {} for gate in gates}
    for key in keys:
        for gate in gates:
            out[gate][key] = next(host)
    return {gate: TableDict(out[gate], typ="unsupervised_counts", exp_conditions=coordinates.get_exp_conditions)
            for gate in gates}


# --------------------------------------------------------------------------- #
# Gated GMM decoder
# --------------------------------------------------------------------------- #


def get_contrastive_soft_counts_gmm(
    coordinates,
    embeddings: Dict[str, np.ndarray],
    animal_ids: Optional[list] = None,
    window_size: int = 12,
    supervised_annotations=None,
    N_clusters_per_gate: int = 8,
    M_gates: int = 3,
    gate_edges: Optional[Dict[Any, np.ndarray]] = None,
    reg_covar: float = 1e-5,
    sample_size: int = 200_000,
    random_state: int = 0,
    embedding_gates: Any = "Center",
    temporal_smooth_win: Optional[int] = 3,
    device=None,
) -> Dict[Any, TableDict]:
    """Distance/behaviour-gated GMM decoder: one soft-count TableDict per
    gate, each with M_gates * N_clusters_per_gate columns (a block per
    bin); a full-covariance GaussianMixture per (gate, bin), seeded
    ``random_state + 17 * bin + 3 * gate_index``."""
    dev = _device(coordinates, device)
    keys, gates, gate_masks, z_by_key, m_eff = _preprocess_gates(
        coordinates, embeddings, animal_ids, window_size, supervised_annotations, M_gates, embedding_gates,
        gate_edges, dev)
    models: Dict[Any, List] = {}
    for gate_idx, gate in enumerate(gates):
        models[gate] = []
        for b in range(m_eff):
            seed_b = int(random_state + 17 * b + 3 * gate_idx)
            segs = [z_by_key[key][_rows(gate_masks[gate][b][key], dev)] for key in keys]
            segs = [s for s in segs if s.shape[0] > 0]
            n_rows = sum(s.shape[0] for s in segs)
            if n_rows < max(10, N_clusters_per_gate):
                models[gate].append(None)
                continue
            x_fit = _reservoir_sample(segs, int(sample_size), seed=seed_b)
            models[gate].append(GaussianMixture(
                n_components=int(N_clusters_per_gate), covariance_type="full", reg_covar=float(reg_covar),
                random_state=seed_b, init_params="kmeans", max_iter=200, tol=1e-3, device=dev).fit(x_fit))
    return _decode(coordinates, keys, gates, gate_masks, z_by_key, m_eff, N_clusters_per_gate, models,
                   lambda gmm, z: gmm.predict_proba(z), temporal_smooth_win)


# --------------------------------------------------------------------------- #
# Gated MSM/PCCA+ decoder
# --------------------------------------------------------------------------- #


def get_contrastive_soft_counts_msm_pcca(
    coordinates,
    embeddings: Dict[str, np.ndarray],
    animal_ids: Optional[list] = None,
    window_size: int = 12,
    supervised_annotations=None,
    N_clusters_per_gate: int = 8,
    M_gates: int = 3,
    gate_edges: Optional[Dict[Any, np.ndarray]] = None,
    n_micro: int = 200,
    lagtime: int = 3,
    sample_size: int = 200_000,
    random_state: int = 0,
    embedding_gates: Any = "Center",
    temporal_smooth_win: Optional[int] = 3,
    device=None,
) -> Dict[Any, TableDict]:
    """Gated MSM decoder: per (gate, bin), k-means microstates over the
    bin's contiguous runs of at least ``lagtime + 1`` rows, a lagged
    transition matrix over those runs, PCCA+ to N_clusters_per_gate
    macrostates, then each recording's memberships."""
    dev = _device(coordinates, device)
    keys, gates, gate_masks, z_by_key, m_eff = _preprocess_gates(
        coordinates, embeddings, animal_ids, window_size, supervised_annotations, M_gates, embedding_gates,
        gate_edges, dev)
    models: Dict[Any, List] = {}
    for gate_idx, gate in enumerate(gates):
        models[gate] = []
        for b in range(m_eff):
            seed_b = int(random_state + 17 * b + 3 * gate_idx)
            run_segs = [z_by_key[key][s:e] for key in keys
                        for s, e in _mask_to_runs(gate_masks[gate][b][key], min_len=lagtime + 1)]
            n_rows = sum(s.shape[0] for s in run_segs)
            if n_rows < max(10 * N_clusters_per_gate, n_micro):
                models[gate].append(None)
                continue
            x_fit = _reservoir_sample(run_segs, int(sample_size), seed=seed_b)
            scaler = StandardScaler().fit(x_fit)
            k_micro = int(min(n_micro, max(N_clusters_per_gate, n_rows // 10)))
            kmeans = MiniBatchKMeans(n_clusters=k_micro, random_state=seed_b, n_init=3, device=dev).fit(
                standardize(scaler, x_fit))
            labels = kmeans.predict(standardize(scaler, torch.cat(run_segs)))
            trans = estimate_transition_matrix(torch.split(labels, [s.shape[0] for s in run_segs]), k_micro,
                                               lagtime=lagtime)
            chi = torch.as_tensor(pcca_plus(trans, int(N_clusters_per_gate)), dtype=torch.float32, device=dev)
            models[gate].append({"scaler": scaler, "kmeans": kmeans, "chi": chi})
    return _decode(coordinates, keys, gates, gate_masks, z_by_key, m_eff, N_clusters_per_gate, models,
                   lambda m, z: m["chi"][m["kmeans"].predict(standardize(m["scaler"], z))], temporal_smooth_win)


# --------------------------------------------------------------------------- #
# Chaos gate composition
# --------------------------------------------------------------------------- #


def add_chaos_gates(
    coordinates,
    soft_counts_dict: Dict[Any, TableDict],
    soft_counts_chaos_dict: Dict[Any, TableDict],
    supervised_chaos: TableDict,
    window_size: int,
) -> Dict[Any, TableDict]:
    """Regular and chaos-specific soft counts combined per gate: windows
    overlapping a chaotic frame get their regular states zeroed and the
    chaotic half of the chaos extractor's states appended; clean windows
    keep their regular states with the chaos states zeroed."""
    out = {}
    for gate, soft_counts_gate in soft_counts_dict.items():
        chaos_gate = soft_counts_chaos_dict["behavior_combinations"]
        result_gate = {}
        for key in soft_counts_gate.keys():
            ann = np.asarray(get_dt(supervised_chaos, key))
            any_col = _columns(supervised_chaos, key).index("anychaos")
            sc1 = np.array(np.asarray(get_dt(soft_counts_gate, key)), np.float32)
            sc2 = np.array(np.asarray(get_dt(chaos_gate, key)), np.float32)
            n_windows = sc1.shape[0]
            ann_used = ann[: n_windows + window_size - 1]
            if sc2.shape[0] != n_windows or ann_used.shape[0] < n_windows:
                raise ValueError(f"Length mismatch at key {key!r}: {sc1.shape[0]} vs {sc2.shape[0]} vs {ann.shape[0]}")
            chaos_mask = _moving_any_valid(ann_used[:, any_col].astype(np.float32), window_size).astype(bool)
            if chaos_mask.shape[0] != n_windows:
                raise ValueError(f"Convolved length mismatch for {key!r}/'anychaos': {chaos_mask.shape[0]} vs "
                                 f"{n_windows}")
            sc1[chaos_mask, :] = 0
            sc2[~chaos_mask, :] = 0
            n_cols_chaos = sc2.shape[1]
            if n_cols_chaos % 2 != 0:
                raise ValueError(f"Chaos soft counts for {key!r} have an odd number of columns ({n_cols_chaos})")
            result_gate[key] = np.concatenate([sc1, sc2[:, n_cols_chaos // 2:]], axis=1)
        out[gate] = TableDict(result_gate, typ="unsupervised_counts", exp_conditions=coordinates.get_exp_conditions)
    return out
