"""The public pipeline of the port: ``Project`` (pose tables on disk ->
preprocessed keypoints of every recording) and ``Coordinates`` (the
processed project, and the merged graph-dataset frames built from it on the
device), with the per-recording programs they run as plain functions
(port of ``deepof_tpu/data.py`` ``Project``, ``Coordinates``,
``_preprocess_positions``, ``_merged_features_program`` and
``_feature_pass``).

The programs take numpy arrays or tensors and a ``device``; they run in
float64 on the CPU when given float64 and in float32 otherwise. ``Project``
and ``Coordinates`` hold host numpy arrays (and a cache of device tables
that a pickle drops), so a project pickles. The getters (``get_coords``,
``get_distances``, ``get_angles``, ``get_areas``) compute on the device and
return a ``TableDict`` of ``LazyFrame``s: float64 (T, C) arrays with the JAX
package's column labels and no time index. Videos are never opened (the
machine with the card has no cv2): the frame rate is given or 25 fps, and
frame counts come from the tables.
"""

from __future__ import annotations

import copy
import os
import pickle
import re
import shutil
import warnings
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from deepof_tpu_torch import config
from deepof_tpu_torch.arena import fixture_arenas
from deepof_tpu_torch.core.graph import BodyGraph, build_body_graph, connect_mouse
from deepof_tpu_torch.core.storage import LazyFrame, save_dt
from deepof_tpu_torch.core.table_dict import TableDict, seconds_to_time, time_to_seconds
from deepof_tpu_torch.device import resolve_device, to_device, working_dtype
from deepof_tpu_torch.io.conditions import load_exp_conditions, load_start_markers
from deepof_tpu_torch.io.readers import RawTable, load_table, natural_sorted
from deepof_tpu_torch.ops.alignment import align_trajectories
from deepof_tpu_torch.ops import imputation
from deepof_tpu_torch.ops.geometry import point_in_polygon
from deepof_tpu_torch.ops.interp import masked_linear_interpolate
from deepof_tpu_torch.ops.kinematics import (
    all_pair_indices,
    bridge_angles,
    pairwise_distances,
    polygon_areas,
    rolling_speed,
    to_polar,
)
from deepof_tpu_torch.ops.outliers import remove_outliers
from deepof_tpu_torch.ops.smoothing import savgol_edges_host, savgol_smooth
from deepof_tpu_torch.utils import filter_columns


def _median(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.median``: the mean of the two middle values for an even count
    (``torch.median`` returns the lower one); NaN if any value is NaN."""
    n = x.shape[dim]
    s = torch.sort(x, dim=dim).values
    mid = (s.narrow(dim, (n - 1) // 2, 1) + s.narrow(dim, n // 2, 1)) / 2
    return torch.where(torch.isnan(x).any(dim=dim, keepdim=True), torch.nan, mid).squeeze(dim)


def _preprocess_positions(
    pos,
    lik,
    smooth_edges,
    do_smooth: bool,
    smooth_window: int,
    smooth_polyorder: int,
    do_outliers: bool,
    likelihood_tol: float,
    n_std: float,
    interp_limit: int,
    animal_slices: Tuple[Tuple[int, int], ...],
    device="cuda",
):
    """Fused preprocess for one video: Savitzky-Golay -> outlier NaN ->
    presence-masked linear interpolation -> missing-animal NaN
    (deepof_tpu/data.py:94).

    Args:
        pos: (T, B, 2) raw pixel positions.
        lik: (T, B) likelihoods.
        smooth_edges: (start_rows, end_rows) from ``savgol_edges_host``.
        animal_slices: per-animal (start, stop) node ranges.

    Returns:
        (positions (T, B, 2), presence (T, A) bool), on ``device``.
    """
    dev = resolve_device(device)
    dt = working_dtype(dev, pos.dtype)
    pos = to_device(pos, dev, dt)
    lik = to_device(lik, dev, dt)
    t, b, _ = pos.shape

    if do_smooth:
        pos = savgol_smooth(
            pos.reshape(t, b * 2), smooth_window, smooth_polyorder, edges=smooth_edges
        ).reshape(t, b, 2)
    if do_outliers:
        pos, _ = remove_outliers(pos, lik, likelihood_tol, lag=5, n_std=n_std, mode="or")

    # Animal presence: median likelihood over the animal's bodyparts.
    presence = torch.stack(
        [_median(lik[:, lo:hi], dim=1) > 0.5 for lo, hi in animal_slices], dim=1
    )
    blocks = []
    for ai, (lo, hi) in enumerate(animal_slices):
        pres = presence[:, ai]
        filled = masked_linear_interpolate(pos[:, lo:hi].reshape(t, -1), pres, interp_limit)
        filled = torch.where(pres[:, None], filled, torch.nan)
        blocks.append(filled.reshape(t, hi - lo, 2))
    return torch.cat(blocks, dim=1), presence


def _merged_features_program(
    pos,
    presence,
    center_xy,
    owner_mask,
    pairs,
    bridges,
    frame_rate: float,
    include_angles: bool,
    device="cuda",
):
    """The merged graph-dataset frame of one recording: arena-centred
    coordinates | speeds | bridge angles | pair distances, with NaN where
    a column's animal is absent (deepof_tpu/data.py:193).

    Args:
        pos: (T, B, 2) mm positions.
        presence: (T, A) presence (0 = missing frame).
        center_xy: (2,) arena centre in mm.
        owner_mask: (A, F) bool, column j NaNed when animal a is absent.
        pairs / bridges: index tuples into the node axis.
    """
    dev = resolve_device(device)
    dt = working_dtype(dev, pos.dtype)
    pos = to_device(pos, dev, dt)
    presence = to_device(presence, dev, dt)
    center = to_device(center_xy, dev, dt)
    owner = to_device(owner_mask, dev, torch.bool)
    t = pos.shape[0]

    blocks = [
        (pos - center[None, None, :]).reshape(t, -1),
        rolling_speed(pos, frame_rate=frame_rate, deriv=1),
    ]
    if include_angles and len(bridges):
        blocks.append(bridge_angles(pos, np.asarray(bridges, np.int32).reshape(-1, 3)))
    if len(pairs):
        blocks.append(pairwise_distances(pos, np.asarray(pairs, np.int32).reshape(-1, 2)))
    merged = torch.cat(blocks, dim=1)
    absent = presence == 0
    nan_mask = (absent[:, :, None] & owner[None, :, :]).any(dim=1)
    return torch.where(nan_mask, torch.nan, merged)


def pair_names_of(nodes: Sequence[str]) -> List[Tuple[str, str]]:
    """Sorted bodypart-pair names of every node pair, in
    ``all_pair_indices`` order."""
    return [tuple(sorted((nodes[i], nodes[j]))) for i, j in all_pair_indices(len(nodes))]


def distance_keep_idx(pair_names, edge_names, ego=False) -> list:
    """Kept distance columns: those involving the ego bodypart (when set),
    then those on the skeleton's edges (deepof_tpu/data.py:1782-1814, as
    the graph dataset filters them)."""
    keep = list(range(len(pair_names)))
    if ego:
        keep = [i for i in keep if any(ego in str(x) for x in pair_names[i])]
    edges = set(edge_names)
    return [i for i in keep if tuple(sorted(pair_names[i])) in edges]


def merged_feature_layout(
    graph: BodyGraph,
    animal_ids: Optional[Sequence[str]] = None,
    include_angles: bool = True,
    ego=False,
):
    """Static layout of the merged frame for a body graph, as
    ``Coordinates.merged_graph_features_device`` builds it
    (deepof_tpu/data.py:2169-2199): distance pairs kept on the skeleton
    edges, bridges, the column names and the (A, F) owner mask.

    Returns (columns, pairs, bridges, owner_mask).
    """
    nodes = list(graph.nodes)
    animal_ids = list(animal_ids if animal_ids is not None else graph.animal_ids)
    all_pairs = all_pair_indices(len(nodes))
    pair_names = pair_names_of(nodes)
    keep = distance_keep_idx(pair_names, graph.edge_names, ego)
    pairs = tuple(tuple(map(int, all_pairs[i])) for i in keep)
    bridges = (
        tuple(tuple(map(int, b)) for b in graph.bridges) if include_angles else ()
    )
    cols = [(bp, ax) for bp in nodes for ax in ("x", "y")] + list(nodes)
    if include_angles:
        cols += [tuple(b) for b in graph.bridge_names]
    cols += [pair_names[i] for i in keep]

    owner = np.zeros((len(animal_ids), len(cols)), bool)
    for ai, aid in enumerate(animal_ids):
        if not aid:
            owner[ai, :] = True
            continue
        for j, c in enumerate(cols):
            if isinstance(c, tuple) and len(c) == 2 and c[1] in ("x", "y"):
                parts = [c[0]]
            elif isinstance(c, str):
                parts = [c]
            else:
                parts = list(c)
            owner[ai, j] = all(str(p).startswith(aid) for p in parts)
    return cols, pairs, bridges, owner


def area_polygons(graph: BodyGraph, animal_ids: Sequence[str]):
    """(vertex index tuples, area names) of every animal's body-area
    polygons, in the order of the areas table's columns."""
    polys, names = [], []
    for aid in animal_ids:
        for area, poly in graph.area_polys.get(aid, {}).items():
            polys.append(tuple(int(i) for i in poly))
            names.append(f"{aid}_{area}" if aid else area)
    return tuple(polys), names


def _feature_pass(pos, pairs, bridges, polys, device="cuda"):
    """All-pairs distances, bridge angles and body-area polygon areas of one
    recording in one device pass (deepof_tpu/data.py:159).

    Args:
        pos: (T, B, 2) mm positions.
        pairs / bridges / polys: index tuples into the node axis.

    Returns:
        (distances (T, P), angles (T, A), areas (T, n_areas)) on ``device``.
    """
    dev = resolve_device(device)
    pos = to_device(pos, dev, working_dtype(dev, pos.dtype))
    t = pos.shape[0]
    dists = pairwise_distances(pos, np.asarray(pairs, np.int32).reshape(-1, 2))
    angles = (bridge_angles(pos, np.asarray(bridges, np.int32).reshape(-1, 3)) if len(bridges)
              else pos.new_zeros((t, 0)))
    areas = (torch.stack([polygon_areas(pos, np.asarray(p, np.int32)) for p in polys], dim=1) if polys
             else pos.new_zeros((t, 0)))
    return dists, angles, areas


class _DerivedKinematics:
    """Distances, angles and areas of each recording, computed on the device
    on first access (``_feature_pass``) and kept in a small LRU of device
    triples; only the columns a getter keeps cross to the host. ``tables``
    is the project's own positions dict, so a pickle stores it once; the
    device cache is dropped (deepof_tpu/data.py:231)."""

    def __init__(self, tables, pairs, bridges, polys, device="cuda", cache_size: int = 4):
        self._tables = tables
        self._pairs = tuple(map(tuple, pairs))
        self._bridges = tuple(map(tuple, bridges))
        self._polys = tuple(tuple(int(i) for i in p) for p in polys)
        self._device = device
        self._cache_size = int(cache_size)
        self._cache = OrderedDict()

    def parts(self, key):
        trip = self._cache.pop(key, None)
        if trip is None:
            trip = _feature_pass(self._tables[key], self._pairs, self._bridges, self._polys, self._device)
        self._cache[key] = trip
        while len(self._cache) > self._cache_size:
            self._cache.popitem(last=False)
        return trip

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_cache"] = OrderedDict()
        return state


def _gather_columns_device(arr: torch.Tensor, keep_idx, n_cols: int) -> torch.Tensor:
    """The kept columns of a (T, C) device table, gathered on the device
    (deepof_tpu/data.py:302)."""
    if len(keep_idx) == n_cols:
        return arr
    return arr.index_select(1, torch.as_tensor(np.asarray(keep_idx, np.int64), device=arr.device))


def _host_f64(x: torch.Tensor) -> np.ndarray:
    """A writable float64 host copy of a device table."""
    return np.array(x.cpu().numpy(), dtype=np.float64)


def _frame(arr: np.ndarray, columns, dtype: torch.dtype = None) -> LazyFrame:
    """A host frame; ``dtype``, the device table's, is kept as its ``dtype``."""
    return LazyFrame(lambda: arr, columns, len(arr), None if dtype is None else str(dtype).replace("torch.", ""))


def _first_value(table, name):
    """The first value of column ``name`` of a condition or start-marker
    table (a DataFrame or a mapping of sequences)."""
    column = table[name]
    return column.iloc[0] if hasattr(column, "iloc") else np.asarray(column).ravel()[0]


# --------------------------------------------------------------------------- #
# Project
# --------------------------------------------------------------------------- #

_ARENA_DETECTION = (
    "arena detection and manual annotation (SAM, OpenCV) are not ported yet: ROADMAP "
    "queue 1 item 7; pass test=True for the fixed test arenas or arena_path for saved "
    "arena data"
)


class Project:
    """Loads and preprocesses the motion-tracking tables of one or more
    animals (port of deepof_tpu/data.py:388).

    The same public surface as the JAX package's Project, with ``device``
    (default "cuda"; it raises without a GPU unless given "cpu"). Preprocess
    runs in float64 on the CPU (``precision`` "auto" or "float64") and in
    float32 on the card.
    """

    def __init__(
        self,
        animal_ids: List = None,
        arena: str = "polygonal-autodetect",
        bodypart_graph: Union[str, dict] = "deepof_14",
        iterative_imputation: str = "partial",
        exclude_bodyparts: List = tuple([""]),
        exp_conditions: dict = None,
        start_markers: dict = None,
        remove_outliers: bool = True,
        interpolation_limit: int = 5,
        interpolation_std: int = 3,
        likelihood_tol: float = 0.75,
        model: str = "mouse_topview",
        project_name: str = "deepof_project",
        project_path: str = os.path.join("."),
        video_path: str = None,
        table_path: str = None,
        rename_bodyparts: list = None,
        sam_checkpoint_path: str = None,
        smooth_alpha: float = 1,
        table_format: str = "autodetect",
        video_format: str = ".mp4",
        video_scale: str = None,
        number_of_rois: int = 0,
        frame_rate: float = None,
        fast_implementations_threshold: int = 50000,
        precision: str = "auto",
        device="cuda",
    ):
        if precision not in ("auto", "float32", "float64"):
            raise ValueError(f"precision must be auto, float32 or float64, got {precision!r}")
        resolve_device(device)
        self.device = device
        self.precision = precision
        self.version = config.CURRENT_VERSION
        self.project_path = project_path
        self.project_name = project_name
        self.video_path = video_path
        self.table_path = table_path
        self.source_table_path = table_path
        self.trained_path = os.path.join(project_path, project_name, "trained_models")
        self.fast_implementations_threshold = fast_implementations_threshold

        # --- file discovery -------------------------------------------- #
        self.table_format = table_format
        if self.table_format != "analysis.h5":
            self.table_format = self.table_format.replace(".", "")
        if self.table_format == "autodetect":
            known = ("analysis.h5", "h5", "csv", "npy", "slp")
            candidates = [
                f for f in os.listdir(self.source_table_path)
                if os.path.isfile(os.path.join(self.source_table_path, f))
                and not f.startswith(".") and f.endswith(known)
            ]
            if not candidates:
                raise ValueError(
                    f"No tracking tables ({'/'.join(known)}) found in {self.source_table_path}"
                )
            # Majority format wins; ties break by the ``known`` order.
            counts = {ext: sum(f.endswith(ext) for f in candidates) for ext in known}
            counts["h5"] -= counts["analysis.h5"]
            self.table_format = max(known, key=lambda e: counts[e])

        video_list = natural_sorted(
            [v for v in os.listdir(self.video_path) if v.endswith(video_format) and not v.startswith(".")]
        )
        table_list = natural_sorted(
            [t for t in os.listdir(self.source_table_path)
             if t.endswith(self.table_format) and not t.startswith(".")]
        )
        if len(video_list) != len(table_list):
            raise ValueError("Unequal number of videos and tables. Please check your file structure")
        self.tables, self.videos = {}, {}
        for i, tab in enumerate(table_list):
            m = re.findall("(.*?)DLC", tab)
            key = m[0] if m else tab.split(".")[0]
            self.tables[key] = tab
            self.videos[key] = video_list[i]

        # --- frame rate: given, or 25 fps (videos are never opened) ------ #
        if frame_rate is not None:
            self.frame_rate = frame_rate
        else:
            warnings.warn(
                "Could not read a frame rate from the videos; defaulting to 25 fps. "
                "Pass frame_rate explicitly to override."
            )
            self.frame_rate = 25.0

        # --- arena dims ------------------------------------------------ #
        self.arena = arena
        pattern = re.compile(r"[+-]?(?:\d+(?:\.\d+)?|\.\d+)\s+\S+")
        if not (isinstance(video_scale, str) and pattern.fullmatch(video_scale)):
            raise ValueError('Please enter video_scale as "[value] [unit]", e.g. "380 mm"')
        value, unit = video_scale.split(" ")
        self.arena_dims = float(value) * config.DistanceUnit[unit].value
        if self.arena_dims < 50 or self.arena_dims > 5000:
            warnings.warn(f"The arena dimension you entered is {self.arena_dims} mm.")
        self.number_of_rois = number_of_rois

        # Frame counts come from the tables, once create() has read them.
        self.run_numba = False
        self.very_large_project = False

        # --- bodypart renaming ----------------------------------------- #
        rename_dict = None
        if rename_bodyparts is not None and isinstance(rename_bodyparts, list) and "npy" not in table_format:
            preset = {8: "deepof_8", 11: "deepof_11", 14: "deepof_14"}.get(len(rename_bodyparts))
            if preset is None:
                raise NotImplementedError("Number of custom bodypart names should be 8, 11 or 14.")
            nodes = connect_mouse(graph_preset=preset).nodes
            rename_dict = {custom: canonical for canonical, custom in zip(nodes, rename_bodyparts)}
        elif "npy" in table_format:
            rename_dict = {bp: bp for bp in (rename_bodyparts or [])}

        self.animal_ids = animal_ids if animal_ids not in (None, "") else [""]
        if isinstance(self.animal_ids, str):
            self.animal_ids = [self.animal_ids]
        self.bodypart_graph = bodypart_graph
        self.connectivity = None
        # Optional ego bodypart: distances restricted to pairs involving it.
        self.ego = False
        self.exp_conditions = exp_conditions
        if isinstance(exp_conditions, str):
            self.load_exp_conditions(exp_conditions)
        self.start_markers = start_markers
        if isinstance(start_markers, str):
            self.load_start_markers(start_markers)
        self.remove_outliers = remove_outliers
        self.interpolation_limit = interpolation_limit
        self.interpolation_std = interpolation_std
        self.likelihood_tolerance = likelihood_tol
        self.model = model
        self.smooth_alpha = smooth_alpha
        self.video_format = video_format
        self.iterative_imputation = iterative_imputation
        self.exclude_bodyparts = exclude_bodyparts
        self.segmentation_path = sam_checkpoint_path
        self.rename_bodyparts_dict = rename_dict

    def __str__(self):
        return f"deepof_tpu_torch analysis of {len(self.videos)} videos"

    __repr__ = __str__

    def load_exp_conditions(self, filepath: str):
        """Read the experimental conditions from a csv (io/conditions.py)."""
        self.exp_conditions = load_exp_conditions(filepath)

    def load_start_markers(self, filepath: str):
        """Read the start markers from a csv, frame integers taken at the
        project's frame rate (io/conditions.py)."""
        self.start_markers = load_start_markers(filepath, self.frame_rate)

    def set_up_project_directory(self, debug: bool = False):
        """Create the output directory tree."""
        root = os.path.join(self.project_path, self.project_name)
        for sub in ("Tables", "Coordinates", "Figures", "Arena_detection", "trained_models"):
            os.makedirs(os.path.join(root, sub), exist_ok=True)

    def _load_raw_tables(self) -> Dict[str, RawTable]:
        raws = {}
        found_individuals = None
        for key, tab in self.tables.items():
            raw = load_table(
                tab, self.source_table_path, self.table_format,
                self.rename_bodyparts_dict, self.animal_ids,
            )
            if found_individuals is None:
                found_individuals = raw.has_individuals
            elif raw.has_individuals != found_individuals:
                raise ValueError(f"Table {key} has inconsistent 'individuals' formatting!")
            if raw.has_individuals and len(self.animal_ids) == 1:
                self.animal_ids = list(raw.animal_ids)
            raws[key] = raw
        return raws

    def _build_graph(self, bodyparts: Sequence[str]) -> BodyGraph:
        exclude = [bp for bp in self.exclude_bodyparts if bp]
        return build_body_graph(
            bodyparts, animal_ids=self.animal_ids, graph_preset=self.bodypart_graph,
            exclude_bodyparts=exclude or None,
        )

    def preprocess_tables(self, raws: Dict[str, RawTable], verbose: bool = False):
        """Smoothing, outlier removal, imputation and missing-animal masking:
        one ``_preprocess_positions`` program per recording, all queued on
        the device before the results are read back.

        Returns ({key: (T, B, 2) positions}, {key: (T, B) likelihoods}), host
        arrays; sets ``self._presence`` ({key: (T, A) bool}).
        """
        sample = next(iter(raws.values()))
        graph = self._build_graph(sorted(sample.bodyparts))
        self.body_graph = graph
        exclude = [bp for bp in self.exclude_bodyparts if bp] or None
        self.connectivity = {
            aid: connect_mouse(aid if aid else None, exclude_bodyparts=exclude,
                               graph_preset=self.bodypart_graph)
            for aid in self.animal_ids
        }
        nodes = list(graph.nodes)
        animal_slices = []
        for aid in self.animal_ids:
            cols = [i for i, bp in enumerate(nodes) if (bp.startswith(f"{aid}_") if aid else True)]
            animal_slices.append((min(cols), max(cols) + 1))
        self._animal_slices = tuple(animal_slices)

        do_smooth = bool(self.smooth_alpha)
        polyorder = 15 - int(self.smooth_alpha) if do_smooth else 0
        dev = resolve_device(self.device)
        dtype = np.float64 if (dev.type == "cpu" and self.precision != "float32") else np.float32

        pending = []
        for key, raw in raws.items():
            ordered = raw.reorder(nodes)
            edges = None
            if do_smooth:
                t_total = ordered.positions.shape[0]
                edges = savgol_edges_host(ordered.positions.reshape(t_total, -1), 15, polyorder)
            out_pos, presence = _preprocess_positions(
                ordered.positions.astype(dtype), ordered.likelihood.astype(dtype), edges,
                do_smooth, 15, polyorder, bool(self.remove_outliers),
                float(self.likelihood_tolerance), float(self.interpolation_std),
                3,  # lin_interp_limit (deepof/utils.py:230)
                self._animal_slices, device=dev,
            )
            if self.iterative_imputation == "full":
                out_pos = self._full_imputation(out_pos, presence)
            pending.append((key, out_pos, presence, np.asarray(ordered.likelihood, dtype)))

        tab_dict, lik_dict, presence_dict = {}, {}, {}
        for key, out_pos, presence, lik in pending:
            tab_dict[key] = out_pos.cpu().numpy()
            presence_dict[key] = presence.cpu().numpy()
            lik_dict[key] = lik
        self._presence = presence_dict
        return tab_dict, lik_dict

    def _full_imputation(self, pos: torch.Tensor, presence: torch.Tensor) -> torch.Tensor:
        """Iterative ridge + Kalman/RTS + skeleton constraints for the gaps
        that linear interpolation left (deepof_tpu/data.py:770-818), on
        ``pos``'s device, in float32 whatever its dtype, written back in
        place. Per animal, the block is its columns over the frames where
        it is present; a block without NaN, of fewer than 2 frames or
        without a complete frame is left as it is (the last with a
        warning)."""
        edges_all = [(int(i), int(j)) for i, j in self.body_graph.edges]
        for ai, aid in enumerate(self.animal_ids):
            lo, hi = self._animal_slices[ai]
            rows = torch.nonzero(presence[:, ai]).flatten()
            block = pos[rows, lo:hi]  # (Tp, Ba, 2)
            if block.shape[0] < 2 or not bool(torch.isnan(block).any()):
                continue
            edges = [(i - lo, j - lo) for i, j in edges_all if lo <= i < hi and lo <= j < hi]
            try:
                constraints = imputation.estimate_skeleton_constraints(block, edges)
            except ValueError:
                warnings.warn(f"Animal {aid} has not enough data. Skipping full imputation.")
                continue
            original = torch.isfinite(block)
            t_p, b_a, _ = block.shape
            block32 = block.to(torch.float32)
            imputed = imputation.iterative_ridge_impute(block32.reshape(t_p, -1)).reshape(t_p, b_a, 2)
            imputed = torch.where(original, block32, imputed)
            smoothed = torch.where(original, block32, imputation.kalman_rts_smooth(imputed))
            constrained = imputation.enforce_skeleton_constraints(smoothed, constraints, original)
            pos[rows, lo:hi] = constrained.to(pos.dtype)
        return pos

    def get_arena(self, tables=None, arena_path: str = None, debug: bool = False,
                  test: bool = False, verbose: bool = False, load_also_rois: bool = False):
        """Arena calibration: saved arena data from ``arena_path``, or the
        fixed arenas of test mode. Returns (scales, arena_params, roi_dicts,
        video_resolution)."""
        if arena_path is not None:
            roi_dicts, arena_params, scales, video_resolution = self.load_arena_data(
                arena_path, load_also_rois=True
            )
            if roi_dicts is None:
                if self.number_of_rois > 0:
                    raise ValueError(
                        f"Project expects {self.number_of_rois} ROIs but the arena file "
                        f"'{arena_path}' contains none"
                    )
                roi_dicts = {key: {} for key in arena_params}
            self.scales = scales
            return scales, arena_params, roi_dicts, video_resolution
        if not test:
            raise NotImplementedError(_ARENA_DETECTION)
        out = fixture_arenas(self.arena)
        self.scales = out[0]
        return out

    def save_arena_data(self, arena_path: str, arena_params: dict = None, roi_dicts: dict = None,
                        scales: dict = None, video_resolution: dict = None) -> None:
        """Persist arena parameters / ROIs / scales as one pickle."""
        os.makedirs(os.path.dirname(os.path.abspath(arena_path)), exist_ok=True)
        payload = {"roi_dicts": roi_dicts, "arena_params": arena_params,
                   "scales": scales, "video_resolution": video_resolution}
        with open(arena_path, "wb") as f:
            pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)

    def load_arena_data(self, arena_path: str, load_also_rois: bool = False):
        """(roi_dicts, arena_params, scales, video_resolution) from a pickle
        this program wrote, checked against the project's videos."""
        if not os.path.isfile(arena_path):
            raise FileNotFoundError(f"Arena file not found: {arena_path}")
        with open(arena_path, "rb") as f:
            data = pickle.load(f)
        if isinstance(data, dict) and {"roi_dicts", "arena_params", "scales"} <= set(data):
            roi_dicts, arena_params, scales = data["roi_dicts"], data["arena_params"], data["scales"]
            video_resolution = data.get("video_resolution")
        elif isinstance(data, (tuple, list)) and len(data) == 4:
            roi_dicts, arena_params, scales, video_resolution = data
        else:
            raise ValueError("Invalid arena pickle format.")
        if set(arena_params) != set(self.videos):
            raise ValueError("Keys of Arena objects do not match project keys, could not load arena info")
        return (roi_dicts if load_also_rois else None), arena_params, scales, video_resolution

    def create(self, verbose: bool = True, force: bool = False, debug: bool = False,
               test: bool = False, arena_path: str = None) -> "Coordinates":
        """Read the tables, preprocess them, calibrate the arena, scale to mm
        and return (and save) the project's Coordinates."""
        project_dir = os.path.join(self.project_path, self.project_name)
        coord_dir = os.path.join(project_dir, "Coordinates")
        if os.path.exists(coord_dir) and os.listdir(coord_dir) and not force:
            raise OSError("Project already exists. Use force=True to overwrite.")
        self.set_up_project_directory(debug=debug)

        raws = self._load_raw_tables()
        frames = [raw.positions.shape[0] for raw in raws.values()]
        self.run_numba = sum(frames) > self.fast_implementations_threshold
        self.very_large_project = (
            max(frames) > config.VERY_LARGE_VIDEO_FRAMES
            or sum(frames) > config.VERY_LARGE_TOTAL_FRAMES
        )
        tab_dict, lik_dict = self.preprocess_tables(raws, verbose=verbose)
        scales, arena_params, roi_dicts, video_resolution = self.get_arena(
            arena_path=arena_path, test=test,
        )
        for key in tab_dict:  # pixel -> mm
            tab_dict[key] = tab_dict[key] * (scales[key][3] / scales[key][2])

        nodes = list(self.body_graph.nodes)
        _, area_names = area_polygons(self.body_graph, self.animal_ids)
        if any(len(self.body_graph.area_polys.get(aid, {})) != 4 for aid in self.animal_ids):
            warnings.warn("Not all areas could be computed with the available bodyparts.")

        coordinates = Coordinates(
            project_path=self.project_path, project_name=self.project_name,
            animal_ids=self.animal_ids, arena=self.arena, arena_dims=self.arena_dims,
            bodypart_graph=self.bodypart_graph, body_graph=self.body_graph, nodes=nodes,
            pair_names=pair_names_of(nodes), bridge_names=list(self.body_graph.bridge_names),
            area_names=area_names, path=self.project_path, quality=lik_dict, scales=scales,
            frame_rate=self.frame_rate, arena_params=arena_params, roi_dicts=roi_dicts,
            tables=tab_dict, presence=self._presence, source_table_path=self.source_table_path,
            table_paths=list(self.tables.values()), trained_model_path=self.trained_path,
            videos=self.videos, video_path=self.video_path, video_resolution=video_resolution,
            connectivity=self.connectivity, excluded_bodyparts=list(self.exclude_bodyparts),
            exp_conditions=self.exp_conditions, start_markers=self.start_markers,
            number_of_rois=self.number_of_rois, run_numba=self.run_numba,
            very_large_project=self.very_large_project, ego=self.ego, version=self.version,
            device=self.device,
        )
        coordinates.reset_supervised_parameters(save=False)
        coordinates.save(timestamp=False)
        if verbose:
            print("Done!")
        return coordinates

    def scale_tables(self, tab_dict: dict) -> dict:
        """Pixel tables -> mm with the arena scales (deepof_tpu/data.py:945),
        each table multiplied on the project's device in its own dtype: a
        numpy table comes back as numpy, a tensor stays on its device.
        Needs the scales that :meth:`get_arena` (or ``create``) sets."""
        scales = getattr(self, "scales", None)
        if scales is None:
            raise ValueError(
                "run get_arena() (or create()) before scale_tables(): per-video "
                "px->mm scales are produced by arena detection"
            )
        dev = resolve_device(self.device)
        out = {}
        for key, tab in tab_dict.items():
            ratio = scales[key][3] / scales[key][2]
            if isinstance(tab, torch.Tensor):
                out[key] = tab * ratio
            else:
                arr = np.asarray(tab)
                out[key] = (torch.as_tensor(arr, device=dev) * ratio).cpu().numpy()
        return out

    def extend(self, project_to_extend: str, video_path: str = None, table_path: str = None,
               verbose: bool = True, debug: bool = False, test: bool = False) -> "Coordinates":
        """Extend a saved project with this project's new recordings
        (deepof_tpu/data.py:1108): only the keys absent from the saved
        Coordinates are processed, then merged into it and saved. Their
        videos and tables are copied into the saved project's folders."""
        previous = load_project(project_to_extend)
        if previous._number_of_rois != self.number_of_rois:
            raise ValueError("Cannot extend: the number of ROIs must match.")
        new_keys = sorted(set(self.videos) - set(previous._videos))
        if verbose:
            print(f"Processing data from {len(new_keys)} new experiments...")
        if not new_keys:
            return previous
        self.videos = {k: self.videos[k] for k in new_keys}
        self.tables = {k: self.tables[k] for k in new_keys}
        video_path = self.video_path if video_path is None else video_path
        table_path = self.source_table_path if table_path is None else table_path
        for src, dst, files in ((video_path, previous._video_path, self.videos.values()),
                                (table_path, previous._source_table_path, self.tables.values())):
            if os.path.abspath(src) != os.path.abspath(dst):
                for name in files:
                    shutil.copy2(os.path.join(src, name), os.path.join(dst, name))
        self.video_path = previous._video_path
        self.source_table_path = previous._source_table_path

        new_coords = self.create(verbose=verbose, force=True, debug=debug, test=test)
        for attr in ("_tables", "_quality", "_presence", "_scales", "_arena_params", "_videos",
                     "_video_resolution"):
            getattr(previous, attr).update(getattr(new_coords, attr))
        if previous._roi_dicts is not None and new_coords._roi_dicts is not None:
            previous._roi_dicts.update(new_coords._roi_dicts)
        if new_coords._exp_conditions:
            previous._exp_conditions = {**(previous._exp_conditions or {}), **new_coords._exp_conditions}
        previous.save(timestamp=False)
        return previous

    # -- the kinematic tables of any position tables ------------------- #

    def _as_tensor(self, tab) -> np.ndarray:
        """(T, B, 2) float64 positions from an array or from a coordinates
        LazyFrame with (bodypart, "x"|"y") columns."""
        if isinstance(tab, LazyFrame):
            cols = {c: i for i, c in enumerate(tab.columns)}
            idx = [[cols[(node, ax)] for ax in ("x", "y")] for node in self.body_graph.nodes]
            return np.asarray(tab.realize()[:, idx], np.float64)
        return np.asarray(tab, np.float64)

    def _derived_parts(self, tab_dict):
        """(store, pair names, bridge names, area names) over ``tab_dict``."""
        nodes = list(self.body_graph.nodes)
        polys, area_names = area_polygons(self.body_graph, self.animal_ids)
        tensors = {k: self._as_tensor(v) for k, v in tab_dict.items()}
        store = _DerivedKinematics(tensors, all_pair_indices(len(nodes)), self.body_graph.bridges, polys,
                                   self.device)
        return store, pair_names_of(nodes), [tuple(b) for b in self.body_graph.bridge_names], area_names

    def _derived_tables(self, tab_dict, part: int) -> dict:
        store, *names = self._derived_parts(tab_dict)
        return {key: _frame(_host_f64(store.parts(key)[part]), names[part]) for key in tab_dict}

    def get_distances(self, tab_dict) -> dict:
        """All-pairs bodypart distances of each table, {key: LazyFrame}
        (deepof_tpu/data.py:960)."""
        return self._derived_tables(tab_dict, 0)

    def get_distances_tab(self, tab) -> LazyFrame:
        """:meth:`get_distances` of one table."""
        return self.get_distances({"__tab__": tab})["__tab__"]

    def get_angles(self, tab_dict) -> dict:
        """Bridge angles (radians) of each table (deepof_tpu/data.py:976)."""
        return self._derived_tables(tab_dict, 1)

    def get_areas(self, tab_dict) -> dict:
        """Body-area polygon areas of each table (deepof_tpu/data.py:986)."""
        return self._derived_tables(tab_dict, 2)


# --------------------------------------------------------------------------- #
# Coordinates
# --------------------------------------------------------------------------- #


class Coordinates:
    """A processed project: per-recording mm keypoints (T, B, 2), presence
    and likelihoods on the host, with the project's metadata (port of
    deepof_tpu/data.py:1178). ``device`` is where its graph dataset and
    embeddings are computed."""

    def __init__(
        self, project_path, project_name, animal_ids, arena, arena_dims, bodypart_graph,
        body_graph: BodyGraph, nodes: List[str], pair_names: List[tuple],
        bridge_names: List[tuple], area_names: List[str], path,
        quality: Dict[str, np.ndarray], scales, frame_rate, arena_params, roi_dicts,
        tables: Dict[str, np.ndarray], presence: Dict[str, np.ndarray], source_table_path,
        table_paths, trained_model_path, videos, video_path, video_resolution,
        connectivity=None, excluded_bodyparts=None, exp_conditions=None, start_markers=None,
        number_of_rois: int = 0, run_numba: bool = False, very_large_project: bool = False,
        ego=False, version: str = None, device="cuda",
    ):
        self._project_path = project_path
        self._project_name = project_name
        self._animal_ids = animal_ids
        self._arena = arena
        self._arena_params = arena_params
        self._roi_dicts = roi_dicts
        self._arena_dims = arena_dims
        self._bodypart_graph = bodypart_graph
        self._body_graph = body_graph
        self._nodes = list(nodes)
        self._pair_names = pair_names
        self._bridge_names = bridge_names
        self._area_names = area_names
        self._excluded = excluded_bodyparts
        self._exp_conditions = exp_conditions
        self._start_markers = start_markers
        self._frame_rate = frame_rate
        self._path = path
        self._quality = quality
        self._scales = scales
        self._tables = tables
        self._presence = presence
        self._source_table_path = source_table_path
        self._table_paths = table_paths
        self._trained_model_path = trained_model_path
        self._videos = videos
        self._video_path = video_path
        self._video_resolution = video_resolution
        self._connectivity = connectivity
        self._number_of_rois = number_of_rois
        self._run_numba = run_numba
        self._very_large_project = very_large_project
        self._ego = ego
        self._version = version
        self._device = device

    def __str__(self):
        n = len(self._videos)
        return f"deepof_tpu_torch analysis of {n} video{'s' if n > 1 else ''}"

    __repr__ = __str__

    @property
    def _table_path(self):
        return os.path.join(self._project_path, self._project_name, "Tables")

    # ------------------------------------------------------------------ #
    # Metadata getters
    # ------------------------------------------------------------------ #

    def get_table_keys(self):
        return self._tables.keys()

    def get_start_times(self, start_marker: Optional[str] = None) -> Dict[str, str]:
        """Start time of each recording as "HH:MM:SS(.sss)": the given start
        marker's, else "00:00:00.000"."""
        if start_marker and self._start_markers:
            return {key: str(_first_value(self._start_markers[key], start_marker)) for key in self._tables}
        return {key: "00:00:00.000" for key in self._tables}

    @property
    def get_exp_conditions(self):
        """The experimental conditions of each recording, as given."""
        return self._exp_conditions

    def get_condition_values(self, exp_cond) -> list:
        """Sorted unique values of one experimental condition."""
        conditions = [
            _first_value(table, exp_cond) for table in (self._exp_conditions or {}).values()
            if exp_cond in getattr(table, "columns", table)
        ]
        if not conditions:
            raise ValueError(f"Given experiment condition {exp_cond} not in experiment conditions!")
        return list(np.unique(conditions))

    @property
    def get_start_markers(self):
        """The start markers of each recording, as given."""
        return self._start_markers

    def get_quality(self) -> TableDict:
        """Tracking likelihood of each bodypart, a (T, N) frame a recording."""
        tabs = {key: _frame(np.asarray(lik, np.float64), self._nodes) for key, lik in self._quality.items()}
        return TableDict(tabs, typ="quality", table_path=self._table_path, animal_ids=self._animal_ids)

    def get_arenas(self):
        return self._arena, [self._arena_dims], self._arena_params

    def get_rois(self) -> dict:
        """ROI polygons: {key: {roi_number: (V, 2) array}}."""
        if not self._roi_dicts:
            return {}
        return {key: {n: np.asarray(poly) for n, poly in rois.items()} for key, rois in self._roi_dicts.items()}

    def get_supervised_parameters(self) -> dict:
        if not hasattr(self, "_supervised_parameters"):
            self.reset_supervised_parameters()
        return copy.copy(self._supervised_parameters)

    def reset_supervised_parameters(self, save: bool = True):
        self._supervised_parameters = config.default_supervised_parameters(self._frame_rate)
        if save:
            self.save(timestamp=False)

    def set_supervised_parameters(self, hparams: dict = None):
        params = self.get_supervised_parameters()
        for k, v in (hparams or {}).items():
            if k in params:
                params[k] = v
            else:
                warnings.warn("At least one parameter name does not match any supervised parameter name.")
        self._supervised_parameters = params
        self.save(timestamp=False)

    def get_start_marker_values(self, start_marker, return_frames: bool = True) -> dict:
        """Each recording's start marker ``start_marker``: its frame index at
        the project's frame rate, or its time string."""
        starts = {}
        for key, table in (self._start_markers or {}).items():
            if start_marker not in getattr(table, "columns", table):
                raise ValueError(f"given start_marker is missing at key {key}")
            value = _first_value(table, start_marker)
            starts[key] = int(np.round(time_to_seconds(value) * self._frame_rate)) if return_frames else value
        return starts

    def get_end_times(self) -> Dict[str, str]:
        """The time stamp of each recording's last frame, "HH:MM:SS.sssssssss"."""
        return {key: seconds_to_time((len(tab) - 1) / self._frame_rate, cut_milliseconds=False)
                for key, tab in self._tables.items()}

    def get_table_lengths(self, tab_dict_for_binning=None, start_marker=None) -> Dict[str, int]:
        """Frame count per experiment, of this project or of a TableDict;
        with ``start_marker``, the frames from that marker on."""
        if tab_dict_for_binning is None:
            lengths = {key: len(tab) for key, tab in self._tables.items()}
        else:
            from deepof_tpu_torch.core.storage import get_dt

            lengths = {
                k: int(get_dt(tab_dict_for_binning, k, only_metainfo=True)["num_rows"])
                for k in tab_dict_for_binning.keys()
            }
        if start_marker is None:
            return lengths
        out = {}
        for key, full in lengths.items():
            start = np.round(time_to_seconds(_first_value(self._start_markers[key], start_marker)) * self._frame_rate)
            out[key] = int(np.round(full - start))
            if out[key] <= 0:
                raise ValueError(f"start marker {start_marker} at experiment {key} is exceeding the length "
                                 "of the experiment table!")
        return out

    def load_exp_conditions(self, filepath: str):
        """Read the experimental conditions from a csv (io/conditions.py)."""
        self._exp_conditions = load_exp_conditions(filepath)

    def load_start_markers(self, filepath: str):
        """Read the start markers from a csv (io/conditions.py)."""
        self._start_markers = load_start_markers(filepath, self._frame_rate)

    def save(self, filename: str = None, timestamp: bool = True, file: str = None):
        """Pickle the Coordinates object into the project's Coordinates folder."""
        filename = filename or file
        out_dir = os.path.join(self._project_path, self._project_name, "Coordinates")
        os.makedirs(out_dir, exist_ok=True)
        name = filename or "deepof_coordinates"
        if timestamp:
            from datetime import datetime

            name += datetime.now().strftime("%Y%m%d-%H%M%S")
        with open(os.path.join(out_dir, f"{name}.pkl"), "wb") as f:
            pickle.dump(self, f, protocol=5)

    # ------------------------------------------------------------------ #
    # Kinematic getters
    # ------------------------------------------------------------------ #

    @property
    def _derived(self) -> _DerivedKinematics:
        """The derived-kinematics store, built on first use (projects saved
        before it existed have none)."""
        store = self.__dict__.get("_derived_store")
        if store is None:
            polys, _ = area_polygons(self._body_graph, self._animal_ids)
            store = _DerivedKinematics(self._tables, all_pair_indices(len(self._nodes)),
                                       self._body_graph.bridges, polys, self._device)
            self._derived_store = store
        return store

    def _positions(self, key: str) -> torch.Tensor:
        """One recording's (T, B, 2) mm positions on the device."""
        dev = resolve_device(self._device)
        pos = self._tables[key]
        return to_device(pos, dev, working_dtype(dev, pos.dtype))

    def _table_dict(self, tabs, typ, **meta) -> TableDict:
        return TableDict(tabs, typ=typ, table_path=self._table_path, animal_ids=self._animal_ids,
                         connectivity=self._connectivity, exp_conditions=self._exp_conditions, **meta)

    def _own_columns(self, nodes, aid) -> List[int]:
        return [i for i, bp in enumerate(nodes) if (bp.startswith(aid) if aid else True)]

    def get_coords_at_key(
        self, key: str, scale=None, quality=None, center: Union[bool, str] = False, polar: bool = False,
        speed: int = 0, align: Union[bool, str] = False, align_group: bool = False, align_inplace: bool = True,
        to_video: bool = False, selected_id: str = None, roi_number: int = None, animals_in_roi=None,
        in_roi_criterion: str = "Center", invert_roi: bool = False, _device: bool = False,
    ):
        """Coordinates of one recording (deepof_tpu/data.py:1520), on the
        device: ROI filter -> animal selection -> polar -> centre (the
        arena's, or a bodypart's) -> ``to_video`` -> alignment -> speed ->
        the missing-animal NaN.

        Returns a LazyFrame with (bodypart, "x"|"y"|"rho"|"phi") columns, or
        bodypart columns with ``speed``; with ``_device=True`` the (T, C)
        device table and its column labels."""
        if scale is None:
            scale = self._scales[key]
        pos = self._positions(key)
        nodes = self._nodes
        if roi_number is not None:
            pos = self._apply_roi_mask(pos, key, roi_number, animals_in_roi, in_roi_criterion, invert_roi)

        animal_ids = [selected_id] if selected_id else list(self._animal_ids)
        if selected_id:
            node_idx = [i for i, bp in enumerate(nodes) if bp.startswith(selected_id)]
            pos = pos[:, node_idx]
            nodes = [nodes[i] for i in node_idx]

        def const(values):
            return torch.as_tensor(np.asarray(values, np.float64), dtype=pos.dtype, device=pos.device)

        if polar:
            work = to_polar(pos)
            if center == "arena":
                work = work - const([np.hypot(scale[0], scale[1]), np.arctan2(scale[1], scale[0])])
            elif isinstance(center, str) and center:
                work = self._center_on_bodypart(work, nodes, animal_ids, center)
        else:
            work = pos
            if center == "arena":
                work = work - const(scale[:2])
            elif isinstance(center, str) and center:
                work = self._center_on_bodypart(work, nodes, animal_ids, center)
            if to_video:
                work = work * (scale[2] / scale[3])

        col_order = nodes
        if align and align_inplace and not polar:
            work, col_order = self._align(work, nodes, animal_ids, align, align_group)
        out = rolling_speed(work, frame_rate=self._frame_rate, deriv=speed) if speed else work
        if speed:
            columns = list(col_order)
        else:
            axes = ("rho", "phi") if polar else ("x", "y")
            columns = [(bp, ax) for bp in col_order for ax in axes]
            out = out.reshape(out.shape[0], -1)
        return self._table(key, out, columns, _device)

    def _table(self, key, arr: torch.Tensor, columns, device: bool):
        """A getter's (T, C) device result with the missing-animal NaN: as
        (tensor, columns) when ``device``, else as a host LazyFrame."""
        arr = self._set_missing_animals(arr, columns, key)
        return (arr, columns) if device else _frame(_host_f64(arr), columns, arr.dtype)

    def get_coords(
        self, center: Union[bool, str] = False, polar: bool = False, speed: int = 0,
        align: Union[bool, str] = False, align_group: bool = False, align_inplace: bool = True,
        to_video: bool = False, selected_id: str = None, roi_number: int = None, animals_in_roi=None,
        in_roi_criterion: str = "Center", invert_roi: bool = False, file_name: str = "coords",
        return_path: bool = False,
    ) -> TableDict:
        """Coordinates of every recording (see :meth:`get_coords_at_key`):
        every recording's device work is queued before the first copy back."""
        pending = {
            key: self.get_coords_at_key(
                key, center=center, polar=polar, speed=speed, align=align, align_group=align_group,
                align_inplace=align_inplace, to_video=to_video, selected_id=selected_id,
                roi_number=roi_number, animals_in_roi=animals_in_roi, in_roi_criterion=in_roi_criterion,
                invert_roi=invert_roi, _device=True,
            )
            for key in self._tables
        }
        tabs = {}
        for key, (arr, columns) in pending.items():
            tab = _frame(_host_f64(arr), columns, arr.dtype)
            tabs[key] = save_dt(tab, os.path.join(self._table_path, key, f"{key}_{file_name}"), return_path)
        return self._table_dict(tabs, "coords", arena=self._arena, arena_dims=self._scales, center=center,
                                polar=polar)

    def _center_on_bodypart(self, work, nodes, animal_ids, center):
        """Each animal's positions minus its ``center`` bodypart's."""
        out = work.clone()
        for aid in animal_ids:
            bp_name = f"{aid}{'_' if aid else ''}{center}"
            if bp_name not in nodes:
                continue
            ci = nodes.index(bp_name)
            cols = self._own_columns(nodes, aid)
            out[:, cols, :] = out[:, cols, :] - out[:, ci:ci + 1, :]
        return out

    def _align(self, pos, nodes, animal_ids, align, align_group):
        """Each animal rotated so that its ``align`` bodypart lies on +y,
        that bodypart's columns first (deepof_tpu/data.py:1706). With
        ``align_group`` the other animals keep their column order and
        rotate about their first column (a reference quirk, kept). Entries
        under 1e-5 in magnitude snap to 0."""
        if len(animal_ids) <= 1:
            align_group = False
        first = animal_ids[0]
        blocks, col_order = [], []
        for aid in animal_ids:
            prefix = f"{aid}_" if aid else ""
            bp_name = f"{first}{'_' if first else ''}{align}" if align_group else f"{prefix}{align}"
            own = [bp for bp in nodes if (bp.startswith(prefix) if prefix else True)]
            ordered = [bp for bp in own if bp != bp_name]
            if aid == first or not align_group:
                ordered = [bp_name] + ordered
            aligned = align_trajectories(pos[:, [nodes.index(bp) for bp in ordered]], mode="all")
            blocks.append(torch.where(aligned.abs() < 1e-5, 0.0, aligned))
            col_order.extend(ordered)
        return torch.cat(blocks, dim=1), col_order

    def _roi_outside(self, base, key, roi_number, animals_in_roi, invert_roi, criterion="Center"):
        """{animal: (T,) bool device mask of the frames whose ``criterion``
        bodypart, in the device positions ``base``, lies outside ROI
        ``roi_number`` (inside with ``invert_roi``)}."""
        if isinstance(animals_in_roi, str):
            check = [animals_in_roi]
        else:
            check = animals_in_roi or self._animal_ids
        polygon = np.asarray(self._roi_dicts[key][roi_number])
        out = {}
        for aid in check:
            crit = f"{aid}{'_' if aid else ''}{criterion}"
            if crit not in self._nodes:
                continue
            inside = point_in_polygon(base[:, self._nodes.index(crit)], polygon)
            out[aid] = inside if invert_roi else ~inside
        return out

    def _apply_roi_mask(self, pos, key, roi_number, animals_in_roi, in_roi_criterion, invert_roi):
        """NaN each checked animal's bodyparts on the frames where its
        ``in_roi_criterion`` bodypart is outside the ROI."""
        outside = self._roi_outside(pos, key, roi_number, animals_in_roi, invert_roi, in_roi_criterion)
        pos = pos.clone()
        for aid, rows in outside.items():
            cols = self._own_columns(self._nodes, aid)
            pos[:, cols] = torch.where(rows[:, None, None], torch.nan, pos[:, cols])
        return pos

    def _roi_row_mask(self, key, roi_number, animals_in_roi, invert_roi) -> dict:
        """{animal: (T,) bool device mask of the frames whose Center lies
        outside the ROI} (deepof_tpu/data.py:2058)."""
        return self._roi_outside(self._positions(key), key, roi_number, animals_in_roi, invert_roi)

    def _set_missing_animals(self, arr: torch.Tensor, columns, key: str) -> torch.Tensor:
        """A (T, C) table with each animal's columns (``filter_columns``) NaN
        on the frames where it is absent, on the table's device; columns of
        no animal (inter-animal distances) are left."""
        presence = np.asarray(self._presence[key])
        n = min(len(arr), len(presence))
        where = {c: i for i, c in enumerate(columns)}
        for ai, aid in enumerate(self._animal_ids):
            absent = presence[:n, ai] == 0
            cols = [where[c] for c in (filter_columns(columns, aid) if aid else columns)]
            if not (cols and absent.any()):
                continue
            rows = np.zeros(len(arr), bool)
            rows[:n] = absent
            hit = np.zeros(len(columns), bool)
            hit[cols] = True
            rows, hit = (torch.as_tensor(m, device=arr.device) for m in (rows, hit))
            arr = torch.where(rows[:, None] & hit[None, :], torch.nan, arr)
        return arr

    def _distance_keep_idx(self, selected_id, filter_on_graph, pairs=None) -> list:
        """Kept distance columns: ego -> ``selected_id`` -> skeleton edges ->
        explicit ``pairs`` (deepof_tpu/data.py:1782)."""
        pair_cols = list(self._pair_names)
        if filter_on_graph:  # every filter keeps a column by itself, so they commute
            keep = distance_keep_idx(pair_cols, self._body_graph.edge_names, self._ego)
        else:
            keep = [i for i, c in enumerate(pair_cols) if not self._ego or any(self._ego in str(x) for x in c)]
        if selected_id:
            sel = set(filter_columns([pair_cols[i] for i in keep], selected_id))
            keep = [i for i in keep if pair_cols[i] in sel]
        if pairs is not None:
            wanted = {tuple(sorted(map(str, p))) for p in pairs}
            keep = [i for i in keep if tuple(sorted(map(str, pair_cols[i]))) in wanted]
        return keep

    def _angle_keep_idx(self, selected_id) -> list:
        angle_cols = [tuple(b) for b in self._bridge_names]
        if selected_id:
            sel = set(filter_columns(angle_cols, selected_id))
            return [i for i, c in enumerate(angle_cols) if c in sel]
        return list(range(len(angle_cols)))

    def _scalar_speed(self, arr: torch.Tensor, speed: int) -> torch.Tensor:
        """The (speed + 1)-th derivative of scalar columns, as the JAX
        package takes it for distances, angles and areas."""
        return rolling_speed(arr, frame_rate=self._frame_rate, deriv=speed + 1, is_coords=False)

    def get_distances_at_key(
        self, key: str, quality=None, speed: int = 0, selected_id: str = None, roi_number: int = None,
        animals_in_roi=None, invert_roi: bool = False, filter_on_graph: bool = True, pairs=None,
        _device: bool = False,
    ) -> LazyFrame:
        """Bodypart distances of one recording (deepof_tpu/data.py:1824):
        the kept columns gathered on the device, NaN where an animal's
        Center is outside the ROI (its own pairs), differentiated with
        ``speed``, then the missing-animal NaN. ``pairs`` keeps only the
        given (bodypart, bodypart) pairs; ``_device`` as in
        :meth:`get_coords_at_key`."""
        keep = self._distance_keep_idx(selected_id, filter_on_graph, pairs)
        columns = [self._pair_names[i] for i in keep]
        arr = _gather_columns_device(self._derived.parts(key)[0], keep, len(self._pair_names))
        if roi_number is not None:
            arr = arr.clone()
            for aid, rows in self._roi_row_mask(key, roi_number, animals_in_roi, invert_roi).items():
                cols = [j for j, c in enumerate(columns) if all(str(x).startswith(aid) for x in c)] if aid \
                    else list(range(len(columns)))
                arr[:, cols] = torch.where(rows[:, None], torch.nan, arr[:, cols])
        if speed:
            arr = self._scalar_speed(arr, speed)
        return self._table(key, arr, columns, _device)

    def get_distances(
        self, speed: int = 0, selected_id: str = None, roi_number: int = None, animals_in_roi=None,
        invert_roi: bool = False, filter_on_graph: bool = True, file_name: str = "got_distances",
        return_path: bool = False,
    ) -> TableDict:
        """Bodypart distances of every recording; with ``filter_on_graph``
        only the skeleton's edges (see :meth:`get_distances_at_key`)."""
        tabs = {}
        for key in self._tables:
            tab = self.get_distances_at_key(
                key, speed=speed, selected_id=selected_id, roi_number=roi_number,
                animals_in_roi=animals_in_roi, invert_roi=invert_roi, filter_on_graph=filter_on_graph,
            )
            tabs[key] = save_dt(tab, os.path.join(self._table_path, key, f"{key}_{file_name}"), return_path)
        return self._table_dict(tabs, "dists")

    def get_angles_at_key(
        self, key: str, quality=None, degrees: bool = False, speed: int = 0, selected_id: str = None,
        roi_number: int = None, animals_in_roi=None, invert_roi: bool = False, _device: bool = False,
    ) -> LazyFrame:
        """Bridge angles of one recording in radians (degrees with
        ``degrees``), differentiated with ``speed`` (deepof_tpu/data.py:1920).
        The ROI arguments are accepted and unused, as in the JAX package."""
        keep = self._angle_keep_idx(selected_id)
        columns = [tuple(self._bridge_names[i]) for i in keep]
        arr = _gather_columns_device(self._derived.parts(key)[1], keep, len(self._bridge_names))
        if degrees:
            arr = torch.rad2deg(arr)
        if speed:
            arr = self._scalar_speed(arr, speed)
        return self._table(key, arr, columns, _device)

    def get_angles(
        self, degrees: bool = False, speed: int = 0, selected_id: str = None, roi_number: int = None,
        animals_in_roi=None, invert_roi: bool = False, file_name: str = "got_angles", return_path: bool = False,
    ) -> TableDict:
        """Bridge angles of every recording (see :meth:`get_angles_at_key`)."""
        tabs = {}
        for key in self._tables:
            tab = self.get_angles_at_key(key, degrees=degrees, speed=speed, selected_id=selected_id,
                                         roi_number=roi_number, animals_in_roi=animals_in_roi,
                                         invert_roi=invert_roi)
            tabs[key] = save_dt(tab, os.path.join(self._table_path, key, f"{key}_{file_name}"), return_path)
        return self._table_dict(tabs, "angles")

    def get_areas_at_key(
        self, key: str, quality=None, speed: int = 0, selected_id: str = "all", roi_number: int = None,
        animals_in_roi=None, invert_roi: bool = False, _device: bool = False,
    ) -> LazyFrame:
        """Body-area polygon areas of one recording, one animal's or "all"
        (deepof_tpu/data.py:1992). The ROI arguments are accepted and
        unused, as in the JAX package."""
        keep = list(range(len(self._area_names)))
        if selected_id and selected_id != "all":
            keep = [i for i in keep if self._area_names[i].startswith(selected_id)]
        columns = [self._area_names[i] for i in keep]
        arr = _gather_columns_device(self._derived.parts(key)[2], keep, len(self._area_names))
        if speed:
            arr = self._scalar_speed(arr, speed)
        return self._table(key, arr, columns, _device)

    def get_areas(
        self, speed: int = 0, selected_id: str = "all", roi_number: int = None, animals_in_roi=None,
        invert_roi: bool = False, file_name: str = "got_areas", return_path: bool = False,
    ) -> TableDict:
        """Body-area polygon areas of every recording (see
        :meth:`get_areas_at_key`)."""
        tabs = {}
        for key in self._tables:
            tab = self.get_areas_at_key(key, speed=speed, selected_id=selected_id, roi_number=roi_number,
                                        animals_in_roi=animals_in_roi, invert_roi=invert_roi)
            tabs[key] = save_dt(tab, os.path.join(self._table_path, key, f"{key}_{file_name}"), return_path)
        return self._table_dict(tabs, "areas")

    def get_graph_dataset(self, *args, **kwargs):
        """See :func:`deepof_tpu_torch.graph_dataset.get_graph_dataset`."""
        from deepof_tpu_torch.graph_dataset import get_graph_dataset

        return get_graph_dataset(self, *args, **kwargs)

    def supervised_annotation(self, *args, **kwargs):
        """See :func:`deepof_tpu_torch.annotate.supervised_annotation`."""
        from deepof_tpu_torch.annotate import supervised_annotation

        return supervised_annotation(self, *args, **kwargs)

    def deep_unsupervised_embedding(self, *args, **kwargs):
        """See :func:`deepof_tpu_torch.train.harness.deep_unsupervised_embedding`."""
        from deepof_tpu_torch.train.harness import deep_unsupervised_embedding

        return deep_unsupervised_embedding(self, *args, **kwargs)

    def merged_graph_features_device(self, include_angles: bool = True, device=None):
        """Per-experiment merged graph-dataset frames on the device: arena-
        centred coordinates | speeds | bridge angles | skeleton-edge
        distances, NaN where a column's animal is absent; one
        ``_merged_features_program`` per recording (data.py:2152-2230).

        Returns ({key: (T, F) tensor}, columns).
        """
        dev = resolve_device(self._device if device is None else device)
        columns, pairs, bridges, owner = merged_feature_layout(
            self._body_graph, self._animal_ids, include_angles, self._ego
        )
        frames = {}
        for key, pos in self._tables.items():
            t = pos.shape[0]
            pres_h = np.asarray(self._presence[key])
            rows = min(t, pres_h.shape[0])
            pres = np.ones((t, len(self._animal_ids)), np.float32)
            pres[:rows] = pres_h[:rows]
            frames[key] = _merged_features_program(
                pos, pres, np.asarray(self._scales[key][:2], pos.dtype), owner, pairs, bridges,
                float(self._frame_rate), bool(include_angles), device=dev,
            )
        return frames, columns


def load_project(project_path: str) -> Coordinates:
    """Load the last saved Coordinates pickle of a project folder."""
    coord_dir = os.path.join(project_path, "Coordinates")
    candidates = sorted(f for f in os.listdir(coord_dir) if f.endswith(".pkl"))
    if not candidates:
        raise FileNotFoundError(f"No saved coordinates found in {coord_dir}")
    with open(os.path.join(coord_dir, candidates[-1]), "rb") as f:
        return pickle.load(f)
