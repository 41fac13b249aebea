"""The public pipeline of the port: ``Project`` (pose tables on disk ->
preprocessed keypoints of every recording) and ``Coordinates`` (the
processed project, and the merged graph-dataset frames built from it on the
device), with the two per-recording programs they run as plain functions
(port of ``deepof_tpu/data.py`` ``Project``, ``Coordinates``,
``_preprocess_positions`` and ``_merged_features_program``).

The programs take numpy arrays or tensors and a ``device``; they run in
float64 on the CPU when given float64 and in float32 otherwise. ``Project``
and ``Coordinates`` hold host numpy arrays only, so a project pickles; the
JAX package's pandas getters are not ported yet, and tables are numpy
arrays with their column lists beside them. Videos are never opened (the
machine with the card has no cv2): the frame rate is given or 25 fps, and
frame counts come from the tables.
"""

from __future__ import annotations

import os
import pickle
import re
import warnings
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from deepof_tpu_torch import config
from deepof_tpu_torch.arena import fixture_arenas
from deepof_tpu_torch.core.graph import BodyGraph, build_body_graph, connect_mouse
from deepof_tpu_torch.device import resolve_device, to_device, working_dtype
from deepof_tpu_torch.io.readers import RawTable, load_table, natural_sorted
from deepof_tpu_torch.ops.interp import masked_linear_interpolate
from deepof_tpu_torch.ops.kinematics import (
    all_pair_indices,
    bridge_angles,
    pairwise_distances,
    rolling_speed,
)
from deepof_tpu_torch.ops.outliers import remove_outliers
from deepof_tpu_torch.ops.smoothing import savgol_edges_host, savgol_smooth


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


# --------------------------------------------------------------------------- #
# Project
# --------------------------------------------------------------------------- #

_FULL_IMPUTATION = (
    'iterative_imputation="full" (Kalman/RTS smoothing, iterative ridge, skeleton '
    "constraints) is not ported yet: ROADMAP queue 1 item 11"
)
_ARENA_DETECTION = (
    "arena detection and manual annotation (SAM, OpenCV) are not ported yet: ROADMAP "
    "queue 1 item 7; pass test=True for the fixed test arenas or arena_path for saved "
    "arena data"
)
_CONDITIONS = "reading conditions or start markers from a file is not ported yet: ROADMAP queue 1 item 13"


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
        if iterative_imputation == "full":
            raise NotImplementedError(_FULL_IMPUTATION)
        if isinstance(exp_conditions, str) or isinstance(start_markers, str):
            raise NotImplementedError(_CONDITIONS)
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
        self.start_markers = start_markers
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
            pending.append((key, out_pos, presence, np.asarray(ordered.likelihood, dtype)))

        tab_dict, lik_dict, presence_dict = {}, {}, {}
        for key, out_pos, presence, lik in pending:
            tab_dict[key] = out_pos.cpu().numpy()
            presence_dict[key] = presence.cpu().numpy()
            lik_dict[key] = lik
        self._presence = presence_dict
        return tab_dict, lik_dict

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
        area_names = [
            f"{aid}_{area}" if aid else area
            for aid in self.animal_ids
            for area in self.body_graph.area_polys.get(aid, {})
        ]
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
        coordinates.save(timestamp=False)
        if verbose:
            print("Done!")
        return coordinates


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

    def get_table_lengths(self, tab_dict_for_binning=None) -> Dict[str, int]:
        """Frame count per experiment, of this project or of a TableDict."""
        if tab_dict_for_binning is None:
            return {key: len(tab) for key, tab in self._tables.items()}
        from deepof_tpu_torch.core.storage import get_dt

        return {
            k: int(get_dt(tab_dict_for_binning, k, only_metainfo=True)["num_rows"])
            for k in tab_dict_for_binning.keys()
        }

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

    def get_graph_dataset(self, *args, **kwargs):
        """See :func:`deepof_tpu_torch.graph_dataset.get_graph_dataset`."""
        from deepof_tpu_torch.graph_dataset import get_graph_dataset

        return get_graph_dataset(self, *args, **kwargs)

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
