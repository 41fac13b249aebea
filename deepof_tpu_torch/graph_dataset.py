"""Graph-dataset build: merged per-frame features -> scaled frames on the
device, the node / edge / angle column layout, the body graph's adjacency,
and the windowed training tensors (port of ``deepof_tpu/graph_dataset.py``).

Two lanes, as in the JAX package. The fused lane (no animal selection,
alignment, polar coordinates or time bins; the standard scaler with
per-column modes) builds each recording's merged frame in one device
program (``Coordinates.merged_graph_features_device``). The other lane runs
the getters' device route (arena-centred, aligned coordinates, speeds,
angles, skeleton-edge distances, for the selected animal) and merges their
tables on the device; a ``precomputed_tab_dict`` takes the place of those
tables. Either way ``TableDict.preprocess`` scales the frames
where they lie, and windows exist on the host only when a caller reads the
returned training tensors.

In paths mode (``return_as_paths``, by default a very large project's) the
fused lane is off: the getters, ``merge`` and ``preprocess`` write their
tables to files under the project's table path, no scaled frame is kept
for ``embedding_per_video`` (it scales again), and each recording's
windows are a pointer to its scaled frame written once with the column
groups (:func:`deepof_tpu_torch.core.storage.save_windows`), where the JAX
package writes the windows themselves.
"""

from __future__ import annotations

import numpy as np

from deepof_tpu_torch.core.graph import connect_mouse
from deepof_tpu_torch.core.storage import POINTER_KEY, LazyWindows, frame_windows, get_dt, is_pointer, save_windows
from deepof_tpu_torch.core.table_dict import TableDict, _device_lazy, _device_scale_applicable
from deepof_tpu_torch.device import resolve_device


def reorder_and_reshape(data: np.ndarray) -> np.ndarray:
    """(B, W, 3N) node-feature stack -> (B, W, N, 3) with channels
    (x, y, speed)."""
    if data.shape[2] % 3:
        raise ValueError("Node feature count is not a multiple of 3")
    n = data.shape[2] // 3
    return np.stack([data[:, :, :n], data[:, :, n:2 * n], data[:, :, 2 * n:]], axis=-1)


def feature_graph(coordinates, animal_id=None):
    """The skeleton restricted to the project's bodyparts: its sorted
    nodes, its sorted edges and its (N, N) int64 adjacency in that node
    order (what ``nx.adjacency_matrix(graph, nodelist=nodes)`` gives)."""
    graph = connect_mouse(
        animal_ids=(coordinates._animal_ids if animal_id is None else animal_id),
        exclude_bodyparts=[bp for bp in (coordinates._excluded or []) if bp] or None,
        graph_preset=coordinates._bodypart_graph,
    )
    graph.remove_nodes_from([n for n in graph.nodes if n not in set(coordinates._nodes)])
    nodes = sorted(graph.nodes)
    edges = sorted(tuple(sorted(e)) for e in graph.edges())
    idx = {n: i for i, n in enumerate(nodes)}
    adjacency = np.zeros((len(nodes), len(nodes)), np.int64)
    for a, b in edges:
        adjacency[idx[a], idx[b]] = adjacency[idx[b], idx[a]] = 1
    return graph, nodes, edges, adjacency


def _getter_tables(coordinates, animal_id, align, polar, include_angles, device):
    """The non-fused lane's merged TableDict (graph_dataset.py:116-146):
    per recording, the getters' device tables of ``animal_id`` (every
    animal for None) -- arena-centred coordinates aligned on ``align`` (the
    group aligned on the first animal's), speeds at 1, bridge angles (with
    ``include_angles``) and skeleton-edge distances -- merged on the device
    in that order. Returns (merged TableDict, the selected animal's angle
    column labels)."""
    dev = resolve_device(coordinates._device if device is None else device)
    getters = {
        "coords": lambda key: coordinates.get_coords_at_key(
            key, selected_id=animal_id, center="arena", align=align, align_group=True, polar=polar,
            _device=True),
        "speeds": lambda key: coordinates.get_coords_at_key(key, selected_id=animal_id, speed=1, _device=True),
        "angles": lambda key: coordinates.get_angles_at_key(key, selected_id=animal_id, _device=True),
        "dists": lambda key: coordinates.get_distances_at_key(key, selected_id=animal_id, _device=True),
    }
    parts = {}
    for name in ("coords", "speeds", "angles", "dists") if include_angles else ("coords", "speeds", "dists"):
        td = TableDict({}, typ=name, table_path=coordinates._table_path)
        td._device_frames = {}
        for key in coordinates._tables:
            arr, columns = getters[name](key)
            td._device_frames[key] = arr = arr.to(dev)
            td[key] = _device_lazy(arr, columns)
        parts[name] = td
    coords = parts.pop("coords")
    coords._animal_ids, coords._connectivity = coordinates._animal_ids, coordinates._connectivity
    merged = coords.merge(*parts.values())
    angle_names = [tuple(coordinates._bridge_names[i]) for i in coordinates._angle_keep_idx(animal_id)]
    return merged, angle_names


def _getter_files(coordinates, animal_id, align, polar, include_angles):
    """The paths-mode lane's merged TableDict (graph_dataset.py:116-146 with
    ``return_path``): the getters' tables of the device lane written to
    files (``{key}_coords``, ``{key}_speed``, ``{key}_got_angles``,
    ``{key}_got_distances``) and merged into ``{key}_merged``, every value a
    pointer. Returns (merged TableDict, the angle column labels)."""
    coords = coordinates.get_coords(selected_id=animal_id, center="arena", align=align, align_group=True,
                                    polar=polar, return_path=True)
    speeds = coordinates.get_coords(selected_id=animal_id, speed=1, file_name="speed", return_path=True)
    dists = coordinates.get_distances(selected_id=animal_id, return_path=True)
    angles = coordinates.get_angles(selected_id=animal_id, return_path=True)
    angle_names = list(get_dt(angles, next(iter(angles)), only_metainfo=True)["columns"])
    merged = coords.merge(speeds, *([angles] if include_angles else []), dists, save_as_paths=True)
    return merged, angle_names


def _matching(names, feature_names) -> list:
    return [j for n in names for j, f in enumerate(feature_names) if n == f]


def get_graph_dataset(
    coordinates,
    animal_id: str = None,
    window_size: int = None,
    bin_size=None,
    bin_index=None,
    precomputed_bins=None,
    samples_max: int = 227272,
    precomputed_tab_dict=None,
    center: str = False,
    polar: bool = False,
    align: str = None,
    preprocess: bool = True,
    include_angles: bool = True,
    scale: str = "standard",
    dist_standardize: str = "per_column",
    speed_standardize: str = "per_column",
    coord_standardize: str = "per_column",
    return_as_paths: bool = None,
    device=None,
    **kwargs,
):
    """The training dataset of the graph-aware sequence models.

    Returns ((train, test) TableDicts of LazyWindows (node, edge, angle)
    window tensors, metainfo, adjacency (N, N) int64, the merged TableDict
    (LazyFrames, with the scaled frames stashed for
    ``embedding_per_video``), global_scaler). ``device`` defaults to the
    project's. With ``return_as_paths`` (default: the project's
    ``very_large_project``) the windows and the merged tables are pointers
    to files, and no scaled frame is stashed.
    """
    if return_as_paths is None:
        return_as_paths = coordinates._very_large_project
    if window_size is None:
        window_size = int(np.round(coordinates._frame_rate))
    window_step = int(kwargs.pop("window_step", 1))
    shuffle = bool(kwargs.pop("shuffle", False))
    if not preprocess:
        raise NotImplementedError("preprocess=False graph datasets are not yet supported.")
    binned = bin_size is not None or bin_index is not None or precomputed_bins is not None
    fused = (
        precomputed_tab_dict is None and animal_id is None and not polar and align is None and not binned
        and not return_as_paths
        and _device_scale_applicable(
            scale, kwargs.get("filter_low_variance", False),
            dist_standardize, speed_standardize, coord_standardize,
        )
    )
    if fused:
        frames, feature_names = coordinates.merged_graph_features_device(include_angles, device)
        tab_dict = TableDict(
            {key: _device_lazy(dev, feature_names) for key, dev in frames.items()},
            typ="merged", table_path=coordinates._table_path, connectivity=coordinates._connectivity,
        )
        tab_dict._animal_ids = coordinates._animal_ids
        tab_dict._device_frames = frames
        tab_dict._fused_lane = True
        angle_names = [tuple(b) for b in coordinates._bridge_names]
    elif precomputed_tab_dict is not None:
        # graph_dataset.py:109-115: the caller's merged tables, the angle
        # labels read from the first recording's getter.
        tab_dict = precomputed_tab_dict
        first_key = next(iter(tab_dict))
        angle_names = list(coordinates.get_angles_at_key(first_key, selected_id=animal_id, _device=True)[1])
        feature_names = list(tab_dict[first_key].columns)
    elif return_as_paths:
        tab_dict, angle_names = _getter_files(coordinates, animal_id, align, polar, include_angles)
        feature_names = get_dt(tab_dict, next(iter(tab_dict)), only_metainfo=True)["columns"]
    else:
        tab_dict, angle_names = _getter_tables(coordinates, animal_id, align, polar, include_angles, device)
        feature_names = tab_dict[next(iter(tab_dict))].columns

    graph, nodes, edges, adjacency = feature_graph(coordinates, animal_id)
    tab_dict._connectivity = graph

    node_idx = _matching([(n, "x") for n in nodes] + [(n, "y") for n in nodes] + nodes, feature_names)
    angle_idx = _matching(angle_names, feature_names)
    edge_idx = _matching(edges, feature_names)
    inner_link_mask = (
        [len({node.split("_")[0] for node in e}) == 1 for e in edges]
        if len(coordinates._animal_ids) > 1 else []
    )

    to_preprocess, metainfo, global_scaler = tab_dict.preprocess(
        coordinates=coordinates, bin_size=bin_size, bin_index=bin_index,
        precomputed_bins=precomputed_bins, samples_max=samples_max, save_as_paths=return_as_paths,
        dist_standardize=dist_standardize, speed_standardize=speed_standardize,
        coord_standardize=coord_standardize, window_size=window_size, scale=scale,
        return_windows=False, **kwargs,
    )
    metainfo["node_columns"] = [feature_names[j] for j in node_idx]
    metainfo["edge_columns"] = [feature_names[j] for j in edge_idx]
    metainfo["angle_columns"] = [feature_names[j] for j in angle_idx]
    metainfo["inner_link_mask"] = np.asarray(inner_link_mask, dtype=bool)

    # The scaled per-frame frames, before windowing: scaling with a fitted
    # scaler is deterministic, so embedding_per_video reuses them when it
    # is given the same scaler and settings (unbinned builds only: it
    # embeds every frame); not in paths mode, where a very large project's
    # frames are not held.
    if not binned and not return_as_paths:
        tab_dict._scaled_frames = {k: part[k] for part in to_preprocess for k in part.keys()}
        tab_dict._scaled_device = {
            k: v for part in to_preprocess for k, v in part._device_frames.items()
        }
        tab_dict._scaled_host = {k: v for part in to_preprocess for k, v in part._host_f32.items()}
        tab_dict._scaled_scaler = global_scaler
        tab_dict._scaled_sig = (scale, dist_standardize, speed_standardize, coord_standardize, samples_max)

    groups = (node_idx, edge_idx, angle_idx)

    # shuffle: each recording's windows in a permutation drawn, recording by
    # recording in the parts' order, from one np.random.default_rng(42), as
    # the JAX package draws it (graph_dataset.py:295, 331-333).
    rng = np.random.default_rng(42) if shuffle else None
    for k, part in enumerate(to_preprocess):
        num_rows = 0
        for key in part.keys():
            t_rows = int(get_dt(part, key, only_metainfo=True)["num_rows"])
            n_win = len(range(0, max(t_rows - window_size + 1, 0), window_step))
            order = None if rng is None else rng.permutation(n_win)
            if is_pointer(part[key]):
                # The windows over the scaled frame's own files, the frame
                # in the precision it was written in (its windows' dtype).
                frame = get_dt(part, key).astype(get_dt(part, key, only_metainfo=True)["dtype"], copy=False)
                part[key] = save_windows(frame, groups, window_size, window_step, part[key][POINTER_KEY], order)
                del frame
            else:
                part[key] = LazyWindows(
                    (lambda h=part._deferred_f32[key], o=order: frame_windows(
                        h.host(), groups, window_size, window_step, o)),
                    [(n_win, window_size, len(idx)) for idx in groups],
                )
            num_rows += n_win
        if part.keys():
            metainfo["shape_train" if k == 0 else "shape_test"] = [
                (num_rows, window_size, len(idx)) for idx in (node_idx, edge_idx, angle_idx)
            ]
        elif k == 0:
            metainfo["shape_train"] = [(0,), (0,), (0,)]
    return to_preprocess, metainfo, adjacency, tab_dict, global_scaler
