"""Graph-dataset build: merged per-frame features -> scaled frames on the
device, the node / edge / angle column layout, the body graph's adjacency,
and the windowed training tensors (port of ``deepof_tpu/graph_dataset.py``,
its fused device lane).

The merged frame is built by one device program per recording
(``Coordinates.merged_graph_features_device``) and scaled where it lies
(``TableDict.preprocess``); windows exist on the host only when a caller
reads the returned training tensors. The JAX package's other lanes (an
animal selection, alignment, polar coordinates, time bins, a precomputed
table dict, paths mode) run its host getters and are not ported.
"""

from __future__ import annotations

import numpy as np

from deepof_tpu_torch.core.graph import connect_mouse
from deepof_tpu_torch.core.storage import LazyFrame, LazyWindows
from deepof_tpu_torch.core.table_dict import TableDict, _device_scale_applicable
from deepof_tpu_torch.ops.windows import rolling_windows_host


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
    project's.
    """
    if return_as_paths is None:
        return_as_paths = coordinates._very_large_project
    if window_size is None:
        window_size = int(np.round(coordinates._frame_rate))
    window_step = int(kwargs.pop("window_step", 1))
    shuffle = bool(kwargs.pop("shuffle", False))
    if not preprocess:
        raise NotImplementedError("preprocess=False graph datasets are not yet supported.")
    fused = (
        precomputed_tab_dict is None and animal_id is None and not polar and align is None
        and bin_size is None and bin_index is None and precomputed_bins is None
        and not return_as_paths
        and _device_scale_applicable(
            scale, kwargs.get("filter_low_variance", False),
            dist_standardize, speed_standardize, coord_standardize,
        )
    )
    if not fused:
        raise NotImplementedError(
            "the port builds graph datasets in the fused device lane only (no animal "
            "selection, alignment, polar coordinates, time bins, precomputed tables or "
            "paths mode; standard scaler, per-column modes): the host getters are ROADMAP "
            "queue 1 items 3 and 4, paths mode item 2"
        )

    frames, feature_names = coordinates.merged_graph_features_device(include_angles, device)
    tab_dict = TableDict(
        {key: LazyFrame((lambda d=dev: d.cpu().numpy()), feature_names, int(dev.shape[0]))
         for key, dev in frames.items()},
        typ="merged", table_path=coordinates._table_path, connectivity=coordinates._connectivity,
    )
    tab_dict._animal_ids = coordinates._animal_ids
    tab_dict._device_frames = frames

    graph, nodes, edges, adjacency = feature_graph(coordinates)
    tab_dict._connectivity = graph

    node_idx = _matching([(n, "x") for n in nodes] + [(n, "y") for n in nodes] + nodes, feature_names)
    angle_idx = _matching([tuple(b) for b in coordinates._bridge_names], feature_names)
    edge_idx = _matching(edges, feature_names)
    inner_link_mask = (
        [len({node.split("_")[0] for node in e}) == 1 for e in edges]
        if len(coordinates._animal_ids) > 1 else []
    )

    to_preprocess, metainfo, global_scaler = tab_dict.preprocess(
        coordinates=coordinates, samples_max=samples_max, save_as_paths=return_as_paths,
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
    # is given the same scaler and settings.
    tab_dict._scaled_frames = {k: part[k] for part in to_preprocess for k in part.keys()}
    tab_dict._scaled_device = {
        k: v for part in to_preprocess for k, v in part._device_frames.items()
    }
    tab_dict._scaled_scaler = global_scaler
    tab_dict._scaled_sig = (scale, dist_standardize, speed_standardize, coord_standardize, samples_max)

    def gather_windows(frame, order=None):
        """(T, F) scaled frame -> (nodes, edges, angles) window views, or
        their windows in ``order`` (copies)."""
        windows = tuple(
            rolling_windows_host(frame[:, idx], window_size, window_step, contiguous=False)
            if len(idx)
            else np.zeros((max(frame.shape[0] - window_size + 1, 0), window_size, 0))[::window_step]
            for idx in (node_idx, edge_idx, angle_idx)
        )
        return windows if order is None else tuple(w[order] for w in windows)

    # shuffle: each recording's windows in a permutation drawn, recording by
    # recording in the parts' order, from one np.random.default_rng(42), as
    # the JAX package draws it (graph_dataset.py:295, 331-333).
    rng = np.random.default_rng(42) if shuffle else None
    for k, part in enumerate(to_preprocess):
        num_rows = 0
        for key in part.keys():
            n_win = len(range(0, max(int(part[key].shape[0]) - window_size + 1, 0), window_step))
            order = None if rng is None else rng.permutation(n_win)
            part[key] = LazyWindows(
                (lambda h=part._deferred_f32[key], o=order: gather_windows(h.f32(), o)),
                [(n_win, window_size, len(idx)) for idx in (node_idx, edge_idx, angle_idx)],
            )
            num_rows += n_win
        if part.keys():
            metainfo["shape_train" if k == 0 else "shape_test"] = [
                (num_rows, window_size, len(idx)) for idx in (node_idx, edge_idx, angle_idx)
            ]
        elif k == 0:
            metainfo["shape_train"] = [(0,), (0,), (0,)]
    return to_preprocess, metainfo, adjacency, tab_dict, global_scaler
