"""The two per-recording programs of the serving path, as plain functions
(port of ``deepof_tpu/data.py`` ``_preprocess_positions`` and
``_merged_features_program``), plus the merged-frame column layout that
``Coordinates.merged_graph_features_device`` builds around the second.

Both programs take numpy arrays or tensors and a ``device``; they run in
float64 on the CPU when given float64 and in float32 otherwise.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from deepof_tpu_torch.core.graph import BodyGraph
from deepof_tpu_torch.device import resolve_device, to_device, working_dtype
from deepof_tpu_torch.ops.interp import masked_linear_interpolate
from deepof_tpu_torch.ops.kinematics import (
    all_pair_indices,
    bridge_angles,
    pairwise_distances,
    rolling_speed,
)
from deepof_tpu_torch.ops.outliers import remove_outliers
from deepof_tpu_torch.ops.smoothing import savgol_smooth


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


def merged_feature_layout(
    graph: BodyGraph,
    animal_ids: Optional[Sequence[str]] = None,
    include_angles: bool = True,
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
    pair_names = [tuple(sorted((nodes[i], nodes[j]))) for i, j in all_pairs]
    edges = set(graph.edge_names)
    keep = [i for i, name in enumerate(pair_names) if name in edges]
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
