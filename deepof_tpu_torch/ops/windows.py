"""Sliding windows on the host, for the training windows that
``get_graph_dataset`` and ``TableDict.preprocess`` return, and the window
aggregations of ``extract_windows`` (port of ``deepof_tpu/ops/windows.py``
``rolling_windows_host``, ``aggregate_windows`` and
``aggregate_windows_labels``). The serving path never builds windows on the
host: the window kernel writes them on the card.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def rolling_windows_host(
    arr: np.ndarray, window_size: int, window_step: int = 1, contiguous: bool = True,
) -> np.ndarray:
    """(T, ...) -> (W, window_size, ...) windows by numpy stride tricks.

    With ``contiguous=False`` the result is a zero-copy strided view of
    ``arr``: stride-1 windows repeat each frame ``window_size`` times, so
    consumers materialise only what they read.
    """
    arr = np.asarray(arr)
    if arr.shape[0] < window_size:
        return np.zeros((0, window_size) + arr.shape[1:], arr.dtype)
    view = np.lib.stride_tricks.sliding_window_view(arr, window_size, axis=0)
    # (W, ...features, window) -> (W, window, ...features)
    view = np.moveaxis(view, -1, 1)[::window_step]
    return np.ascontiguousarray(view) if contiguous else view


def aggregate_windows(windows: torch.Tensor, aggregate: Optional[str]) -> torch.Tensor:
    """(W, L, F) windows aggregated over the window axis: None (as they
    are), "mid" (the middle frame) or "mean", keeping a length-1 axis."""
    if aggregate is None:
        return windows
    if aggregate == "mid":
        mid = windows.shape[1] // 2
        return windows[:, mid:mid + 1]
    if aggregate == "mean":
        return windows.mean(dim=1, keepdim=True)
    raise ValueError(f"Unknown aggregate mode: {aggregate}")


def aggregate_windows_labels(windows: np.ndarray, aggregate: str) -> np.ndarray:
    """(W, L, D) integer label windows -> (W, 1, D): "wta", the per-column
    mode over the window (ties to the smallest value, as
    ``scipy.stats.mode``); "lta", the least frequent row of each window
    (ties to the lexicographically smallest, as ``np.unique`` sorts)."""
    n, _, d = windows.shape
    out = np.empty((n, 1, d), dtype=windows.dtype)
    if aggregate == "wta":
        values = np.unique(windows)
        counts = np.stack([(windows == v).sum(axis=1) for v in values], axis=0)  # (V, W, D)
        out[:, 0, :] = values[np.argmax(counts, axis=0)]
    elif aggregate == "lta":
        for i in range(n):
            rows, counts = np.unique(windows[i], return_counts=True, axis=0)
            out[i, 0] = rows[np.argmin(counts)]
    else:
        raise ValueError(f"Unknown label aggregate mode: {aggregate}")
    return out
