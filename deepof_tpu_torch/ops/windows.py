"""Sliding windows on the host, for the training windows that
``get_graph_dataset`` returns (port of ``deepof_tpu/ops/windows.py``
``rolling_windows_host``). The serving path never builds windows on the
host: the window kernel writes them on the card.
"""

from __future__ import annotations

import numpy as np


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
