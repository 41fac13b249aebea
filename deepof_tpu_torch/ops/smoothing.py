"""Trajectory smoothing: Savitzky-Golay and the uniform moving average.

Port of ``deepof_tpu/ops/smoothing.py``. Both filters are written as
shifted sums along time rather than ``F.conv1d``: cuDNN may pick FFT or
Winograd algorithms that spread one NaN over the whole output and run in
TF32 by default, and a shifted sum keeps a fixed summation order, so the
card and the CPU agree term for term.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
from scipy.signal import savgol_coeffs, savgol_filter


@lru_cache(maxsize=64)
def _savgol_operators(window: int, polyorder: int):
    """(central_coeffs, start_edge_matrix, end_edge_matrix) in numpy: the
    exact linear operators scipy applies in mode='interp'."""
    half = window // 2
    central = savgol_coeffs(window, polyorder)[::-1].copy()
    op = savgol_filter(np.eye(window), window, polyorder, axis=0)
    return central, op[:half].copy(), op[window - half:].copy()


def savgol_edges_host(x_np: np.ndarray, window: int, polyorder: int):
    """scipy-exact edge rows of a mode='interp' Savitzky-Golay filter, on
    the host: the first/last ``window // 2`` output rows depend only on the
    first/last ``window`` samples, and at polyorder close to window only
    scipy's own float path matches scipy.

    Returns (start_rows (window//2, F), end_rows (window//2, F)) float64.
    """
    x_np = np.asarray(x_np, dtype=np.float64)
    half = window // 2
    head = savgol_filter(x_np[:window], window, polyorder, axis=0)
    tail = savgol_filter(x_np[-window:], window, polyorder, axis=0)
    return head[:half], tail[window - half:]


def savgol_smooth(
    x: torch.Tensor, window: int = 15, polyorder: int = 13, edges=None
) -> torch.Tensor:
    """Savitzky-Golay smooth along dim 0 of (T, F) with scipy 'interp' edges.

    Args:
        edges: optional (start_rows, end_rows) from :func:`savgol_edges_host`
            for scipy-exact edge rows; when None the edges use the linear
            operators (equal in exact arithmetic).
    """
    central, e_start, e_end = _savgol_operators(window, polyorder)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    t = x.shape[0]
    if t < window:
        raise ValueError(f"signal length {t} < window {window}")

    # Interior: correlation with the central coefficients, one shifted
    # slice per tap.
    n_out = t - window + 1
    interior = x[:n_out] * float(central[0])
    for k in range(1, window):
        interior = interior + x[k:k + n_out] * float(central[k])

    if edges is not None:
        start = torch.as_tensor(np.asarray(edges[0]), dtype=x.dtype, device=x.device)
        end = torch.as_tensor(np.asarray(edges[1]), dtype=x.dtype, device=x.device)
        if start.ndim == 1:
            start, end = start[:, None], end[:, None]
    else:
        start = torch.as_tensor(e_start, dtype=x.dtype, device=x.device) @ x[:window]
        end = torch.as_tensor(e_end, dtype=x.dtype, device=x.device) @ x[t - window:]
    out = torch.cat([start, interior, end], dim=0)
    return out[:, 0] if squeeze else out


def moving_average(x: torch.Tensor, lag: int = 5) -> torch.Tensor:
    """Uniform moving average along dim 0, numpy convolve 'same' placement:
    output[i] averages x[i - (lag - 1 - (lag-1)//2) .. i + (lag-1)//2] with
    zeros outside the signal.

    The JAX package takes the difference of two cumulative sums; over a
    1-hour recording in float32 that loses ~0.1 px near 300 px. This port
    sums the ``lag`` shifted slices instead, which computes the same
    function with error bounded by ``lag`` terms.
    """
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    if not x.is_floating_point():
        x = x.to(torch.float32)
    pad_r = (lag - 1) // 2
    pad_l = lag - 1 - pad_r
    t = x.shape[0]
    padded = torch.cat(
        [x.new_zeros((pad_l,) + x.shape[1:]), x, x.new_zeros((pad_r,) + x.shape[1:])]
    )
    total = padded[:t]
    for k in range(1, lag):
        total = total + padded[k:k + t]
    out = total / lag
    return out[:, 0] if squeeze else out
