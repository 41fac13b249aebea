"""Kinematic features: distances, bridge angles, polygon areas, polar
coordinates, speeds (port of deepof_tpu/ops/kinematics.py).

Positions are (T, N, 2) tensors; index arrays are static numpy arrays.
"""

from __future__ import annotations

from itertools import combinations

import numpy as np
import torch


def all_pair_indices(n: int) -> np.ndarray:
    """(P, 2) indices of all unordered node pairs, in combinations order."""
    pairs = list(combinations(range(n), 2))
    return np.asarray(pairs, dtype=np.int32) if pairs else np.zeros((0, 2), np.int32)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root. PyTorch's float32 ``sqrt`` on the CPU
    is one ulp off the correctly rounded root on a small share of inputs,
    where it disagrees with the card's; ``rolling_speed`` rounds to 3
    decimals right after, where one ulp can flip a rounding. So float32
    roots are taken in float64, which rounds correctly on both."""
    if x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def _take(x: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    return x.index_select(-2, torch.as_tensor(np.asarray(idx, np.int64), device=x.device))


def pairwise_distances(x: torch.Tensor, pairs: np.ndarray) -> torch.Tensor:
    """(..., T, N, 2) positions -> (..., T, P) Euclidean pair distances."""
    d = _take(x, pairs[:, 0]) - _take(x, pairs[:, 1])
    return _sqrt((d * d).sum(dim=-1))


def bridge_angles(x: torch.Tensor, bridges: np.ndarray) -> torch.Tensor:
    """(..., T, N, 2) -> (..., T, A) unsigned angle at each bridge centre."""
    c = _take(x, bridges[:, 1])
    ca = _take(x, bridges[:, 0]) - c
    cb = _take(x, bridges[:, 2]) - c
    cos = (ca * cb).sum(dim=-1) / (
        _sqrt((ca * ca).sum(dim=-1)) * _sqrt((cb * cb).sum(dim=-1))
    )
    return torch.arccos(cos.clamp(-1.0, 1.0))


def polygon_areas(x: torch.Tensor, poly: np.ndarray) -> torch.Tensor:
    """(..., T, N, 2) -> (..., T) shoelace area of the polygon over the
    vertex indices ``poly``; a NaN vertex gives a NaN area."""
    v = _take(x, poly)
    nxt = torch.roll(v, -1, dims=-2)
    cross = v[..., 0] * nxt[..., 1] - nxt[..., 0] * v[..., 1]
    return cross.sum(dim=-1).abs() / 2.0


def to_polar(x: torch.Tensor) -> torch.Tensor:
    """Cartesian (..., 2) -> polar (..., 2) as (rho, phi), phi the argument
    of x + iy."""
    return torch.stack([torch.hypot(x[..., 0], x[..., 1]), torch.atan2(x[..., 1], x[..., 0])], dim=-1)


def _windowed_mean_nan(d: torch.Tensor, window: int) -> torch.Tensor:
    """Trailing rolling mean along dim 0 (pandas min_periods=window).

    A NaN poisons exactly the windows that cover it: this is a shifted sum
    of ``d[k] * (1/window)``, never a cumulative sum or a cuDNN conv.
    """
    t = d.shape[0]
    n_out = t - window + 1
    inv = 1.0 / window
    core = d[:n_out] * inv
    for k in range(1, window):
        core = core + d[k:k + n_out] * inv
    head = d.new_full((window - 1,) + d.shape[1:], torch.nan)
    return torch.cat([head, core], dim=0)


def rolling_speed(
    x: torch.Tensor,
    frame_rate: float = 1.0,
    window: int = 3,
    rounds: int = 3,
    deriv: int = 1,
    shift: int = 2,
    is_coords: bool = True,
) -> torch.Tensor:
    """n-th order speed (mm/s for deriv=1), deepof_tpu/ops/kinematics.py:109.

    Per derivative order: displacement between t and t-shift over shift,
    a trailing ``window`` mean, rounded to ``rounds`` decimals (half to
    even, as ``jnp.round``); the result is scaled by ``frame_rate``.

    Args:
        x: (T, B, 2) positions if is_coords, else (T, B) scalar series.
    """
    cur = x
    b = x.shape[1]
    for der in range(deriv):
        if der == 0 and is_coords:
            delta = cur[shift:] - cur[:-shift]
            step = delta / shift
            dist = _sqrt((step * step).sum(dim=-1))
        else:
            dist = ((cur[shift:] - cur[:-shift]) / shift).abs()
        dist = torch.cat([dist.new_full((shift, b), torch.nan), dist], dim=0)
        rolled = _windowed_mean_nan(dist, window)
        scale = 10.0 ** rounds
        # Divided by a device tensor: PyTorch's CUDA division by a Python
        # scalar multiplies by its reciprocal, which is one ulp off the
        # quotient on about half the entries, and at deriv >= 2 the next
        # order's rounding then flips between card and CPU.
        cur = torch.round(rolled * scale) / rolled.new_full((), scale)
    return cur * frame_rate
