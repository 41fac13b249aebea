"""Egocentric rotation and alignment (port of deepof_tpu/ops/alignment.py).

The rotation is written as explicit cos/sin products, not a matrix product,
so that the card and the CPU form each coordinate from the same two
products in the same order.
"""

from __future__ import annotations

import torch


def rotate2d(points: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate (T, B, 2) points counter-clockwise about the origin by the
    per-frame ``angles`` (T,) in radians."""
    c = torch.cos(angles)[:, None]
    s = torch.sin(angles)[:, None]
    x, y = points[..., 0], points[..., 1]
    return torch.stack([c * x - s * y, s * x + c * y], dim=-1)


def align_trajectories(data: torch.Tensor, mode: str = "all") -> torch.Tensor:
    """Rotate every frame so that bodypart 0 lands on the +y axis: the
    angle is ``atan2(x_0, y_0)``, applied counter-clockwise.

    Args:
        data: (T, B, 2) centred positions with the aligned bodypart first,
            or (W, L, B, 2) windows for mode "center".
        mode: "center" aligns each window by its centre frame's angle;
            "none" returns ``data``; any other value aligns each frame.
    """
    if mode == "none":
        return data
    if mode == "center":
        w, l, b, _ = data.shape
        ref = data[:, (l - 1) // 2, 0]
        angles = torch.atan2(ref[..., 0], ref[..., 1])
        return rotate2d(data.reshape(w, l * b, 2), angles).reshape(w, l, b, 2)
    ref = data[:, 0]
    return rotate2d(data, torch.atan2(ref[..., 0], ref[..., 1]))
