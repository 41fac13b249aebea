"""Arena and ROI geometry (port of the parts of
``deepof_tpu/ops/geometry.py`` the ROI filters read: ``_close_polygon``
and ``point_in_polygon``)."""

from __future__ import annotations

import numpy as np
import torch


def _close_polygon(polygon) -> np.ndarray:
    """(V, 2) float64 vertices, a repeated closing vertex dropped."""
    polygon = np.asarray(polygon, dtype=np.float64)
    if len(polygon) >= 2 and np.allclose(polygon[0], polygon[-1]):
        polygon = polygon[:-1]
    return polygon


def point_in_polygon(points: torch.Tensor, polygon) -> torch.Tensor:
    """Ray-casting test of (..., 2) points against a (V, 2) polygon; True
    inside. An edge is crossed when ``min(y1, y2) < y <= max(y1, y2)``,
    ``x <= max(x1, x2)`` and the edge is vertical or the point lies left of
    the intersection; a NaN point is outside."""
    poly = _close_polygon(polygon)
    p1 = torch.as_tensor(poly, dtype=points.dtype, device=points.device)
    p2 = torch.as_tensor(np.roll(poly, -1, axis=0), dtype=points.dtype, device=points.device)
    x, y = points[..., 0:1], points[..., 1:2]
    x1, y1, x2, y2 = p1[:, 0], p1[:, 1], p2[:, 0], p2[:, 1]
    y_in_range = (y > torch.minimum(y1, y2)) & (y <= torch.maximum(y1, y2))
    x_ok = x <= torch.maximum(x1, x2)
    dy = y2 - y1
    xinters = torch.where(dy != 0, (y - y1) * (x2 - x1) / torch.where(dy == 0, 1.0, dy) + x1, x1)
    crosses = y_in_range & x_ok & ((x1 == x2) | (x <= xinters))
    return crosses.sum(dim=-1) % 2 == 1
