"""Arena and ROI geometry (port of the parts of
``deepof_tpu/ops/geometry.py`` that the ROI filters and the supervised
rules read: ``_close_polygon``, ``point_in_polygon``, the fused distance
and inside test ``point_polygon_host`` :89 (with its twins :111, :135 and
``deepof_tpu/native/kernels.cpp:97``) and ``ellipse_to_polygon`` :166)."""

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


def point_polygon(points: torch.Tensor, polygon):
    """(distance to the boundary, inside) of (T, 2) points against a (V, 2)
    polygon, in float64 on the points' device: the minimum over edges of
    the point-to-segment distance, and :func:`point_in_polygon`'s crossing
    rule. A non-finite point gets distance NaN and is outside."""
    poly = _close_polygon(polygon)
    pts = points.to(torch.float64)
    a = torch.as_tensor(poly, device=pts.device)
    v = torch.as_tensor(np.roll(poly, -1, axis=0), device=pts.device) - a
    x, y = pts[:, 0:1], pts[:, 1:2]
    ax, ay, vx, vy = a[:, 0], a[:, 1], v[:, 0], v[:, 1]
    c1 = (x - ax) * vx + (y - ay) * vy
    c2 = vx * vx + vy * vy
    t = torch.where(c2 > 0, c1 / torch.where(c2 == 0, 1.0, c2), 0.0).clamp(0.0, 1.0)
    dx = x - (ax + t * vx)
    dy = y - (ay + t * vy)
    dist = torch.sqrt((dx * dx + dy * dy).amin(dim=1))
    dist = torch.where(torch.isfinite(pts).all(dim=1), dist, torch.nan)
    return dist, point_in_polygon(pts, poly)


def ellipse_to_polygon(center, axes, angle_deg: float, n_points: int = 100) -> np.ndarray:
    """A ((cx, cy), (ax, ay), angle) ellipse as an (n_points, 2) polygon."""
    theta = np.linspace(0, 2 * np.pi, n_points, endpoint=False)
    ang = np.deg2rad(angle_deg)
    x = axes[0] * np.cos(theta)
    y = axes[1] * np.sin(theta)
    return np.stack([x * np.cos(ang) - y * np.sin(ang) + center[0], x * np.sin(ang) + y * np.cos(ang) + center[1]],
                    axis=1)
