"""Gap filling: forward/backward fill indices, presence-masked linear
interpolation with a pandas-style limit (port of deepof_tpu/ops/interp.py)
and pandas' linear ``interpolate`` as the supervised rules call it.

Every function works along dim 0 and broadcasts over trailing dims, so one
call fills every (bodypart, coordinate) column of a recording.
"""

from __future__ import annotations

import torch

_BIG = 2**30


def _positions(valid: torch.Tensor) -> torch.Tensor:
    t = valid.shape[0]
    shape = (t,) + (1,) * (valid.ndim - 1)
    return torch.arange(t, device=valid.device).reshape(shape).expand(valid.shape)


def scan_dim0(op, x: torch.Tensor) -> torch.Tensor:
    """``op(x, dim)`` (cumsum, or the values of cummax / cummin) along dim 0,
    run on the innermost dim: on the card PyTorch's scan along an outer dim
    of a (90,000, ~100) frame took ~30 ms a call, against a parallel scan
    along the contiguous dim."""
    if x.ndim == 1:
        return op(x, 0)
    return op(x.movedim(0, -1).contiguous(), -1).movedim(-1, 0)


def cummax_values(x, dim):
    return torch.cummax(x, dim).values


def cummin_values(x, dim):
    return torch.cummin(x, dim).values


def ffill_indices(valid: torch.Tensor) -> torch.Tensor:
    """Index of the most recent True at or before each position (-1 if none)."""
    return scan_dim0(cummax_values, torch.where(valid, _positions(valid), -1))


def bfill_indices(valid: torch.Tensor) -> torch.Tensor:
    """Index of the next True at or after each position (2**30 if none)."""
    t = valid.shape[0]
    rev = ffill_indices(valid.flip(0)).flip(0)
    return torch.where(rev >= 0, t - 1 - rev, _BIG)


def masked_linear_interpolate(
    x: torch.Tensor, present: torch.Tensor, limit: int | None = None
) -> torch.Tensor:
    """Linear interpolation over NaNs restricted to ``present`` frames.

    Absent frames are neither filled nor used as anchors, and the fill limit
    counts present frames only (deepof_tpu/ops/interp.py:102).

    Args:
        x: (T,) or (T, C) values with NaNs.
        present: bool, broadcastable to ``x`` along dim 0 ((T,) or (T, C)).
        limit: pandas-style fill limit, counted in present-frame steps.
    """
    t = x.shape[0]
    if present.ndim < x.ndim:
        present = present.reshape(present.shape + (1,) * (x.ndim - present.ndim))
    present = present.expand(x.shape)
    finite = torch.isfinite(x)
    valid = finite & present
    # Virtual index: position within the present-frame subsequence.
    vidx = scan_dim0(torch.cumsum, present.to(torch.int64)) - 1

    li = ffill_indices(valid)
    ri_raw = bfill_indices(valid)
    li_c = li.clamp(0, t - 1)
    ri_c = ri_raw.clamp(0, t - 1)
    left_val = torch.gather(x, 0, li_c)
    right_val = torch.gather(x, 0, ri_c)
    has_left = li >= 0
    has_right = ri_raw < t
    v_left = torch.gather(vidx, 0, li_c)
    v_right = torch.gather(vidx, 0, ri_c)

    dl_v = (vidx - v_left).to(x.dtype)
    span_v = (v_right - v_left).to(x.dtype)
    frac = torch.where(span_v > 0, dl_v / span_v.clamp(min=1), 0.0)
    interp = torch.where(
        has_left & has_right,
        left_val + (right_val - left_val) * frac,
        torch.where(has_left, left_val, right_val),
    )
    fillable = (has_left | has_right) & present
    if limit is not None:
        dl_i = torch.where(has_left, vidx - v_left, _BIG)
        dr_i = torch.where(has_right, v_right - vidx, _BIG)
        fillable = fillable & ((dl_i <= limit) | (dr_i <= limit))
    return torch.where(finite, x, torch.where(fillable, interp, torch.nan))


def interpolate_linear(x: torch.Tensor, limit_direction: str = "forward") -> torch.Tensor:
    """pandas ``interpolate(method="linear")`` of each column along dim 0:
    a NaN between two values takes ``np.interp``'s
    ``slope * (i - left) + y_left``; trailing NaNs take the last value;
    leading NaNs stay NaN, or take the first value with
    ``limit_direction="both"``."""
    if limit_direction not in ("forward", "both"):
        raise ValueError(f"limit_direction must be 'forward' or 'both', got {limit_direction!r}")
    t = x.shape[0]
    valid = ~torch.isnan(x)
    li = ffill_indices(valid)
    ri = bfill_indices(valid)
    has_left, has_right = li >= 0, ri < t
    li_c, ri_c = li.clamp(0, t - 1), ri.clamp(0, t - 1)
    y_left, y_right = torch.gather(x, 0, li_c), torch.gather(x, 0, ri_c)
    slope = (y_right - y_left) / (ri_c - li_c).to(x.dtype)
    inner = slope * (_positions(valid) - li_c).to(x.dtype) + y_left
    lead = y_right if limit_direction == "both" else torch.full_like(x, torch.nan)
    fill = torch.where(has_left & has_right, inner, torch.where(has_left, y_left, lead))
    return torch.where(valid, x, fill)
