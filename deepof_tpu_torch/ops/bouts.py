"""Run-length post-processing of (T,) behavior series, as tensor ops on the
series' device (port of ``deepof_tpu/ops/bouts.py``
``filter_short_true_segments`` :37 / ``_filter_short_host`` :138,
``_binary_median_host`` :156 and ``multi_step_paired_smoothing`` :73 /
``multi_step_paired_smoothing_host`` :174).

Run bounds come from cumulative max / min scans and every window count
from an integer prefix sum, so no float sum decides a frame. The windows
of ``np.convolve(x, ones(lag) / lag, mode="same")`` cover
``[i - lag // 2, i + (lag - 1) // 2]`` (off centre by one for an even lag).
"""

from __future__ import annotations

import torch

from deepof_tpu_torch.ops.interp import cummax_values, cummin_values


def window_counts(x: torch.Tensor, before: int, after: int) -> torch.Tensor:
    """int64 count of True in ``x[i - before : i + after + 1]`` (clipped to
    the series) for every frame i of a (T,) series."""
    t = x.shape[0]
    csum = torch.zeros(t + 1, dtype=torch.int64, device=x.device)
    csum[1:] = torch.cumsum(x.to(torch.int64), 0)
    idx = torch.arange(t, device=x.device)
    return csum[(idx + after + 1).clamp(max=t)] - csum[(idx - before).clamp(min=0)]


def same_counts(x: torch.Tensor, lag: int) -> torch.Tensor:
    """``np.convolve(x, ones(lag), mode="same")`` of a 0/1 series, in counts."""
    return window_counts(x, lag // 2, (lag - 1) // 2)


def filter_short_true_segments(a: torch.Tensor, min_length: int) -> torch.Tensor:
    """Drop the True runs of a (T,) series shorter than ``min_length``."""
    a = a.to(torch.bool)
    t = a.shape[0]
    idx = torch.arange(t, device=a.device)
    no = torch.zeros(1, dtype=torch.bool, device=a.device)
    starts = a & ~torch.cat([no, a[:-1]])
    ends = a & ~torch.cat([a[1:], no])
    start_idx = cummax_values(torch.where(starts, idx, -1), 0)
    end_idx = cummin_values(torch.where(ends, idx, t + 1).flip(0), 0).flip(0)
    return a & (end_idx - start_idx + 1 >= min_length)


def binary_moving_median(a: torch.Tensor, lag: int) -> torch.Tensor:
    """True where the centred window of ``2 * ((lag - 1) // 2) + 1`` frames
    holds more True than False; False on the edges the window overhangs."""
    pad = (lag - 1) // 2
    t = a.shape[0]
    idx = torch.arange(t, device=a.device)
    inner = (idx >= pad) & (idx < t - pad)
    return inner & (window_counts(a, pad, pad) > pad)


def multi_step_paired_smoothing(
    behavior_in: torch.Tensor,
    not_behavior: torch.Tensor = None,
    exclude: torch.Tensor = None,
    min_length: int = 6,
    get_both: bool = False,
):
    """Merge close bouts, resolve frames both signals claim by their wider
    context, widen consistent blocks with a binary median and drop short
    runs (deepof_tpu/ops/bouts.py:174).

    The conflict rule compares window counts: the JAX package compares
    float averages from ``np.convolve``, whose BLAS dot sums equal counts
    in orders that can differ by an ulp; here an exact tie goes to the
    behavior, as ``>=`` states.
    """
    t = behavior_in.shape[0]
    dev = behavior_in.device
    exclude = torch.ones(t, dtype=torch.bool, device=dev) if exclude is None else exclude.to(torch.bool)
    if not_behavior is None:
        behavior = exclude & behavior_in.to(torch.bool)
        not_behavior = exclude & ~behavior_in.to(torch.bool)
    else:
        behavior = behavior_in.to(torch.bool)
        not_behavior = not_behavior.to(torch.bool)

    behavior = same_counts(behavior, min_length) > 0
    not_behavior = same_counts(not_behavior, min_length) > 0

    conflict = behavior & not_behavior
    behavior_wins = same_counts(behavior, min_length * 4) >= same_counts(not_behavior, min_length * 4)
    behavior = behavior & ~(conflict & ~behavior_wins) & exclude
    not_behavior = not_behavior & ~(conflict & behavior_wins) & exclude

    behavior = binary_moving_median(behavior, min_length * 4 + 1)
    not_behavior = not_behavior & ~behavior

    behavior = filter_short_true_segments(behavior, min_length) & exclude
    not_behavior = filter_short_true_segments(not_behavior, min_length) & exclude
    if get_both:
        return behavior, not_behavior
    return behavior
