"""Outlier masking over pose trajectories (port of deepof_tpu/ops/outliers.py).

Kept for parity: the residual threshold is ``mean + n_std * std`` of the
*signed* residuals over ``[lag, T - lag)``, compared against ``|residual|``;
the std is the population std (ddof=0, as ``jnp.std``).
"""

from __future__ import annotations

import torch

from deepof_tpu_torch.ops.smoothing import moving_average


def mask_outliers(
    xy: torch.Tensor,
    likelihood: torch.Tensor,
    likelihood_tolerance: float,
    lag: int = 5,
    n_std: float = 3.0,
    mode: str = "or",
) -> torch.Tensor:
    """(T, B) bool outlier mask for (T, B, 2) positions and (T, B) likelihoods."""
    t, b, _ = xy.shape
    flat = xy.reshape(t, b * 2)
    resid = flat - moving_average(flat, lag)
    interior = resid[lag:t - lag]
    mu = interior.mean(dim=0)
    sd = interior.std(dim=0, correction=0)
    dev_mask = (resid.abs() > (mu + n_std * sd)).reshape(t, b, 2)
    if mode == "and":
        coord_mask = dev_mask[..., 0] & dev_mask[..., 1]
    else:
        coord_mask = dev_mask[..., 0] | dev_mask[..., 1]
    return coord_mask | (likelihood < likelihood_tolerance)


def remove_outliers(
    xy: torch.Tensor,
    likelihood: torch.Tensor,
    likelihood_tolerance: float,
    lag: int = 5,
    n_std: float = 3.0,
    mode: str = "or",
):
    """NaN out detected outliers; returns (cleaned (T, B, 2), outlier fraction)."""
    mask = mask_outliers(xy, likelihood, likelihood_tolerance, lag, n_std, mode)
    cleaned = torch.where(mask[..., None], torch.nan, xy)
    return cleaned, mask.to(torch.float32).mean()
