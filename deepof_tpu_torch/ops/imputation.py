"""Occlusion imputation: Kalman/RTS smoothing, skeleton constraints and an
iterative ridge imputer, the three steps of ``iterative_imputation="full"``
(port of ``deepof_tpu/ops/imputation.py``).

Every function computes where its input lies: the Kalman/RTS pass through
``ops/kalman_kernels.py`` (a CUDA kernel on the card, its plain version on
the CPU), the ridge sweep and the constraints as tensor ops. The rest
lengths are estimated from at most ~200 sampled complete frames in numpy,
as the JAX package estimates them on the host.

The reference's quirks that the JAX package keeps, kept here:
  - the Kalman initial state broadcasts the first measurement into both the
    position and the velocity component;
  - a frame is skipped by the constraint solver iff bodypart 0 is original;
  - "original" for the move-one-endpoint rule checks only the x flag.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from deepof_tpu_torch.ops.kalman_kernels import kalman_rts


def kalman_rts_smooth(data: torch.Tensor) -> torch.Tensor:
    """RTS smoothing of every channel of (T, B, 2) at once: float32, on
    ``data``'s device."""
    t = data.shape[0]
    flat = data.reshape(t, -1).to(torch.float32).contiguous()
    return kalman_rts(flat).reshape(data.shape)


def _rest_lengths(sampled: np.ndarray, edges) -> List[Tuple[int, int, float]]:
    constraints = []
    for i, j in edges:
        d = np.sqrt(((sampled[:, i] - sampled[:, j]) ** 2).sum(-1))
        constraints.append((int(i), int(j), float(d.mean())))
    return constraints


def estimate_skeleton_constraints(
    data, edges: Sequence[Tuple[int, int]], n_samples: int = 100,
) -> List[Tuple[int, int, float]]:
    """Per-edge rest lengths from every (n_complete // n_samples)-th fully
    tracked frame (``deepof_tpu/ops/imputation.py:97``).

    Args:
        data: (T, B, 2) positions with NaNs at missing samples, a numpy
            array or a tensor (the complete frames are found on its device
            and only the sampled ones are copied to the host, in float64).
        edges: (i, j) bodypart index pairs.

    Raises:
        ValueError: when no frame is complete.
    """
    if isinstance(data, torch.Tensor):
        complete = torch.nonzero(torch.isfinite(data).flatten(1).all(dim=1)).flatten()
        n_complete = int(complete.numel())
    else:
        complete = np.where(np.isfinite(data).all(axis=(1, 2)))[0]
        n_complete = complete.size
    if n_complete == 0:
        raise ValueError("No complete frames found; cannot estimate constraints.")
    step = max(1, n_complete // n_samples)
    if isinstance(data, torch.Tensor):
        sampled = data[complete[::step]].to(torch.float64).cpu().numpy()
    else:
        sampled = data[complete[::step]]
    return _rest_lengths(sampled, edges)


def enforce_skeleton_constraints(
    data: torch.Tensor,
    constraints: Sequence[Tuple[int, int, float]],
    original_pos: torch.Tensor,
    tolerance: float = 0.1,
    correction_factor: float = 0.5,
) -> torch.Tensor:
    """Pull imputed bodyparts toward their skeleton rest lengths
    (``deepof_tpu/ops/imputation.py:125``): every frame at once, the
    constraints applied in list order within a frame.

    Args:
        data: (T, B, 2) positions.
        constraints: (part1, part2, rest_length) triples.
        original_pos: (T, B, 2) bool, True where the sample is original.
    """
    fr = data.clone()
    a_orig_all = original_pos[:, :, 0]
    dt = data.dtype
    for p1, p2, rest in constraints:
        a, b = fr[:, p1].clone(), fr[:, p2].clone()
        cur = torch.sqrt(((a - b) ** 2).sum(dim=-1))
        out_of_tol = (cur > rest * (1 + tolerance)) | (cur < rest * (1 - tolerance))
        corr = (cur - rest) / (2 * cur + 1e-5) * correction_factor
        corr = torch.where(out_of_tol, corr, torch.zeros((), dtype=dt, device=data.device))
        pm = (a + b) / 2
        a_orig, b_orig = a_orig_all[:, p1], a_orig_all[:, p2]
        # a original -> move only b (doubled); else b original -> move only
        # a (doubled); neither -> move both by half.
        coef_a = torch.where(a_orig, 0.0, torch.where(b_orig, 2.0, 1.0)).to(dt)
        coef_b = torch.where(a_orig, 2.0, torch.where(b_orig, 0.0, 1.0)).to(dt)
        fr[:, p1] = a + (coef_a * corr)[:, None] * (pm - a)
        fr[:, p2] = b + (coef_b * corr)[:, None] * (pm - b)
    skip = original_pos[:, 0].all(dim=-1)
    return torch.where(skip[:, None, None], data, fr)


def iterative_ridge_impute(data: torch.Tensor, n_rounds: int = 10, ridge: float = 1e-3) -> torch.Tensor:
    """Fill NaNs by round-robin ridge regression of each feature on the rest
    (``deepof_tpu/ops/imputation.py:169``): features standardised
    (``nanmean`` / ``nanstd`` with ddof 0, a zero deviation taken as 1),
    missing entries started at the mean, then ``n_rounds`` sweeps over the
    features in order, each re-predicting a feature's missing entries from
    all the others by an observed-row-weighted ridge solve. A feature with
    no missing entry is left as it is (its re-prediction would keep every
    entry), so only the others are solved.

    Args:
        data: (T, F) with NaNs.

    Returns:
        (T, F), NaNs replaced; observed entries untouched.
    """
    obs = torch.isfinite(data)
    n_obs = obs.sum(dim=0).to(data.dtype)
    zero = torch.zeros((), dtype=data.dtype, device=data.device)
    mu = torch.where(obs, data, zero).sum(dim=0) / n_obs
    sd = torch.sqrt(torch.where(obs, (data - mu) ** 2, zero).sum(dim=0) / n_obs)
    sd = torch.where(sd > 0, sd, torch.ones((), dtype=data.dtype, device=data.device))
    filled = torch.where(obs, (data - mu) / sd, zero)

    t, f = data.shape
    eye = torch.eye(f, dtype=data.dtype, device=data.device)
    w = obs.to(data.dtype)
    missing = np.flatnonzero((~obs).any(dim=0).cpu().numpy()).tolist()
    for _ in range(n_rounds):
        for j in missing:
            x_others = filled.clone()
            x_others[:, j] = 0
            xtw = x_others.T * w[:, j]
            gram = xtw @ x_others + ridge * eye
            beta = torch.linalg.solve_ex(gram, (xtw @ filled[:, j])[:, None])[0][:, 0]
            pred = x_others @ beta
            filled[:, j] = torch.where(obs[:, j], filled[:, j], pred)
    out = filled * sd + mu
    return torch.where(obs, data, out)
