"""Column and ROI helpers of the port (its own copies of
``deepof_tpu/utils.py`` ``filter_columns`` and the ROI filters of time-bin
info, which here take and return tensors on their device), and the names
the JAX package's ``utils`` gives the burst smoothing and the GMM scan
(``kleinberg`` :1522, ``smooth_boolean_array`` :1529, ``gmm_compute``
:1599, ``gmm_model_selection`` :1606)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def filter_columns(columns, selected_id: Optional[str], table_type: str = None) -> list:
    """The columns that belong to one animal: a string column that starts
    with ``selected_id`` (or, for supervised tables, contains it); a
    (bodypart, "x"|"y"|"rho"|"phi") column of its bodypart; a pair or a
    triple whose every part is its; a phenotype column."""
    if selected_id is None:
        return list(columns)
    keep = []
    for column in columns:
        if isinstance(column, str):
            if table_type == "supervised" and selected_id in column:
                keep.append(column)
            elif column.startswith(selected_id):
                keep.append(column)
            continue
        if column[0].startswith(selected_id) and column[1] in ("x", "y", "rho", "phi"):
            keep.append(column)
        elif len(column) in (2, 3) and all(str(c).startswith(selected_id) for c in column):
            keep.append(column)
        elif str(column[0]).lower().startswith("pheno"):
            keep.append(column)
    return keep


# --------------------------------------------------------------------------- #
# ROI filters of time-bin info (deepof_tpu/utils.py:714-805)
# --------------------------------------------------------------------------- #


def _as_list(animal_ids) -> list:
    if isinstance(animal_ids, str):
        return [animal_ids]
    return [""] if animal_ids is None else list(animal_ids)


def _mask(local_bin_info, aid, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(local_bin_info[aid], bool), device=like.device)


def get_supervised_behaviors_in_roi(values: torch.Tensor, columns, local_bin_info, animal_ids,
                                    roi_mode: str = "mousewise") -> torch.Tensor:
    """A (T, C) supervised table ``values`` (float, labelled by ``columns``)
    with the detections outside the ROI set to NaN. ``local_bin_info`` maps
    each animal id to its (T,) in-ROI mask (and "time" to the frames).
    "mousewise" blanks every frame where a requested animal is outside;
    "behaviorwise" blanks the columns of no requested animal, and each
    animal's columns where it is outside."""
    if not animal_ids:
        return values
    animal_ids = _as_list(animal_ids)
    if roi_mode == "mousewise":
        inside = torch.stack([_mask(local_bin_info, aid, values) for aid in animal_ids]).all(dim=0)
        return torch.where(inside[:, None], values, torch.nan)
    if roi_mode != "behaviorwise":
        raise NotImplementedError('roi_mode must be "mousewise" or "behaviorwise"')

    def base_name(col):
        return str(col[0] if isinstance(col, tuple) else col)

    valid = [any(base_name(c).startswith(aid) for aid in animal_ids) for c in columns]
    keep = torch.ones_like(values, dtype=torch.bool)
    keep[:, [i for i, v in enumerate(valid) if not v]] = False
    mask_ids = [k for k in local_bin_info if k != "time"]
    for aid in mask_ids:
        token = f"{aid}_" if len(mask_ids) > 1 else aid
        cols = [i for i, c in enumerate(columns) if valid[i] and token in base_name(c)]
        if cols:
            keep[:, cols] &= _mask(local_bin_info, aid, values)[:, None]
    return torch.where(keep, values, torch.nan)


def get_behavior_frames_in_roi(behavior, local_bin_info, animal_ids) -> np.ndarray:
    """The frames of ``local_bin_info["time"]`` on which the relevant animals
    are inside the ROI: the animals named by a behavior's "{id}_" prefix,
    else every requested animal."""
    animal_ids = _as_list(animal_ids)
    frames = np.array(local_bin_info["time"], copy=True)
    if behavior is not None and any(f"{aid}_" in str(behavior) for aid in animal_ids):
        checked = [aid for aid in local_bin_info if aid != "time" and f"{aid}_" in str(behavior)]
    else:
        checked = animal_ids
    for aid in checked:
        frames[~np.asarray(local_bin_info[aid], bool)] = -1
    return frames[frames >= 0]


def get_unsupervised_behaviors_in_roi(values: torch.Tensor, local_bin_info, animal_ids) -> torch.Tensor:
    """Cluster assignments outside the ROI masked: -1 in (T,) hard labels,
    NaN rows in (T, K) soft counts (as floating point)."""
    out = values
    for aid in _as_list(animal_ids):
        bad = ~_mask(local_bin_info, aid, values)
        if out.ndim == 1:
            out = torch.where(bad, torch.full_like(out, -1), out)
        else:
            out = torch.where(bad[:, None], torch.nan, out if out.is_floating_point() else out.double())
    return out


# --------------------------------------------------------------------------- #
# Aliases (deepof_tpu/utils.py:1522-1606)
# --------------------------------------------------------------------------- #


def kleinberg(offsets, s: float = 2.0, gamma: float = 1.0, n=None, T=None, k=None):
    """Kleinberg burst detection: see :func:`deepof_tpu_torch.ops.bursts.kleinberg`."""
    from deepof_tpu_torch.ops.bursts import kleinberg as _kleinberg

    return _kleinberg(offsets, s=s, gamma=gamma, n=n, T=T, k=k)


def smooth_boolean_array(a, scale: int = 1, sigma=2.0, batch_size: int = 50000):
    """Burst smoothing of a boolean series: see
    :func:`deepof_tpu_torch.ops.bursts.smooth_boolean_array`."""
    from deepof_tpu_torch.ops.bursts import smooth_boolean_array as _smooth

    return _smooth(np.asarray(a), scale=scale, sigma=sigma, batch_size=batch_size)


def gmm_compute(x, n_components: int, cv_type: str, device="cuda"):
    """One GMM fit and its BIC: see :func:`deepof_tpu_torch.evaluation.gmm_compute`."""
    from deepof_tpu_torch.evaluation import gmm_compute as _compute

    return _compute(x, n_components, cv_type, device=device)


def gmm_model_selection(*args, **kwargs):
    """The bootstrap BIC scan: see :func:`deepof_tpu_torch.evaluation.gmm_model_selection`."""
    from deepof_tpu_torch.evaluation import gmm_model_selection as _selection

    return _selection(*args, **kwargs)
