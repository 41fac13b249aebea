"""Device-side two-stage feature scaling (port of deepof_tpu/ops/scaling.py),
plus the column bookkeeping and the cohort-wide global fit that drive it
(the port of ``TableDict``'s device scaling helpers,
``deepof_tpu/core/table_dict.py:881-1020,1110``). ``core.table_dict`` runs
these over every recording of a project; ``scale_merged_frame`` is the case
of one frame.

Passes over a (T, F) frame:
  * ``size_divisors``  - per-column body-size divisors (nan-median of the
    Nose-Tail_base distance per animal).
  * ``scale_stage12``  - size normalisation, log1p distance compression,
    per-column local standardisation, and blocked (count, sum) statistics.
  * ``col_ssd``        - blocked sum of squared deviations around the
    cohort mean (second pass of the global standard-scaler fit).
  * ``finish_scaled``  - global transform, outlier clip, NaN
    re-interpolation and nan_to_num.
The blocked statistics are combined in float64 on the host, as the JAX
package does, so the fitted scaler carries no O(sqrt(T) eps) drift.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from deepof_tpu_torch.ops.interp import cummax_values, cummin_values, scan_dim0

# Rows per block of the global-fit statistics (deepof_tpu/ops/scaling.py:68).
_STAT_BLOCK = 4096


def interp_nan_columns(x: torch.Tensor) -> torch.Tensor:
    """Per-column linear interpolation of NaN runs, nearest-value fill at
    both edges; all-NaN columns stay NaN."""
    t = x.shape[0]
    idx = torch.arange(t, device=x.device)[:, None].expand(x.shape)
    valid = ~torch.isnan(x)
    prev_i = scan_dim0(cummax_values, torch.where(valid, idx, -1))
    next_i = scan_dim0(cummin_values, torch.where(valid, idx, t).flip(0)).flip(0)
    prev_v = torch.gather(x, 0, prev_i.clamp(0, t - 1))
    next_v = torch.gather(x, 0, next_i.clamp(0, t - 1))
    has_prev = prev_i >= 0
    has_next = next_i < t
    span = (next_i - prev_i).clamp(min=1).to(x.dtype)
    w = (idx - prev_i).to(x.dtype) / span
    interior = prev_v + w * (next_v - prev_v)
    filled = torch.where(
        has_prev & has_next,
        interior,
        torch.where(has_prev, prev_v, torch.where(has_next, next_v, x)),
    )
    return torch.where(valid, x, filled)


def _blocked(x: torch.Tensor) -> torch.Tensor:
    """(T, F) -> (ceil(T/B), B, F), NaN-padded."""
    t, f = x.shape
    nb = -(-t // _STAT_BLOCK)
    pad = x.new_full((nb * _STAT_BLOCK - t, f), torch.nan)
    return torch.cat([x, pad]).reshape(nb, _STAT_BLOCK, f)


def scale_stage12(
    x: torch.Tensor,
    divisor: torch.Tensor,
    log_mask: torch.Tensor,
    local_mask: torch.Tensor,
):
    """Stage 1 (size normalisation + distance compression) and stage 2
    (local standardisation) of the two-stage scaler.

    Returns (scaled (T, F), blocked valid count (nb, F), blocked sum (nb, F)),
    the statistics taken after local scaling.
    """
    x = x / divisor
    x = torch.where(log_mask, torch.log1p(x.clamp(min=0.0)), x)
    isn = torch.isnan(x)
    cnt = (~isn).sum(dim=0).to(x.dtype)
    safe = cnt.clamp(min=1.0)
    mean = torch.where(isn, 0.0, x).sum(dim=0) / safe
    d = torch.where(isn, 0.0, x - mean)
    scale = torch.sqrt((d * d).sum(dim=0) / safe)
    # sklearn's _handle_zeros_in_scale: constant features divide by 1.
    scale = torch.where((scale == 0.0) | ~torch.isfinite(scale), 1.0, scale)
    x = torch.where(local_mask, (x - mean) / scale, x)
    xb = _blocked(x)
    isn2 = torch.isnan(xb)
    return x, (~isn2).sum(dim=1), torch.where(isn2, 0.0, xb).sum(dim=1)


def _nanmedian(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Median ignoring NaNs, averaging the two middle values for an even
    count (``jnp.nanmedian``; ``torch.nanmedian`` returns the lower one)."""
    s = torch.sort(x, dim=dim).values  # NaNs sort last
    n = (~torch.isnan(x)).sum(dim=dim, keepdim=True)
    lo = ((n - 1).clamp(min=0)) // 2
    hi = n // 2
    mid = (torch.gather(s, dim, lo) + torch.gather(s, dim, hi.clamp(max=x.shape[dim] - 1))) / 2
    return torch.where(n > 0, mid, torch.nan).squeeze(dim)


def size_divisors(
    x: torch.Tensor, w: torch.Tensor, c: torch.Tensor, quads
) -> torch.Tensor:
    """Per-column body-size divisors on the device.

    Args:
        x: (T, F) merged feature frame (mm, NaNs allowed).
        w: (F, A+1) weights over [per-animal factors, cohort default].
        c: (F,) constant term (1.0 for columns that never size-scale).
        quads: per-animal (nose_x, nose_y, tail_x, tail_y) column indices,
            or None where the animal lacks them (factor = cohort default).
    """
    raws = []
    for q in quads:
        if q is None:
            raws.append(x.new_tensor(float("nan")))
        else:
            ax, ay, bx, by = q
            raws.append(_nanmedian(torch.hypot(x[:, ax] - x[:, bx], x[:, ay] - x[:, by])))
    raw = torch.stack(raws)
    valid = torch.isfinite(raw) & (raw > 0)
    default = _nanmedian(torch.where(valid, raw, torch.nan))
    default = torch.where(torch.isfinite(default), default, 1.0)
    ext = torch.cat([torch.where(valid, raw, default), default[None]])
    return w.to(x.dtype) @ ext + c.to(x.dtype)


def col_ssd(x: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    """Blocked (nb, F) NaN-ignoring sums of squared deviations around ``mean``."""
    xb = _blocked(x)
    d = torch.where(torch.isnan(xb), 0.0, xb - mean)
    return (d * d).sum(dim=1)


def finish_scaled(
    x: torch.Tensor,
    gmean: torch.Tensor,
    gscale: torch.Tensor,
    global_mask: torch.Tensor,
    clip_mask: torch.Tensor,
    interp_thresh: float,
) -> torch.Tensor:
    """Global per-column scaler, NaN out |x| > interp_thresh on clipped
    columns, re-interpolate every NaN run, zero what remains."""
    x = torch.where(global_mask, (x - gmean) / gscale, x)
    if interp_thresh:
        x = torch.where(clip_mask & (x.abs() > interp_thresh), torch.nan, x)
    return torch.nan_to_num(interp_nan_columns(x), nan=0.0)




# --------------------------------------------------------------------------- #
# Column bookkeeping and the cohort-wide global fit
# --------------------------------------------------------------------------- #


def _animal_of(bodypart: str) -> Optional[str]:
    head, sep, _ = bodypart.partition("_")
    return head if sep else None


# TableDict.preprocess defaults on the serving path: standardised values
# beyond 10 are re-interpolated, and body size is the Nose-Tail_base length.
INTERP_THRESH = 10.0
SIZE_REF = ("Nose", "Tail_base")
SECTIONS = ("speed", "dist", "coord")


def _column_kinds(columns: Sequence) -> np.ndarray:
    """Graph-dataset column kinds: ``(bp, "x"|"y")`` coordinates,
    bare-bodypart speeds, 3-tuple angles, bodypart-pair distances."""
    bodyparts = {c[0] for c in columns if isinstance(c, tuple) and len(c) == 2 and c[1] in ("x", "y")}
    kinds = []
    for col in columns:
        if isinstance(col, str):
            kinds.append("speed" if col in bodyparts else None)
        elif len(col) == 3:
            kinds.append("angle")
        elif len(col) == 2 and col[1] in ("x", "y"):
            kinds.append("coord")
        elif len(col) == 2 and col[0] in bodyparts and col[1] in bodyparts:
            kinds.append("dist")
        else:
            kinds.append(None)
    return np.asarray(kinds, dtype=object)


def scale_plan(
    columns: Sequence,
    animal_ids: Sequence[str],
    log_distances: bool = True,
    dist_standardize: Optional[str] = "per_column",
    speed_standardize: Optional[str] = "per_column",
    coord_standardize: Optional[str] = "per_column",
    interp_thresh: float = INTERP_THRESH,
) -> dict:
    """Masks, sections and divisor encoding for the device scaling of a
    frame whose columns follow the graph-dataset naming, with the
    "standard" scaler, inter_scale="mean" and each standardize mode
    "per_column" or None. The port of ``_build_scale_meta`` and
    ``_divisor_encoding`` (``deepof_tpu/core/table_dict.py:881,919``).

    Returns a dict: ``columns``; ``w (F, A+1)``, ``c (F,)`` and ``quads``
    for :func:`size_divisors`; bool masks ``log``, ``local``, ``clip``;
    ``sections`` (speed / dist / coord column indices, in column order) and
    their ``modes``; ``interp_thresh``.
    """
    columns = list(columns)
    f = len(columns)
    pos = {c: i for i, c in enumerate(columns)}
    kinds = _column_kinds(columns)
    is_dist = kinds == "dist"
    is_speed = kinds == "speed"
    is_coord = kinds == "coord"

    aid_idx = {aid: i for i, aid in enumerate(animal_ids)}
    n_a = len(animal_ids)
    w = np.zeros((f, n_a + 1), np.float32)
    c = np.ones(f, np.float32)
    for j, col in enumerate(columns):
        if kinds[j] in ("coord", "speed"):
            a = _animal_of(col[0] if kinds[j] == "coord" else col)
            if a in aid_idx:
                w[j, aid_idx[a]] = 1.0
                c[j] = 0.0
        elif kinds[j] == "dist":
            a1, a2 = _animal_of(col[0]), _animal_of(col[1])
            c[j] = 0.0
            if a1 == a2:
                w[j, aid_idx.get(a1, n_a)] = 1.0
            else:
                w[j, aid_idx.get(a1, n_a)] += 0.5
                w[j, aid_idx.get(a2, n_a)] += 0.5

    quads = []
    for aid in animal_ids:
        a = SIZE_REF[0] if aid is None else f"{aid}_{SIZE_REF[0]}"
        b = SIZE_REF[1] if aid is None else f"{aid}_{SIZE_REF[1]}"
        need = [(a, "x"), (a, "y"), (b, "x"), (b, "y")]
        quads.append(tuple(pos[k] for k in need) if all(k in pos for k in need) else None)

    local = np.zeros(f, bool)
    if speed_standardize:
        local |= is_speed
    if dist_standardize:
        local |= is_dist
    return {
        "columns": columns,
        "w": w,
        "c": c,
        "quads": tuple(quads),
        "log": is_dist if log_distances else np.zeros(f, bool),
        "local": local,
        "clip": is_speed | is_dist | is_coord,
        "sections": {
            "speed": np.flatnonzero(is_speed),
            "dist": np.flatnonzero(is_dist),
            "coord": np.flatnonzero(is_coord),
        },
        "modes": {"speed": speed_standardize, "dist": dist_standardize, "coord": coord_standardize},
        "interp_thresh": float(interp_thresh or 0.0),
    }


def _put(a, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), device=like.device)


def stage12(frame: torch.Tensor, plan: dict):
    """Body-size divisors, then :func:`scale_stage12` of one frame.
    Returns (scaled, blocked count, blocked sum)."""
    divisor = size_divisors(frame, _put(plan["w"], frame), _put(plan["c"], frame), plan["quads"])
    return scale_stage12(frame, divisor, _put(plan["log"], frame), _put(plan["local"], frame))


def column_totals(cnt: torch.Tensor, sm: torch.Tensor):
    """The blocked (count, sum) statistics of one frame as float64 host
    column totals."""
    return (cnt.to("cpu", torch.float64).sum(dim=0).numpy(),
            sm.to("cpu", torch.float64).sum(dim=0).numpy())


class _StandardScalerLite:
    """A fitted standard scaler (``mean_`` / ``var_`` / ``scale_``,
    ``transform`` / ``inverse_transform``), the port of
    ``deepof_tpu/core/table_dict.py:1110``."""

    def __init__(self, mean, var):
        self.mean_ = mean
        self.var_ = var
        scale = np.sqrt(var)
        # sklearn's _handle_zeros_in_scale: constant features divide by 1.
        scale[(scale == 0.0) | ~np.isfinite(scale)] = 1.0
        self.scale_ = scale

    def transform(self, x):
        return (np.asarray(x, dtype=np.float64) - self.mean_) / self.scale_

    def inverse_transform(self, x):
        return np.asarray(x, dtype=np.float64) * self.scale_ + self.mean_


def fit_global_scaler(stats, plan: dict) -> Optional[dict]:
    """Streamed standard-scaler fit over a cohort, combined in float64 on
    the host: the cohort mean from every frame's (count, sum) totals, then
    one ``col_ssd`` pass per frame around it.

    Args:
        stats: per frame, (scaled frame, count totals, sum totals) as
            :func:`stage12` and :func:`column_totals` give them.
        plan: :func:`scale_plan` output.

    Returns the section scaler dict (``kind``, ``speed``, ``dist``,
    ``dist_inner``, ``dist_intra``, ``coord``), or None when no section is
    per-column.
    """
    f = len(plan["columns"])
    cnt_h, sum_h = np.zeros(f), np.zeros(f)
    for _, cnt, sm in stats:
        cnt_h += cnt
        sum_h += sm
    mean_h = sum_h / np.maximum(cnt_h, 1.0)
    ssd_h = np.zeros(f)
    for xs, _, _ in stats:
        mean_d = torch.as_tensor(mean_h, dtype=xs.dtype, device=xs.device)
        ssd_h += col_ssd(xs, mean_d).to("cpu", torch.float64).sum(dim=0).numpy()
    var_h = ssd_h / np.maximum(cnt_h, 1.0)
    mean_h[cnt_h == 0] = np.nan
    var_h[cnt_h == 0] = np.nan
    scaler = {"kind": "standard", "speed": None, "dist": None, "dist_inner": None,
              "dist_intra": None, "coord": None}
    for name in SECTIONS:
        idx = plan["sections"][name]
        if plan["modes"][name] == "per_column" and len(idx):
            scaler[name] = _StandardScalerLite(mean_h[idx], var_h[idx])
    if all(v is None for k, v in scaler.items() if k != "kind"):
        return None
    return scaler


def _global_scaler_vectors(gs: Optional[dict], plan: dict):
    """The section scaler dict as full-length per-column (mean, scale,
    mask) vectors for :func:`finish_scaled`; a section applies only where
    its mode is "per_column". None when the dict holds what the per-column
    formulation cannot express (groupwise sections, another kind of
    scaler, sizes that do not match). The port of
    ``deepof_tpu/core/table_dict.py:984``."""
    f = len(plan["columns"])
    gmean = np.zeros(f, np.float32)
    gscale = np.ones(f, np.float32)
    gmask = np.zeros(f, bool)
    if gs is None:
        return gmean, gscale, gmask
    if gs.get("kind", "standard") != "standard":
        return None
    if gs.get("dist_inner") is not None or gs.get("dist_intra") is not None:
        return None
    for name in SECTIONS:
        sc, idx = gs.get(name), plan["sections"][name]
        if sc is None or not len(idx) or plan["modes"][name] != "per_column":
            continue
        mean = getattr(sc, "mean_", None)
        scale = getattr(sc, "scale_", None)
        if mean is None or scale is None or np.size(mean) != len(idx):
            return None
        gmean[idx] = np.asarray(mean, np.float64)
        gscale[idx] = np.asarray(scale, np.float64)
        gmask[idx] = True
    return gmean, gscale, gmask


def finish(xs: torch.Tensor, vectors, plan: dict) -> torch.Tensor:
    """:func:`finish_scaled` with the (mean, scale, mask) vectors of
    :func:`_global_scaler_vectors`."""
    gmean, gscale, gmask = vectors
    return finish_scaled(
        xs, _put(gmean, xs).to(xs.dtype), _put(gscale, xs).to(xs.dtype), _put(gmask, xs),
        _put(plan["clip"], xs), plan["interp_thresh"],
    )


def scale_merged_frame(frame: torch.Tensor, plan: dict) -> torch.Tensor:
    """All device scaling passes over one merged frame, in its dtype, with
    the global scaler fitted on the frame itself (as a training run on one
    recording fits it). Returns the scaled (T, F) frame.

    Args:
        frame: (T, F) merged features on the working device.
        plan: :func:`scale_plan` output.
    """
    xs, cnt, sm = stage12(frame, plan)
    scaler = fit_global_scaler([(xs, *column_totals(cnt, sm))], plan)
    return finish(xs, _global_scaler_vectors(scaler, plan), plan)
