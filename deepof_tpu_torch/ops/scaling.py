"""Two-stage feature scaling on the device (port of deepof_tpu/ops/scaling.py
and of the host scaling helpers of ``deepof_tpu/utils.py:24-430``), plus the
column bookkeeping and the cohort-wide global fit that drive it (the port
of ``TableDict``'s scaling helpers, ``deepof_tpu/core/table_dict.py:881-1330``).
``core.table_dict`` runs these over every recording of a project;
``scale_merged_frame`` is the case of one frame.

Two formulations, as in the JAX package:

* the float32 device formulation (standard scaler, per-column or disabled
  standardize modes), passes over a (T, F) frame:
  ``size_divisors`` (per-column body-size divisors, the nan-median
  Nose-Tail_base distance per animal), ``scale_stage12`` (size
  normalisation, log1p distance compression, per-column local
  standardisation and blocked (count, sum) statistics), ``col_ssd``
  (blocked sums of squared deviations around the cohort mean) and
  ``finish_scaled`` (global transform, outlier clip, NaN re-interpolation,
  nan_to_num). The blocked statistics are combined in float64 on the host,
  so the fitted scaler carries no O(sqrt(T) eps) drift;
* the general formulation, run in float64 on the same device:
  ``scale_table`` (the two-stage table scaler with sklearn's semantics:
  ``StandardScaler``, ``MinMaxScaler``, ``RobustScaler``, per-column or
  groupwise sections) and ``finish_general`` (global sections, clip,
  angle and NaN interpolation).
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


def size_factors(x: torch.Tensor, quads) -> torch.Tensor:
    """Per-animal body-size factors and the cohort default, (A+1,) on the
    device: each animal's nan-median Nose-Tail_base distance, an animal
    without a valid one (or without those columns, ``quads[a]`` None) taking
    the default, the nan-median of the valid factors (1.0 when none is).
    The device form of ``deepof_tpu/utils.py:209`` ``compute_size_factors``.
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
    return torch.cat([torch.where(valid, raw, default), default[None]])


def size_divisors(
    x: torch.Tensor, w: torch.Tensor, c: torch.Tensor, quads
) -> torch.Tensor:
    """Per-column body-size divisors on the device: ``w @ size_factors + c``.

    Args:
        x: (T, F) merged feature frame (mm, NaNs allowed).
        w: (F, A+1) weights over [per-animal factors, cohort default].
        c: (F,) constant term (1.0 for columns that never size-scale).
        quads: per-animal (nose_x, nose_y, tail_x, tail_y) column indices,
            or None where the animal lacks them (factor = cohort default).
    """
    return w.to(x.dtype) @ size_factors(x, quads) + c.to(x.dtype)


def compute_size_factors(x: torch.Tensor, columns: Sequence, animal_ids: Sequence,
                         size_ref=None) -> tuple:
    """({animal: factor}, default) as 0-d tensors on ``x``'s device, for a
    (T, F) table with ``columns`` (``deepof_tpu/utils.py:209``). Names are
    built as the JAX package builds them: only an animal id of None maps to
    unprefixed bodyparts."""
    pos = {c: i for i, c in enumerate(columns)}
    quads = _size_quads(pos, animal_ids, size_ref or SIZE_REF)
    ext = size_factors(x, quads)
    return {aid: ext[i] for i, aid in enumerate(animal_ids)}, ext[-1]


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
    bare-bodypart speeds, 3-tuple angles, bodypart-pair distances, None
    for anything else (``deepof_tpu/utils.py:116`` ``classify_column``)."""
    bodyparts = _bodyparts(columns)
    kinds = []
    for col in columns:
        if isinstance(col, str):
            kinds.append("speed" if col in bodyparts else None)
        elif not isinstance(col, tuple):
            kinds.append(None)
        elif len(col) == 3:
            kinds.append("angle")
        elif len(col) == 2 and col[1] in ("x", "y"):
            kinds.append("coord")
        elif len(col) == 2 and col[0] in bodyparts and col[1] in bodyparts:
            kinds.append("dist")
        else:
            kinds.append(None)
    return np.asarray(kinds, dtype=object)


def _bodyparts(columns) -> set:
    return {c[0] for c in columns if isinstance(c, tuple) and len(c) == 2 and c[1] in ("x", "y")}


def infer_column_types(columns: Sequence) -> dict:
    """Columns by kind, in column order: ``coords``, ``speeds``, ``dists``
    (split into within-animal ``inner_dists`` and between-animal
    ``intra_dists``), ``angles``, ``scalars`` (speeds then distances) and
    the set of ``bodyparts`` (``deepof_tpu/utils.py:140``)."""
    columns = list(columns)
    kinds = _column_kinds(columns)
    out = {name: [c for c, k in zip(columns, kinds) if k == kind]
           for name, kind in (("coords", "coord"), ("speeds", "speed"), ("dists", "dist"), ("angles", "angle"))}
    out["inner_dists"] = [d for d in out["dists"] if _animal_of(d[0]) == _animal_of(d[1])]
    out["intra_dists"] = [d for d in out["dists"] if _animal_of(d[0]) != _animal_of(d[1])]
    out["bodyparts"] = _bodyparts(columns)
    out["scalars"] = out["speeds"] + out["dists"]
    return out


def _standardize_section_plan(ct: dict, dist_standardize, speed_standardize, coord_standardize) -> list:
    """Stage-2 sections of the table scaler, [(columns, mode)]: speeds,
    distances (per column, or within- and between-animal groups), coordinates
    (``deepof_tpu/utils.py:287``)."""
    plan = []
    if speed_standardize:
        plan.append((ct["speeds"], speed_standardize))
    if dist_standardize == "per_column":
        plan.append((ct["dists"], "per_column"))
    elif dist_standardize == "groupwise":
        plan.append((ct["inner_dists"], "groupwise"))
        plan.append((ct["intra_dists"], "groupwise"))
    if coord_standardize:
        plan.append((ct["coords"], coord_standardize))
    return [(cols, mode) for cols, mode in plan if cols]


def _size_quads(pos: dict, animal_ids, size_ref=SIZE_REF) -> tuple:
    quads = []
    for aid in animal_ids:
        a = size_ref[0] if aid is None else f"{aid}_{size_ref[0]}"
        b = size_ref[1] if aid is None else f"{aid}_{size_ref[1]}"
        need = [(a, "x"), (a, "y"), (b, "x"), (b, "y")]
        quads.append(tuple(pos[k] for k in need) if all(k in pos for k in need) else None)
    return tuple(quads)


def scale_plan(
    columns: Sequence,
    animal_ids: Sequence[str],
    log_distances: bool = True,
    dist_standardize: Optional[str] = "per_column",
    speed_standardize: Optional[str] = "per_column",
    coord_standardize: Optional[str] = "per_column",
    interp_thresh: float = INTERP_THRESH,
) -> dict:
    """Masks, sections and divisor encoding for the scaling of a frame whose
    columns follow the graph-dataset naming, with inter_scale="mean". The
    port of ``_build_scale_meta`` and ``_divisor_encoding``
    (``deepof_tpu/core/table_dict.py:881,919``); the encoding is
    ``compute_size_factors`` + ``_size_divisor_plan``
    (``deepof_tpu/utils.py:209,242``) as one matrix product: coordinates and
    speeds divide by their own animal's factor when their prefix names a
    known animal, distances by their animal's (between animals, the mean of
    the two), an unknown animal taking the cohort default.

    Returns a dict: ``columns``; ``ct`` (:func:`infer_column_types`); ``w
    (F, A+1)``, ``c (F,)`` and ``quads`` for :func:`size_divisors`; bool
    masks ``log``, ``local``, ``clip``; ``sections`` (speed / dist / coord
    column indices, in column order) and their ``modes``; ``interp_thresh``.
    """
    columns = list(columns)
    f = len(columns)
    pos = {c: i for i, c in enumerate(columns)}
    kinds = _column_kinds(columns)
    ct = infer_column_types(columns)
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

    local = np.zeros(f, bool)
    if speed_standardize:
        local |= is_speed
    if dist_standardize:
        local |= is_dist
    return {
        "columns": columns,
        "ct": ct,
        "w": w,
        "c": c,
        "quads": _size_quads(pos, animal_ids),
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
    if isinstance(a, torch.Tensor):
        return a.to(like.device)
    return torch.as_tensor(np.asarray(a), device=like.device)


def _host(a) -> np.ndarray:
    """A fitted attribute (array or tensor) as a float64 host array."""
    if isinstance(a, torch.Tensor):
        a = a.cpu()
    return np.asarray(a, np.float64)


def stage12(frame: torch.Tensor, plan: dict, sizes: Optional[torch.Tensor] = None):
    """Body-size divisors (measured on ``sizes``, by default the frame
    itself), then :func:`scale_stage12` of one frame in its dtype.
    Returns (scaled, blocked count, blocked sum)."""
    src = frame if sizes is None else sizes
    divisor = size_divisors(src, _put(plan["w"], src), _put(plan["c"], src), plan["quads"]).to(frame.dtype)
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
        if isinstance(x, torch.Tensor):
            return (x - _put(self.mean_, x).to(x.dtype)) / _put(self.scale_, x).to(x.dtype)
        return (np.asarray(x, dtype=np.float64) - self.mean_) / self.scale_

    def inverse_transform(self, x):
        if isinstance(x, torch.Tensor):
            return x * _put(self.scale_, x).to(x.dtype) + _put(self.mean_, x).to(x.dtype)
        return np.asarray(x, dtype=np.float64) * self.scale_ + self.mean_


def fit_standard_lite(bucket) -> _StandardScalerLite:
    """A NaN-ignoring standard fit over a list of (n, k) sample blocks, in
    two passes (the column means, then the squared deviations around them),
    each block's sums taken on its device in float64 and combined on the
    host: the port of ``_fast_fit_standard``
    (``deepof_tpu/core/table_dict.py:1132``)."""
    count = total = 0.0
    for a in bucket:
        a = a.to(torch.float64)
        valid = ~torch.isnan(a)
        count = count + valid.sum(dim=0).to("cpu", torch.float64).numpy()
        total = total + torch.where(valid, a, 0.0).sum(dim=0).cpu().numpy()
    safe = np.maximum(count, 1.0)
    mean = total / safe
    ssd = 0.0
    for a in bucket:
        a = a.to(torch.float64)
        d = a - torch.as_tensor(mean, device=a.device)
        ssd = ssd + torch.where(torch.isnan(d), 0.0, d * d).sum(dim=0).cpu().numpy()
    var = ssd / safe
    mean[count == 0] = np.nan
    var[count == 0] = np.nan
    return _StandardScalerLite(mean, var)


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
        gmean[idx] = _host(mean)
        gscale[idx] = _host(scale)
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


# --------------------------------------------------------------------------- #
# The three scalers, as tensor classes with sklearn's semantics
# --------------------------------------------------------------------------- #

_EPS64 = float(np.finfo(np.float64).eps)


def _as_f64(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device or x.device, dtype=torch.float64)
    return torch.as_tensor(np.asarray(x, np.float64), device=device)


def _zeros_to_one(scale: torch.Tensor, constant: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sklearn's ``_handle_zeros_in_scale``: near-constant features (a scale
    under 10 eps, or the given mask) divide by 1; NaN stays NaN."""
    if constant is None:
        constant = scale < 10 * _EPS64
    return torch.where(constant, 1.0, scale)


def _nanquantiles(x: torch.Tensor, qs: Sequence[float]) -> torch.Tensor:
    """(len(qs), F) per-column quantiles of (n, F) ``x`` ignoring NaNs,
    numpy's "linear" method (``np.nanpercentile`` at 100 q), by one sort
    and index arithmetic; NaN for an all-NaN column. (``torch.nanquantile``
    refuses more than 2**24 elements, and ``torch.nanmedian`` returns the
    lower of the middle pair.)"""
    s = torch.sort(x, dim=0).values  # NaNs sort last
    n = (~torch.isnan(x)).sum(dim=0)
    last = (n - 1).clamp(min=0)
    out = []
    for q in qs:
        pos = q * last.to(torch.float64)
        lo = pos.floor().long()
        hi = pos.ceil().long()
        a = torch.gather(s, 0, lo[None])[0]
        b = torch.gather(s, 0, hi[None])[0]
        t = (pos - lo).to(x.dtype)
        diff = b - a
        # numpy's _lerp: from the nearer end, so that t = 1 gives b exactly.
        v = torch.where(t >= 0.5, b - diff * (1 - t), a + diff * t)
        out.append(torch.where(n > 0, v, torch.nan))
    return torch.stack(out)


def _nanminmax(x: torch.Tensor):
    """Per-column (nanmin, nanmax); NaN for an all-NaN column."""
    isn = torch.isnan(x)
    lo = torch.where(isn, torch.inf, x).amin(dim=0)
    hi = torch.where(isn, -torch.inf, x).amax(dim=0)
    empty = isn.all(dim=0)
    return torch.where(empty, torch.nan, lo), torch.where(empty, torch.nan, hi)


class _TensorScaler:
    """Shared plumbing: ``fit`` takes an (n, F) tensor or array and keeps
    float64 tensors on its device; ``transform`` / ``inverse_transform``
    return a tensor for a tensor (on its device, in float64) and a numpy
    array for anything else."""

    def fit_transform(self, x):
        return self.fit(x).transform(x)

    def _apply(self, fn, x):
        if isinstance(x, torch.Tensor):
            return fn(_as_f64(x))
        return fn(_as_f64(x, self._device)).cpu().numpy()

    def transform(self, x):
        return self._apply(self._forward, x)

    def inverse_transform(self, x):
        return self._apply(self._inverse, x)

    def _attr(self, name, like):
        return getattr(self, name).to(like.device)


class StandardScaler(_TensorScaler):
    """sklearn's ``StandardScaler``: ``mean_``, ``var_`` (population),
    ``scale_`` (the standard deviation, 1 for a near-constant feature by
    sklearn's ``_is_constant_feature`` bound), ``n_samples_seen_``."""

    def fit(self, x):
        x = _as_f64(x)
        self._device = x.device
        valid = ~torch.isnan(x)
        n = valid.sum(dim=0).to(torch.float64)
        mean = torch.where(valid, x, 0.0).sum(dim=0) / n
        d = torch.where(valid, x - mean, 0.0)
        var = (d * d).sum(dim=0) / n
        constant = var <= n * _EPS64 * var + (n * mean * _EPS64) ** 2
        self.mean_, self.var_, self.n_samples_seen_ = mean, var, n
        self.scale_ = _zeros_to_one(torch.sqrt(var), constant)
        return self

    def _forward(self, x):
        return (x - self._attr("mean_", x)) / self._attr("scale_", x)

    def _inverse(self, x):
        return x * self._attr("scale_", x) + self._attr("mean_", x)


class MinMaxScaler(_TensorScaler):
    """sklearn's ``MinMaxScaler`` onto [0, 1]: ``data_min_``, ``data_max_``,
    ``data_range_``, ``scale_``, ``min_``."""

    def fit(self, x):
        x = _as_f64(x)
        self._device = x.device
        self.data_min_, self.data_max_ = _nanminmax(x)
        self.data_range_ = self.data_max_ - self.data_min_
        self.scale_ = 1.0 / _zeros_to_one(self.data_range_)
        self.min_ = -self.data_min_ * self.scale_
        self.n_samples_seen_ = x.shape[0]
        return self

    def _forward(self, x):
        return x * self._attr("scale_", x) + self._attr("min_", x)

    def _inverse(self, x):
        return (x - self._attr("min_", x)) / self._attr("scale_", x)


class RobustScaler(_TensorScaler):
    """sklearn's ``RobustScaler`` (quantile range 25-75): ``center_`` the
    nan-median, ``scale_`` the interquartile range."""

    def fit(self, x):
        x = _as_f64(x)
        self._device = x.device
        q25, q50, q75 = _nanquantiles(x, (0.25, 0.5, 0.75))
        self.center_ = q50
        self.scale_ = _zeros_to_one(q75 - q25)
        return self

    def _forward(self, x):
        return (x - self._attr("center_", x)) / self._attr("scale_", x)

    def _inverse(self, x):
        return x * self._attr("scale_", x) + self._attr("center_", x)


SCALERS = {"standard": StandardScaler, "minmax": MinMaxScaler, "robust": RobustScaler}


def make_scaler(scale_kind: str) -> _TensorScaler:
    if scale_kind not in SCALERS:
        raise ValueError(f"Invalid scaler: {scale_kind}.")
    return SCALERS[scale_kind]()


# --------------------------------------------------------------------------- #
# The general formulation: the two-stage table scaler and its finish
# --------------------------------------------------------------------------- #

STANDARDIZE_MODES = ("per_column", "groupwise", None)


def _apply_section(x: torch.Tensor, idx, mode, fn) -> None:
    """``x[:, idx] = fn(section)`` in place, a groupwise section as one
    column of all its values."""
    idx = torch.as_tensor(np.asarray(idx, np.int64), device=x.device)
    arr = x[:, idx]
    if mode == "groupwise":
        x[:, idx] = fn(arr.reshape(-1, 1)).reshape(arr.shape)
    else:
        x[:, idx] = fn(arr)


def scale_table(
    x: torch.Tensor,
    columns: Sequence,
    scale: str = "standard",
    animal_ids=None,
    standardize: bool = True,
    dist_standardize: Optional[str] = "per_column",
    speed_standardize: Optional[str] = "per_column",
    coord_standardize: Optional[str] = "per_column",
    log_distances: bool = True,
    plan: Optional[dict] = None,
) -> torch.Tensor:
    """The two-stage table scaler (``deepof_tpu/utils.py:311``) on a (T, F)
    tensor and its column list, in float64 on the tensor's device: divide
    by the body-size divisors (inter_scale "mean"), log1p-compress the
    clipped distances, then standardise each section (speeds; distances per
    column or as within- and between-animal groups; coordinates) with a
    fresh scaler of kind ``scale`` fitted on it. Returns a new tensor;
    angles and unknown columns pass through. ``plan`` is
    :func:`scale_plan`'s, for callers that have it."""
    x = _as_f64(x)
    if not scale:
        return x.clone()
    if scale not in SCALERS:
        raise ValueError("scale must be one of {'standard','minmax','robust'}")
    for mode in (dist_standardize, speed_standardize, coord_standardize):
        if mode not in STANDARDIZE_MODES:
            raise ValueError("standardize modes must be per_column/groupwise/None")
    columns = list(columns)
    if animal_ids is None:
        animal_ids = sorted({_animal_of(bp) for bp in _bodyparts(columns) if _animal_of(bp)}) or [None]
    if plan is None:
        plan = scale_plan(columns, list(animal_ids), log_distances)
    x = x / size_divisors(x, _put(plan["w"], x), _put(plan["c"], x), plan["quads"])
    if log_distances:
        x = torch.where(_put(plan["log"], x), torch.log1p(x.clamp(min=0.0)), x)
    if not standardize:
        return x
    pos = {c: i for i, c in enumerate(columns)}
    for cols, mode in _standardize_section_plan(plan["ct"], dist_standardize, speed_standardize,
                                                coord_standardize):
        _apply_section(x, [pos[c] for c in cols], mode, lambda a: make_scaler(scale).fit_transform(a))
    return x


def apply_global_sections(x: torch.Tensor, columns: Sequence, global_scaler: Optional[dict],
                          speed_standardize, dist_standardize, coord_standardize) -> None:
    """The global scaler's sections, in place on a (T, F) frame: each per
    column, or groupwise over the whole section, as its mode says
    (``deepof_tpu/core/table_dict.py:1304`` ``_apply_global_scaler``)."""
    if global_scaler is None:
        return
    ct = infer_column_types(columns)
    pos = {c: i for i, c in enumerate(columns)}
    sections = [("speed", ct["speeds"], speed_standardize), ("coord", ct["coords"], coord_standardize)]
    if dist_standardize == "per_column":
        sections.append(("dist", ct["dists"], "per_column"))
    elif dist_standardize == "groupwise":
        sections += [("dist_inner", ct["inner_dists"], "groupwise"),
                     ("dist_intra", ct["intra_dists"], "groupwise")]
    for name, cols, mode in sections:
        scaler = global_scaler.get(name)
        if mode in ("per_column", "groupwise") and cols and scaler is not None:
            _apply_section(x, [pos[c] for c in cols], mode, scaler.transform)


def clip_interp(x: torch.Tensor, idx, thresh: float) -> None:
    """NaN out |value| > ``thresh`` in columns ``idx`` and re-interpolate
    them, in place."""
    if len(idx):
        sub = x[:, idx]
        x[:, idx] = interp_nan_columns(torch.where(sub.abs() > thresh, torch.nan, sub))


def sanitize(x: torch.Tensor, angle_idx=()) -> torch.Tensor:
    """Interpolate the angles, then every NaN run; zero what remains."""
    if len(angle_idx):
        x[:, angle_idx] = interp_nan_columns(x[:, angle_idx])
    return torch.nan_to_num(interp_nan_columns(x), nan=0.0)


def finish_general(
    x: torch.Tensor,
    columns: Sequence,
    global_scaler: Optional[dict],
    scale,
    interpolate_normalized,
    speed_standardize,
    dist_standardize,
    coord_standardize,
) -> torch.Tensor:
    """The finish of a locally scaled (T, F) float64 frame
    (``deepof_tpu/core/table_dict.py:1181`` ``_finish_scaled_positional``):
    the global scaler's sections, then, for the standard scaler, NaN out
    |value| > ``interpolate_normalized`` on speeds, distances and
    coordinates and re-interpolate them; then :func:`sanitize`. Returns a
    new tensor."""
    x = x.clone()
    ct = infer_column_types(columns)
    pos = {c: i for i, c in enumerate(columns)}
    apply_global_sections(x, columns, global_scaler, speed_standardize, dist_standardize, coord_standardize)
    if scale == "standard" and interpolate_normalized:
        clip_interp(x, [pos[c] for c in dict.fromkeys(ct["scalars"] + ct["coords"])], interpolate_normalized)
    return sanitize(x, [pos[c] for c in ct["angles"]])
