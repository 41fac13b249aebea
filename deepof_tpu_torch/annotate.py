"""Supervised annotation on the device: rule-based behavior tagging (port of
``deepof_tpu/annotate.py``).

The JAX package runs its rule battery on the host, in numpy and pandas,
because a device round trip per rule costs more than the rule on a TPU.
On a GPU a launch costs microseconds, so here every (T,) series stays on
the project's device: the getters' device tables feed the rules, the
smoothing cascade and the immobility classifier as tensor ops, and each
recording's tag table crosses to the host once, as one (T, C) copy. The
only other reads are those the semantics force: the valid rows from which
``mouse_lens`` draws its sample (counted in
``supervised_annotation.host_reads``).

Custom behaviors receive a :class:`BehaviorContext` of
:class:`~deepof_tpu_torch.core.storage.DeviceTable` objects (column-
addressed device tables) in place of DataFrames, and may return a tensor
or a numpy array.
"""

from __future__ import annotations

import math
import os
import re
import warnings
from collections import Counter
from dataclasses import dataclass, field, replace
from enum import Enum, auto
from itertools import combinations, cycle
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from deepof_tpu_torch.config import (
    ASYMMETRIC_BEHAVIORS,
    CONTINUOUS_BEHAVIORS,
    CUSTOM_BEHAVIOR_COLOR_MAP,
    SINGLE_BEHAVIORS,
    SYMMETRIC_BEHAVIORS,
)
from deepof_tpu_torch.core.storage import DeviceTable, LazyFrame
from deepof_tpu_torch.core.table_dict import TableDict
from deepof_tpu_torch.ops.bouts import (
    binary_moving_median,
    filter_short_true_segments,
    multi_step_paired_smoothing,
    same_counts,
)
from deepof_tpu_torch.ops.geometry import ellipse_to_polygon, point_polygon
from deepof_tpu_torch.ops.interp import interpolate_linear
from deepof_tpu_torch.posthoc import _kinematics_table_views


def _host_read(name: str) -> None:
    supervised_annotation.host_reads[name] += 1


# --------------------------------------------------------------------------- #
# Reductions with numpy's semantics
# --------------------------------------------------------------------------- #


def nanmedian(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``np.nanmedian``: the mean of the two middle values of an even count
    (``torch.nanmedian`` returns the lower one); NaN where all are NaN."""
    s = torch.sort(x, dim=dim).values  # NaNs last
    n = (~torch.isnan(x)).sum(dim=dim, keepdim=True)
    mid = (s.gather(dim, ((n - 1) // 2).clamp(min=0)) + s.gather(dim, n // 2)) / 2
    return torch.where(n == 0, torch.nan, mid).squeeze(dim)


def nanpercentile(x: torch.Tensor, q: float, dim: int = 0) -> torch.Tensor:
    """``np.nanpercentile(x, q, axis=dim)`` by numpy's linear method, in
    x's dtype as numpy takes it: ``q / 100`` and the virtual index
    ``(n - 1) * q`` in that dtype, its fraction as the weight of numpy's
    two-sided lerp."""
    s = torch.sort(x, dim=dim).values  # NaNs last
    n = (~torch.isnan(x)).sum(dim=dim, keepdim=True)
    virtual = (n - 1).to(x.dtype) * (torch.tensor(q, dtype=x.dtype) / 100)
    below = torch.floor(virtual)
    gamma = virtual - below
    last = (n - 1).clamp(min=0)
    lo = below.to(torch.int64)
    a = s.gather(dim, torch.minimum(lo, last).clamp(min=0))
    b = s.gather(dim, torch.minimum(lo + 1, last).clamp(min=0))
    diff = b - a
    out = torch.where(gamma >= 0.5, b - diff * (1 - gamma), a + diff * gamma)
    return torch.where(n == 0, torch.nan, out).squeeze(dim)


# --------------------------------------------------------------------------- #
# Framework
# --------------------------------------------------------------------------- #


class Behavior_scope(Enum):
    INDIVIDUAL = auto()
    PAIR_DIRECTIONAL = auto()
    PAIR_NONDIRECTIONAL = auto()


class Behavior_output(Enum):
    BINARY = auto()
    CONTINUOUS = auto()


@dataclass
class BehaviorContext:
    """All per-recording tables a behavior rule may read, on the device."""

    key: str
    animal_ids: List[str]
    frame_rate: float
    arena_type: Any
    arena_params: Any
    roi_dict: dict

    raw_coords: DeviceTable
    coords: DeviceTable
    dists: DeviceTable
    angles: DeviceTable
    speeds: DeviceTable
    likelihoods: DeviceTable
    full_features: Any

    params: Dict[str, Any]
    run_numba: bool = False
    extra: Dict[str, Any] = field(default_factory=dict)

    def prefix(self, animal_id: str) -> str:
        return f"{animal_id}_" if animal_id else ""

    def bp(self, animal_id: str, bodypart: str) -> str:
        return f"{animal_id}_{bodypart}" if animal_id else bodypart

    @property
    def device(self) -> torch.device:
        return self.raw_coords.values.device


def _series(y, ctx: BehaviorContext) -> torch.Tensor:
    """A rule's result as a tensor on the context's device."""
    if isinstance(y, torch.Tensor):
        return y.to(ctx.device)
    return torch.as_tensor(np.asarray(y), device=ctx.device)


def _binary(y: torch.Tensor) -> torch.Tensor:
    """``np.nan_to_num(y, nan=0).astype(bool)``."""
    if y.is_floating_point():
        y = torch.where(torch.isnan(y), 0.0, y)
    return y.to(torch.bool)


def postprocess_median_filtering(y, ctx: BehaviorContext, behavior_output=None) -> torch.Tensor:
    out = binary_moving_median(_binary(_series(y, ctx)), int(ctx.params["median_filter_width"]))
    return out.to(torch.float64)


def postprocess_following(y, ctx: BehaviorContext, animal_ids) -> torch.Tensor:
    y = postprocess_median_filtering(y, ctx, Behavior_output.BINARY).to(torch.bool)
    return filter_short_true_segments(y, int(ctx.params["min_follow_frames"])).to(torch.float64)


def postprocess_identity(y, ctx: BehaviorContext, animal_ids) -> torch.Tensor:
    return _series(y, ctx).to(torch.float64)


@dataclass(frozen=True)
class DeepOF_behavior:
    """A named behavior rule with scope, output type, compute + postprocess."""

    name: str
    scope: Behavior_scope
    output_type: Behavior_output
    compute: Callable
    unit: Optional[str] = "a.u."
    postprocess: Optional[Callable] = None
    requires: Tuple[str, ...] = ()
    order: int = 0
    color: Optional[str] = None

    def set_color(self, color: Optional[str]) -> "DeepOF_behavior":
        return replace(self, color=color)

    def column_name(self, ctx: BehaviorContext, animal_ids) -> str:
        if self.scope is Behavior_scope.INDIVIDUAL:
            return f"{ctx.prefix(animal_ids)}{self.name}"
        a, b = animal_ids
        return f"{a}_{b}_{self.name}"

    def annotate_behavior(self, ctx: BehaviorContext, animal_ids):
        res = self.compute(ctx, animal_ids)
        if isinstance(res, Mapping):
            out = {}
            for subkey, arr in res.items():
                y = _series(arr, ctx)
                if self.postprocess is not None:
                    y = _series(self.postprocess(y, ctx, animal_ids), ctx)
                out[subkey] = y
            return out
        y = _series(res, ctx)
        if self.postprocess is not None:
            return _series(self.postprocess(y, ctx, animal_ids), ctx)
        return postprocess_median_filtering(y, ctx, self.output_type)


# --------------------------------------------------------------------------- #
# Geometry detectors
# --------------------------------------------------------------------------- #


def _norm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row norms of a (T, 2) difference, summed as ``np.linalg.norm``."""
    d = a - b
    return torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])


def close_single_contact(pos_dframe: DeviceTable, left: str, right=None, tol: float = None) -> torch.Tensor:
    """True where ||left - right|| < tol; ``right`` may be a list (any of)."""
    if isinstance(right, str):
        right = [right]
    hits = [_norm(pos_dframe[left], pos_dframe[r]) < tol for r in right]
    return torch.stack(hits).any(dim=0)


def close_double_contact(
    pos_dframe: DeviceTable, left1: str, left2: str, right1: str, right2: str, rel_tol: float, rev: bool = False,
) -> torch.Tensor:
    """True where both endpoint pairs are within tol (side-by-side tests)."""
    def d(a, b):
        return _norm(pos_dframe[a], pos_dframe[b])

    if rev:
        return (d(right1, left2) < rel_tol) & (d(right2, left1) < rel_tol)
    return (d(right1, left1) < rel_tol) & (d(right2, left2) < rel_tol)


def _arena_polygon(arena) -> np.ndarray:
    """Arena spec -> polygon vertex array (ellipses rasterized)."""
    if isinstance(arena, tuple):
        return ellipse_to_polygon(np.asarray(arena[0], float), np.asarray(arena[1], float), float(arena[2]))
    return np.asarray(arena, float)


def _signed_distance_to_arena(points: torch.Tensor, arena) -> torch.Tensor:
    """float64 signed distance to the arena boundary: positive outside."""
    dist, inside = point_polygon(points, _arena_polygon(arena))
    return torch.where(inside, -dist, dist)


def climb_arena(
    arena_type: str, arena, pos_dict: DeviceTable, rel_tol: float, id: str, mouse_len=50,
    centered_data: bool = False, run_numba: bool = False,
) -> torch.Tensor:
    """True when the nose is more than mouse_len * rel_tol outside the wall."""
    nose = interpolate_linear(pos_dict[id + "Nose"], limit_direction="both")
    tol = mouse_len * rel_tol
    if isinstance(arena, tuple) and centered_data:
        arena = (np.zeros(2), arena[1], arena[2])
    signed = _signed_distance_to_arena(nose, arena)
    return (signed > tol) & torch.isfinite(signed)


def sniff_object(
    speed_dframe: DeviceTable, arena, pos_dict: DeviceTable, tol: float, tol_speed: float, nose: str,
    center_name: str = "Center", centered_data: bool = False, s_object: str = "arena", animal_id: str = "",
    run_numba: bool = False,
) -> torch.Tensor:
    """True when the nose is within +-tol of the arena wall and the body is
    slow."""
    if s_object != "arena":
        raise NotImplementedError("Only arena sniffing is supported.")
    if animal_id:
        animal_id += "_"
    if isinstance(arena, tuple) and centered_data:
        arena = (np.zeros(2), arena[1], arena[2])
    signed = _signed_distance_to_arena(pos_dict[nose], arena)
    nosing = (signed.abs() <= tol) & torch.isfinite(signed)
    return nosing & (speed_dframe[animal_id + center_name] < tol_speed)


def following_path(
    distance_dframe: DeviceTable, position_dframe: DeviceTable, speed_dframe: DeviceTable, follower: str,
    followed: str, frames: int = 20, tol: float = 0, tol_speed: float = 0,
) -> torch.Tensor:
    """True when follower's nose tracks the path followed's tail walked over
    the last ``frames`` frames, with nose->tail orientation."""
    tail = position_dframe[followed + "_Tail_base"]
    nose = position_dframe[follower + "_Nose"]
    t = len(tail)
    min_dist = _norm(nose, tail)
    for i in range(1, frames):
        lead = tail.new_full((min(i, t),), torch.nan)
        min_dist = torch.fmin(min_dist, torch.cat([lead, _norm(nose[i:], tail[:max(t - i, 0)])]))

    def col(a, b):
        return tuple(sorted((a, b)))

    nose_tail = distance_dframe[col(follower + "_Nose", followed + "_Tail_base")]
    right1 = nose_tail < distance_dframe[col(follower + "_Tail_base", followed + "_Tail_base")]
    right2 = nose_tail < distance_dframe[col(follower + "_Nose", followed + "_Nose")]
    follow = (min_dist < tol) & right1 & right2
    return follow & (speed_dframe[follower + "_Nose"] > tol_speed)


def calculate_close_range(df: DeviceTable, mouse_id: str, bodypart: str, threshold: float) -> torch.Tensor:
    """True where the target bodypart is close to any other animal's part
    (any pair column naming it whose other part does not contain
    ``mouse_id``)."""
    target = f"{mouse_id}{bodypart}"
    cols = []
    for col in df.columns:
        p1, p2 = col
        if p1 == target or p2 == target:
            other = p2 if p1 == target else p1
            if mouse_id not in other:
                cols.append(col)
    if not cols:
        return torch.zeros(len(df), dtype=torch.bool, device=df.values.device)
    return (df.select(cols).values < threshold).any(dim=1)


# --------------------------------------------------------------------------- #
# Activity detectors
# --------------------------------------------------------------------------- #


def _smoothed_immobility(speed: torch.Tensor, tol: float, min_length: int) -> torch.Tensor:
    imm = same_counts(speed <= tol, min_length) > 0
    return filter_short_true_segments(imm, min_length)


def _interpolated(speed_dframe: DeviceTable) -> DeviceTable:
    """The speed table linearly interpolated, column by column."""
    return DeviceTable(interpolate_linear(speed_dframe.values), speed_dframe.columns)


def _ear_distance_rule(dist_dframe: DeviceTable, mouse_identity: str, ear: str, above: bool) -> torch.Tensor:
    """Ear-nose distance above (or below) 0.9x its median; True where the
    table has no such column."""
    c1 = (f"{mouse_identity}{ear}", f"{mouse_identity}Nose")
    c2 = (f"{mouse_identity}Nose", f"{mouse_identity}{ear}")
    col = c1 if c1 in dist_dframe.columns else c2 if c2 in dist_dframe.columns else None
    if col is None:
        return torch.ones(len(dist_dframe), dtype=torch.bool, device=dist_dframe.values.device)
    arr = dist_dframe[col]
    bar = 0.9 * nanmedian(arr)
    return arr > bar if above else arr < bar


def stationary_lookaround(
    speed_dframe, dist_dframe, likelihood_dframe, mouse_identity, close_range, tol_speed, tol_likelihood,
    min_length, animal_id="",
) -> torch.Tensor:
    """Standing still (Tail_base slow) while moving the nose with the head
    up (ear-nose distances above 0.9x their medians) and the rear body
    inactive."""
    if animal_id:
        animal_id += "_"
    nan_pos = torch.isnan(speed_dframe[animal_id + "Tail_base"])
    speeds = _interpolated(speed_dframe)
    immobile = _smoothed_immobility(speeds[animal_id + "Tail_base"], tol_speed * 2, min_length)
    nose_activity = (speeds[animal_id + "Nose"] > tol_speed) & (likelihood_dframe[animal_id + "Nose"] > tol_likelihood)
    body_inactivity = torch.ones(len(speeds), dtype=torch.bool, device=speeds.values.device)
    bparts = [animal_id + "Left_bhip", animal_id + "Right_bhip"]
    if all(bp in speeds.columns for bp in bparts):
        for bp in bparts:
            body_inactivity = body_inactivity & (speeds[bp] <= tol_speed * 2) & (likelihood_dframe[bp] > tol_likelihood)
    head_up = (_ear_distance_rule(dist_dframe, mouse_identity, "Left_ear", True)
               & _ear_distance_rule(dist_dframe, mouse_identity, "Right_ear", True))
    core = nose_activity & body_inactivity & head_up & ~close_range.to(torch.bool)
    out = multi_step_paired_smoothing(immobile & core, immobile & ~core, immobile, min_length)
    return out & ~nan_pos


def rotate(origin, point, ang):
    """Rotate (x, y) around a pivot. Returns (qx, qy)."""
    ox, oy = origin
    px, py = point
    c, s = math.cos(float(ang)), math.sin(float(ang))
    return ox + c * (px - ox) - s * (py - oy), oy + s * (px - ox) + c * (py - oy)


def outside_ellipse(x, y, e_center, e_axes, e_angle, threshold=0.0):
    """True where (x, y) lies outside the (threshold-inflated) ellipse."""
    x, y = rotate(e_center, (x, y), math.radians(e_angle))
    term_x = (x - e_center[0]) ** 2 / max(e_axes[0] + threshold, 1e-12) ** 2
    term_y = (y - e_center[1]) ** 2 / max(e_axes[1] + threshold, 1e-12) ** 2
    return term_x + term_y > 1


def digging(
    speed_dframe, dist_dframe, likelihood_dframe, mouse_identity, close_range, tol_speed, tol_likelihood,
    min_length, center_name="Center", animal_id="",
) -> torch.Tensor:
    """Stationary nose activity about ``center_name`` with the head down
    (ear-nose distances below 0.9x their medians): the reference's
    experimental digging detector, which no catalogue entry calls."""
    if animal_id:
        animal_id += "_"
    nan_pos = torch.isnan(speed_dframe[animal_id + center_name])
    speeds = _interpolated(speed_dframe)
    immobile = _smoothed_immobility(speeds[animal_id + center_name], tol_speed * 2, min_length)
    nose_activity = (speeds[animal_id + "Nose"] > tol_speed) & (likelihood_dframe[animal_id + "Nose"] > tol_likelihood)
    head_down = (_ear_distance_rule(dist_dframe, mouse_identity, "Left_ear", False)
                 & _ear_distance_rule(dist_dframe, mouse_identity, "Right_ear", False))
    core = nose_activity & head_down & ~close_range.to(torch.bool)
    out = multi_step_paired_smoothing(immobile & core, immobile & ~core, immobile, min_length)
    return out & ~nan_pos


def detect_activity(
    speed_dframe, likelihood_dframe, tol_speed, tol_likelihood, min_length, center_name="Center", animal_id="",
):
    """(stationary_active, stationary_passive, moving) triple."""
    if animal_id:
        animal_id += "_"
    nan_pos = torch.isnan(speed_dframe[animal_id + center_name])
    speeds = _interpolated(speed_dframe)
    immobile = _smoothed_immobility(speeds[animal_id + center_name], tol_speed, min_length)
    activity = torch.zeros(len(speeds), dtype=torch.bool, device=speeds.values.device)
    for bp in ("Nose", "Left_fhip", "Right_fhip", "Left_bhip", "Right_bhip"):
        if animal_id + bp in speeds.columns:
            activity = activity | ((speeds[animal_id + bp] > tol_speed)
                                   & (likelihood_dframe[animal_id + bp] > tol_likelihood))
    stat_active, stat_passive = multi_step_paired_smoothing(
        immobile & activity, immobile & ~activity, immobile, min_length, get_both=True
    )
    moving = ~(stat_active | stat_passive)
    return stat_active & ~nan_pos, stat_passive & ~nan_pos, moving & ~nan_pos


def sniff_around(speed_dframe, likelihood_dframe, tol_speed, tol_likelihood, center_name="Center", animal_id=""):
    """Slow body + fast, confidently-tracked nose."""
    if animal_id:
        animal_id += "_"
    slow = speed_dframe[animal_id + center_name] < tol_speed
    nose_fast = speed_dframe[animal_id + "Nose"] > tol_speed
    nose_sure = likelihood_dframe[animal_id + "Nose"] > tol_likelihood
    return slow & nose_fast & nose_sure


def rearing(pos_dframe, speed_dframe, likelihood_dframe=None, rearing_tol=None, tol_likelihood=None, tol_speed=None,
            animal_id=""):
    """Nose close to tail base (top view) while the tail base is slow; the
    likelihood arguments are accepted and unused, as upstream."""
    if animal_id:
        animal_id += "_"
    close = _norm(pos_dframe[animal_id + "Nose"], pos_dframe[animal_id + "Tail_base"]) < rearing_tol
    return close & (speed_dframe[animal_id + "Tail_base"] < tol_speed)


# --------------------------------------------------------------------------- #
# Immobility
# --------------------------------------------------------------------------- #

IMMOBILITY_FEATURES_DISTS = [
    ("Right_bhip", "Spine_2"), ("Spine_2", "Tail_base"), ("Left_bhip", "Spine_2"),
    ("Center", "Spine_2"), ("Left_ear", "Nose"), ("Nose", "Right_ear"),
    ("Center", "Right_fhip"), ("Center", "Left_fhip"), ("Center", "Spine_1"),
    ("Right_ear", "Spine_1"), ("Left_ear", "Spine_1"),
]
IMMOBILITY_FEATURES_AREAS = ["head_area", "torso_area", "back_area", "full_area"]
IMMOBILITY_FEATURES_SPEEDS = [
    "Center", "Left_bhip", "Left_ear", "Left_fhip", "Nose", "Right_bhip",
    "Right_ear", "Right_fhip", "Spine_1", "Spine_2", "Tail_base",
]


def augment_with_neighbors(X_huddle: DeviceTable, window: int = 5, step: int = 1, window_out: int = 11) -> DeviceTable:
    """float64 lead/lag window means of the speed features: for each speed
    column and each of ``window_out`` sub-windows of the shifts
    -window*step..window*step, the NaN-propagating mean, named
    ``{column}_{k - window_out // 2}``, column by column."""
    cols = [c for c in X_huddle.columns if "speed" in f"{c}_0"]
    b = (2 * window + 1) / window_out
    ranges = [(round(i * b), round((i + 1) * b)) for i in range(window_out)]
    x = X_huddle.select(cols).values.to(torch.float64)
    t, f = x.shape
    offsets = list(range(-window * step, window * step + 1, step))
    block = x.new_full((t, len(offsets), f), torch.nan)
    for j, off in enumerate(offsets):
        if off < 0:
            block[: t + off, j] = x[-off:]
        elif off > 0:
            block[off:, j] = x[: t - off]
        else:
            block[:, j] = x
    segs = [block[:, s:e].mean(dim=1) if e > s else x.new_full((t, f), torch.nan) for s, e in ranges]
    names = [f"{col}_{k - window_out // 2}" for col in cols for k in range(window_out)]
    return DeviceTable(torch.stack(segs, dim=2).reshape(t, f * window_out), names)


def standard_scale(x: torch.Tensor) -> torch.Tensor:
    """sklearn's ``StandardScaler().fit_transform``: ddof 0, with its
    mean and variance formula, and scale 1 for a constant column."""
    n = x.shape[0]
    mean = x.sum(dim=0) / n
    d = x - mean
    var = ((d * d).sum(dim=0) - d.sum(dim=0) ** 2 / n) / n
    eps = float(np.finfo(np.float64).eps)
    constant = var <= n * eps * var + (n * mean * eps) ** 2
    scale = torch.where(constant, 1.0, torch.sqrt(var))
    return (x - mean) / scale


class RuleBasedImmobilityEstimator:
    """Fallback immobility classifier: windowed mean z-scored speed below a
    fixed margin (the asset-free fallback)."""

    def __init__(self, speed_threshold: float = 20.0):
        self.speed_threshold = speed_threshold

    def predict(self, X_huddle: torch.Tensor) -> torch.Tensor:
        return (torch.nanmean(X_huddle, dim=1) < -0.3).to(torch.float64)


class PretrainedImmobilityClassifier:
    """The packaged immobility classifier (the default estimator): a
    121 -> 32 -> 1 MLP over the windowed z-scored speed features, in
    float32, after each feature column is shifted by its 1st percentile
    (deepof_tpu/annotate.py:585; weights copied from the JAX package's
    asset)."""

    _ASSET = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets", "immobility_classifier.npz")

    def __init__(self, weights_path: str = None):
        self._path = weights_path or self._ASSET
        self._weights = None
        self._on = {}

    def _load(self, device) -> dict:
        if self._weights is None:
            with np.load(self._path) as z:
                self._weights = {k: z[k] for k in ("w0", "b0", "w1", "b1")}
        key = str(device)
        if key not in self._on:
            self._on[key] = {k: torch.as_tensor(v, device=device) for k, v in self._weights.items()}
        return self._on[key]

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        w = self._load(x.device)
        x = x.to(torch.float32)
        x = x - nanpercentile(x, 1, dim=0)
        h = torch.clamp_min(x @ w["w0"] + w["b0"], 0.0)
        return (h @ w["w1"] + w["b1"]).reshape(-1)

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        return (self.logits(x) > 0).to(torch.float64)


def _default_immobility_estimator():
    """Packaged trained classifier when its asset exists, else the rule."""
    if os.path.exists(PretrainedImmobilityClassifier._ASSET):
        return PretrainedImmobilityClassifier()
    return RuleBasedImmobilityEstimator()  # pragma: no cover


def _predict(estimator, x: torch.Tensor) -> torch.Tensor:
    """The estimator's predictions on the device. The port's estimators
    take tensors; any other (an sklearn-style one) gets a host array."""
    if isinstance(estimator, (PretrainedImmobilityClassifier, RuleBasedImmobilityEstimator)):
        return estimator.predict(x)
    _host_read("immobility_estimator")
    return torch.as_tensor(np.asarray(estimator.predict(x.cpu().numpy()), np.float64), device=x.device)


def immobility(
    X_huddle: DeviceTable, huddle_estimator, animal_id: str = "", median_filter_width: int = 11,
    min_immobility: int = 25, max_immobility: int = 3000,
):
    """Classifier-based immobility with window-neighbor augmentation."""
    required = (
        [f"('{animal_id}{a}', '{animal_id}{b}')_raw" for a, b in IMMOBILITY_FEATURES_DISTS]
        + [f"{animal_id}{a}_raw" for a in IMMOBILITY_FEATURES_AREAS]
        + [f"{animal_id}{bp}_speed" for bp in IMMOBILITY_FEATURES_SPEEDS]
    )
    if not all(c in X_huddle for c in required):
        warnings.warn(
            "Skipping immobility annotation: not all required body parts are "
            "present (needs deepof_11 or deepof_14 labelling)."
        )
        nan = X_huddle.values.new_full((len(X_huddle),), torch.nan, dtype=torch.float64)
        return nan, nan
    x = augment_with_neighbors(X_huddle.select(required)).values
    mask = torch.isnan(x).sum(dim=1).to(torch.float64) / x.shape[1] > 0.1
    y = _predict(huddle_estimator, standard_scale(torch.nan_to_num(x))).to(torch.bool) & ~mask
    y = binary_moving_median(y, median_filter_width)
    y = filter_short_true_segments(y, min_immobility)
    return y, y


# --------------------------------------------------------------------------- #
# compute_* rule wrappers
# --------------------------------------------------------------------------- #


def compute_nose2nose(ctx, mice_pair):
    a, b = mice_pair
    return close_single_contact(ctx.raw_coords, ctx.bp(a, "Nose"), ctx.bp(b, "Nose"),
                                float(ctx.params["close_contact_tol"]))


def compute_sidebyside(ctx, mice_pair):
    a, b = mice_pair
    return close_double_contact(ctx.raw_coords, ctx.bp(a, "Nose"), ctx.bp(a, "Tail_base"), ctx.bp(b, "Nose"),
                                ctx.bp(b, "Tail_base"), rel_tol=float(ctx.params["side_contact_tol"]), rev=False)


def compute_sidereside(ctx, mice_pair):
    a, b = mice_pair
    return close_double_contact(ctx.raw_coords, ctx.bp(a, "Nose"), ctx.bp(a, "Tail_base"), ctx.bp(b, "Nose"),
                                ctx.bp(b, "Tail_base"), rel_tol=float(ctx.params["side_contact_tol"]), rev=True)


def compute_nose2tail(ctx, mice_pair):
    a, b = mice_pair
    return close_single_contact(ctx.raw_coords, ctx.bp(a, "Nose"), ctx.bp(b, "Tail_base"),
                                float(ctx.params["close_contact_tol"]))


def compute_nose2body(ctx, mice_pair):
    a, b = mice_pair
    body_cols = [ctx.bp(b, bp) for bp in ctx.extra["main_body"]]
    return close_single_contact(ctx.raw_coords, ctx.bp(a, "Nose"), body_cols, float(ctx.params["close_contact_tol"]))


def compute_following(ctx, mice_pair):
    a, b = mice_pair
    return following_path(
        ctx.dists, ctx.raw_coords, ctx.speeds, follower=a, followed=b, frames=int(ctx.params["follow_frames"]),
        tol=float(ctx.params["follow_tol"]), tol_speed=float(ctx.params["stationary_threshold"]),
    )


def compute_climb_arena(ctx, animal_id):
    prefix = ctx.prefix(animal_id)
    mouse_len = ctx.extra.get("mouse_lens", {}).get(prefix, 50)
    return climb_arena(arena_type=ctx.arena_type, arena=ctx.arena_params, pos_dict=ctx.raw_coords,
                       rel_tol=float(ctx.params["climb_tol"]), id=prefix, mouse_len=mouse_len)


def compute_sniff_arena(ctx, animal_id):
    return sniff_object(
        speed_dframe=ctx.speeds, arena=ctx.arena_params, pos_dict=ctx.raw_coords,
        tol=float(ctx.params["sniff_arena_tol"]), tol_speed=float(ctx.params["stationary_threshold"]),
        nose=ctx.bp(animal_id, "Nose"), animal_id=animal_id,
    )


def compute_immobility(ctx, animal_id):
    est = ctx.extra["immobility_estimator"] or _default_immobility_estimator()
    features = ctx.full_features[animal_id] if animal_id else ctx.full_features
    y, _ = immobility(features, est, animal_id=ctx.prefix(animal_id),
                      median_filter_width=int(ctx.params["median_filter_width"]),
                      min_immobility=int(ctx.params["min_immobility"]))
    return y


def compute_stat_lookaround(ctx, animal_id):
    if len(ctx.animal_ids) > 1:
        close_range = calculate_close_range(ctx.dists, ctx.prefix(animal_id), "Nose",
                                            float(ctx.params["side_contact_tol"]))
    else:
        close_range = torch.zeros(len(ctx.dists), dtype=torch.bool, device=ctx.device)
    return stationary_lookaround(
        ctx.speeds, ctx.dists, ctx.likelihoods, ctx.prefix(animal_id), close_range,
        tol_speed=float(ctx.params["stationary_threshold"]), tol_likelihood=float(ctx.params["nose_likelihood"]),
        min_length=int(ctx.params["min_follow_frames"]), animal_id=animal_id,
    )


def compute_detect_activity(ctx, animal_id):
    stat_a, stat_p, mov = detect_activity(
        ctx.speeds, ctx.likelihoods, tol_speed=float(ctx.params["stationary_threshold"]),
        tol_likelihood=float(ctx.params["nose_likelihood"]), min_length=int(ctx.params["min_follow_frames"]),
        animal_id=animal_id,
    )
    return {"stat-active": stat_a, "stat-passive": stat_p, "moving": mov}


def compute_sniffing(ctx, animal_id):
    return sniff_around(ctx.speeds, ctx.likelihoods, tol_speed=float(ctx.params["stationary_threshold"]),
                        tol_likelihood=float(ctx.params["nose_likelihood"]), animal_id=animal_id)


def compute_rearing(ctx, animal_id):
    return rearing(ctx.raw_coords, ctx.speeds, rearing_tol=float(ctx.params.get("rearing_tol", 50)),
                   tol_speed=float(ctx.params["stationary_threshold"]), animal_id=animal_id)


def compute_continuous_measures(ctx, aid):
    """Median bodypart speed (from the second frame), the distance it
    covers a frame and its cumulative sum, in float64."""
    bparts = [
        "Center", "Spine_1", "Spine_2", "Nose", "Left_ear", "Right_ear",
        "Left_fhip", "Right_fhip", "Left_bhip", "Right_bhip", "Tail_base",
    ]
    cols = [ctx.bp(aid, bp) for bp in bparts if ctx.bp(aid, bp) in ctx.speeds.columns]
    if not cols:
        nan = torch.full((len(ctx.speeds),), torch.nan, dtype=torch.float64, device=ctx.device)
        return {"distance": nan, "cum-distance": nan, "speed": nan}
    avg_speed = nanmedian(ctx.speeds.select(cols).values.to(torch.float64), dim=1)
    avg_speed[0] = torch.nan
    avg_distance = avg_speed / float(ctx.frame_rate)
    return {
        "distance": avg_distance,
        "cum-distance": torch.cumsum(torch.nan_to_num(avg_distance), dim=0),
        "speed": avg_speed,
    }


# --------------------------------------------------------------------------- #
# Built-in behavior catalog
# --------------------------------------------------------------------------- #


def default_behaviors() -> Dict[str, DeepOF_behavior]:
    """The built-in rule catalog."""
    single, pair = Behavior_scope.INDIVIDUAL, Behavior_scope.PAIR_DIRECTIONAL
    binary = Behavior_output.BINARY
    return {
        "nose2nose": DeepOF_behavior("nose2nose", pair, binary, compute_nose2nose, requires=("raw_coords",)),
        "sidebyside": DeepOF_behavior("sidebyside", pair, binary, compute_sidebyside, requires=("raw_coords",)),
        "sidereside": DeepOF_behavior("sidereside", pair, binary, compute_sidereside, requires=("raw_coords",)),
        "nose2tail": DeepOF_behavior("nose2tail", pair, binary, compute_nose2tail, requires=("raw_coords",)),
        "nose2body": DeepOF_behavior("nose2body", pair, binary, compute_nose2body, requires=("raw_coords",)),
        "following": DeepOF_behavior("following", pair, binary, compute_following, postprocess=postprocess_following,
                                     requires=("dists", "raw_coords", "speeds")),
        "climb-arena": DeepOF_behavior("climb-arena", single, binary, compute_climb_arena, requires=("raw_coords",)),
        "sniff-arena": DeepOF_behavior("sniff-arena", single, binary, compute_sniff_arena,
                                       requires=("raw_coords", "speeds")),
        "immobility": DeepOF_behavior("immobility", single, binary, compute_immobility,
                                      postprocess=postprocess_identity),
        "stat-lookaround": DeepOF_behavior("stat-lookaround", single, binary, compute_stat_lookaround,
                                           postprocess=postprocess_identity),
        "detect_activity": DeepOF_behavior("detect_activity", single, binary, compute_detect_activity,
                                           postprocess=postprocess_identity),
        "sniffing": DeepOF_behavior("sniffing", single, binary, compute_sniffing, postprocess=postprocess_identity),
        "continuous": DeepOF_behavior("continuous", single, Behavior_output.CONTINUOUS, compute_continuous_measures,
                                      postprocess=postprocess_identity),
    }


def validate_custom_behaviors(custom_behaviors=None, custom_behavior_inputs=None):
    """Name and scope validation of user extension behaviors."""
    if not custom_behaviors:
        return None
    if not isinstance(custom_behaviors, list) or not isinstance(custom_behaviors[0], DeepOF_behavior):
        raise ValueError("custom_behaviors must be a list of DeepOF_behavior objects or None.")
    if custom_behavior_inputs is not None and not isinstance(custom_behavior_inputs, dict):
        raise ValueError("custom_behavior_inputs must be a dictionary.")
    seen = []
    for cb in custom_behaviors:
        if "_" in cb.name:
            raise ValueError('No "_" allowed in behavior names; use "-".')
        if cb.scope is not Behavior_scope.INDIVIDUAL and cb.output_type is Behavior_output.CONTINUOUS:
            raise NotImplementedError("Continuous behaviors are only supported for individuals.")
        if cb.name in SINGLE_BEHAVIORS + SYMMETRIC_BEHAVIORS + ASYMMETRIC_BEHAVIORS + CONTINUOUS_BEHAVIORS:
            raise ValueError(f"The behavior name {cb.name} is already in use.")
        if cb.name in seen:
            raise ValueError(f"Custom behavior names must be unique: {cb.name}.")
        seen.append(cb.name)


def assign_custom_behavior_colors(custom_behaviors=None):
    if custom_behaviors is None:
        return None
    pal = cycle(pair[0] for pair in CUSTOM_BEHAVIOR_COLOR_MAP.values())
    for i, cb in enumerate(custom_behaviors):
        if not (cb.color and isinstance(cb.color, str) and re.search(r"^#(?:[0-9a-fA-F]{3}){1,2}$", cb.color)):
            custom_behaviors[i] = cb.set_color(next(pal))
    return custom_behaviors


# --------------------------------------------------------------------------- #
# Tagging
# --------------------------------------------------------------------------- #


def _mouse_length(raw_coords: DeviceTable, backbone: List[str], rng):
    """80th percentile of the summed backbone segment lengths over up to
    5,000 rows drawn from those where every backbone part is tracked, or
    50 when fewer than 400 are. The draw reads the valid rows' indices."""
    pts = torch.cat([raw_coords[bp] for bp in backbone], dim=1)
    _host_read("mouse_lens_rows")
    rows = torch.nonzero(~torch.isnan(pts).any(dim=1)).squeeze(1).cpu().numpy()
    if len(rows) < 400:
        return 50
    idx = torch.as_tensor(rng.choice(rows, size=min(5000, len(rows)), replace=False), device=pts.device)
    total = torch.zeros(len(idx), dtype=torch.float64, device=pts.device)
    for a, b in zip(backbone[:-1], backbone[1:]):
        total = total + _norm(raw_coords[b][idx].to(torch.float64), raw_coords[a][idx].to(torch.float64))
    return nanpercentile(total, 80)


def supervised_tagging(
    coord_object, raw_coords: DeviceTable, coords: DeviceTable, dists: DeviceTable, angles: DeviceTable,
    speeds: DeviceTable, full_features, key: str, immobility_estimator=None, center: str = "Center",
    params: Dict = None, run_numba: bool = False, custom_behaviors: Optional[List[DeepOF_behavior]] = None,
    custom_behavior_context: Dict = None, rng=None,
) -> Tuple[torch.Tensor, list]:
    """Tag every built-in (and custom) behavior of one recording from its
    device tables. Returns the float64 (T, C) tag table on the device, NaN
    read as 0, and its column labels."""
    animal_ids = coord_object._animal_ids
    undercond = "_" if len(animal_ids) > 1 else ""
    dev = raw_coords.values.device
    likelihoods = DeviceTable(torch.as_tensor(np.asarray(coord_object._quality[key], np.float64), device=dev),
                              coord_object._nodes)
    ctx = BehaviorContext(
        key=key, animal_ids=animal_ids, frame_rate=coord_object._frame_rate, arena_type=coord_object._arena,
        arena_params=coord_object._arena_params[key], roi_dict=(coord_object._roi_dicts or {}).get(key, {}),
        raw_coords=raw_coords, coords=coords, dists=dists, angles=angles, speeds=speeds, likelihoods=likelihoods,
        full_features=full_features, params=params or {}, run_numba=run_numba,
    )
    behaviors = default_behaviors()
    rng = np.random if rng is None else rng

    # Mouse lengths and areas for relative tolerances.
    main_body = [
        bp for bp in ("Left_ear", "Right_ear", "Spine_1", "Center", "Spine_2", "Left_fhip", "Right_fhip",
                      "Left_bhip", "Right_bhip")
        if any(bp in col[0] for col in coords.columns)
    ]
    mouse_lens, mouse_areas = {}, {}
    for aid in animal_ids:
        prefix = f"{aid}_" if aid else ""
        backbone = [prefix + bp for bp in ("Nose", "Spine_1", "Center", "Spine_2", "Tail_base")
                    if prefix + bp in raw_coords.bodyparts]
        mouse_lens[prefix] = _mouse_length(raw_coords, backbone, rng) if len(backbone) > 1 else 50
        area_key = prefix + "full_area"
        if area_key in coord_object._area_names:
            col = coord_object._area_names.index(area_key)
            mouse_areas[prefix] = nanpercentile(coord_object._derived.parts(key)[2][:, col], 80)
    ctx.extra["main_body"] = main_body
    ctx.extra["immobility_estimator"] = immobility_estimator
    ctx.extra["mouse_lens"] = mouse_lens
    ctx.extra["mouse_areas"] = mouse_areas
    ctx.extra.update(custom_behavior_context or {})

    tag_dict: Dict[str, torch.Tensor] = {}
    if len(animal_ids) >= 2:
        for a, b in combinations(animal_ids, 2):
            for cb in custom_behaviors or []:
                if cb.scope is Behavior_scope.PAIR_NONDIRECTIONAL:
                    tag_dict[f"{a}_{b}_{cb.name}"] = cb.annotate_behavior(ctx, (a, b))
                elif cb.scope is Behavior_scope.PAIR_DIRECTIONAL:
                    tag_dict[f"{a}_{b}_{cb.name}"] = cb.annotate_behavior(ctx, (a, b))
                    tag_dict[f"{b}_{a}_{cb.name}"] = cb.annotate_behavior(ctx, (b, a))
            for name, both_ways in (("nose2nose", False), ("sidebyside", False), ("sidereside", False),
                                    ("nose2tail", True), ("nose2body", True), ("following", True)):
                tag_dict[f"{a}_{b}_{name}"] = behaviors[name].annotate_behavior(ctx, (a, b))
                if both_ways:
                    tag_dict[f"{b}_{a}_{name}"] = behaviors[name].annotate_behavior(ctx, (b, a))

    for aid in animal_ids:
        for cb in custom_behaviors or []:
            if cb.scope is Behavior_scope.INDIVIDUAL:
                tag_dict[aid + undercond + cb.name] = cb.annotate_behavior(ctx, aid)
        for name in ("climb-arena", "sniff-arena", "immobility", "stat-lookaround"):
            tag_dict[aid + undercond + name] = behaviors[name].annotate_behavior(ctx, aid)
        activity = behaviors["detect_activity"].annotate_behavior(ctx, aid)
        for name in ("stat-active", "stat-passive", "moving"):
            tag_dict[aid + undercond + name] = activity[name]
        tag_dict[aid + undercond + "sniffing"] = behaviors["sniffing"].annotate_behavior(ctx, aid)
        cont = behaviors["continuous"].annotate_behavior(ctx, aid)
        for name in ("distance", "cum-distance", "speed"):
            tag_dict[aid + undercond + name] = cont[name]

    values = torch.stack([v.to(torch.float64) for v in tag_dict.values()], dim=1)
    return torch.where(torch.isnan(values), 0.0, values), list(tag_dict)


def supervised_annotation(
    coordinates, params: Dict = None, center: str = "Center", immobility_estimator=None,
    custom_behaviors: Optional[List[DeepOF_behavior]] = None, custom_behavior_context: Dict = None,
    verbose: bool = True, rng=None,
) -> TableDict:
    """Tag the built-in (and custom) behaviors of every recording, add each
    animal's ``missing`` flag, and return a "supervised" TableDict of float64
    (T, C) LazyFrames with the JAX package's column labels.

    ``rng`` draws the rows that measure each animal's length (``choice``
    without replacement, as ``np.random.choice``); by default numpy's
    global RandomState, as in the JAX package.
    """
    validate_custom_behaviors(custom_behaviors, custom_behavior_context)
    if custom_behaviors:
        coordinates._custom_behaviors = assign_custom_behavior_colors(list(custom_behaviors))
    tag_params = coordinates.get_supervised_parameters()
    if params:
        tag_params.update(params)

    animal_ids = coordinates._animal_ids
    # Only the immobility rule reads full_features, and only 11 distance
    # pairs an animal: restrict the distances to them unless custom
    # behaviors (which see full_features) are given.
    distance_pairs = None
    if not custom_behaviors:
        distance_pairs = [(f"{aid}_{a}" if aid else a, f"{aid}_{b}" if aid else b)
                          for aid in (animal_ids or [""]) for a, b in IMMOBILITY_FEATURES_DISTS]
    views = list(animal_ids) if len(animal_ids) > 1 else [None]
    undercond = "_" if len(animal_ids) > 1 else ""

    tabs = {}
    keys = list(coordinates._tables)
    for i, key in enumerate(keys):
        if verbose:
            print(f"Tagging behaviors: {key} ({i + 1}/{len(keys)})")
        features = _kinematics_table_views(coordinates, views, key, distance_pairs=distance_pairs)
        values, columns = supervised_tagging(
            coordinates,
            raw_coords=DeviceTable(*coordinates.get_coords_at_key(key, _device=True)),
            coords=DeviceTable(*coordinates.get_coords_at_key(key, center=center, align="Spine_1", _device=True)),
            dists=DeviceTable(*coordinates.get_distances_at_key(key, _device=True)),
            angles=DeviceTable(*coordinates.get_angles_at_key(key, _device=True)),
            speeds=DeviceTable(*coordinates.get_coords_at_key(key, speed=1, _device=True)),
            full_features=features if len(animal_ids) > 1 else features[None],
            key=key, immobility_estimator=immobility_estimator, center=center, params=tag_params,
            custom_behaviors=custom_behaviors, custom_behavior_context=custom_behavior_context or {}, rng=rng,
        )
        # Each animal's missing flag, over the frames presence covers.
        presence = np.asarray(coordinates._presence[key])
        n = min(len(values), len(presence))
        missing = np.zeros((len(values), len(animal_ids)))
        missing[:n] = presence[:n] == 0
        values = torch.cat([values, torch.as_tensor(missing, device=values.device)], dim=1)
        columns += [aid + undercond + "missing" for aid in animal_ids]
        _host_read("tag_table")
        table = values.cpu().numpy()
        tabs[key] = LazyFrame(lambda table=table: table, columns, len(table))

    return TableDict(tabs, typ="supervised", table_path=coordinates._table_path, animal_ids=animal_ids,
                     arena=coordinates._arena, exp_conditions=coordinates._exp_conditions)


supervised_annotation.host_reads = Counter()


def max_behaviour(behaviour_dframe: LazyFrame, window_size: int = 10, stepped: bool = False) -> np.ndarray:
    """Most frequent behavior per sliding window of a supervised table:
    centred rolling sums over the columns without "speed" in their name,
    the argmax label per window (first on ties; -inf where the window
    overhangs the table), from the second window on."""
    keep = [i for i, c in enumerate(behaviour_dframe.columns) if "speed" not in str(c).lower()]
    names = np.asarray([behaviour_dframe.columns[i] for i in keep], dtype=object)
    tab = np.asarray(behaviour_dframe.realize(), np.float64)[:, keep]
    t = len(tab)
    before, after = window_size // 2, (window_size - 1) // 2
    win = np.full(tab.shape, -np.inf)
    if t >= window_size:
        win[before:t - after] = sum(tab[j:t - window_size + 1 + j] for j in range(window_size))
    win = np.where(np.isnan(win), -np.inf, win)
    if stepped:
        win = win[::window_size]
    return names[np.argmax(win[1:], axis=1)]
