"""TableDict: the dataset container that travels between layers (port of
``deepof_tpu/core/table_dict.py``: ``TableDict`` with its split and its
device scaling pass, and the full-range case of
``deepof_tpu/visuals_utils.py`` ``preprocess_time_bins``).

``preprocess`` runs the device branch of the JAX package, over merged frames
that already live on the device (the fused lane of ``get_graph_dataset``):
per recording one size-normalisation + local-standardisation pass, a
cohort-wide standard-scaler fit combined in float64 on the host (or a
pretrained scaler), and one finishing pass; the scaled frames stay on the
device (the section scalers it returns are ``ops.scaling._StandardScalerLite``).
Where the JAX package drops to its host pandas passes (binning,
recordings of unequal length, more rows than ``samples_max``, groupwise
modes, other scalers, the residency budgets), the port raises.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np
import torch

from deepof_tpu_torch.core.storage import PATHS_MODE, LazyFrame, get_dt
from deepof_tpu_torch.ops.scaling import (
    _global_scaler_vectors,
    column_totals,
    finish,
    fit_global_scaler,
    scale_plan,
    stage12,
)

HOST_SCALING = "ROADMAP queue 1 item 4 (the host scaling passes of TableDict.preprocess)"

# Device residency budgets of the scaling pass (table_dict.py:557,747): the
# inputs and scaled frames held at once, and the scaled frames kept.
DEVICE_SCALE_BUDGET_BYTES = 8_000_000_000
DEVICE_FRAMES_BYTES = 4_000_000_000


class TableDict(dict):
    """Dict of per-experiment tables with dataset-level metadata."""

    def __init__(
        self,
        tabs: Dict,
        typ: str,
        table_path: str = None,
        arena: str = None,
        arena_dims=None,
        animal_ids: List = tuple([""]),
        center: str = None,
        connectivity=None,
        polar: bool = None,
        exp_conditions: dict = None,
    ):
        super().__init__(tabs)
        self._type = typ
        self._center = center
        self._connectivity = connectivity
        self._polar = polar
        self._arena = arena
        self._arena_dims = arena_dims
        self._animal_ids = animal_ids
        self._exp_conditions = exp_conditions
        self._table_path = table_path

    def new_dict_same_header(self, tabs: dict = None) -> "TableDict":
        """New TableDict with this one's metadata."""
        return TableDict(
            tabs or {}, typ=self._type, table_path=self._table_path, arena=self._arena,
            arena_dims=self._arena_dims, animal_ids=self._animal_ids, center=self._center,
            connectivity=self._connectivity, polar=self._polar,
            exp_conditions=self._exp_conditions,
        )

    def filter_videos(self, keys: list) -> "TableDict":
        """Subset to the given experiment keys."""
        if not all(k in self.keys() for k in keys):
            raise KeyError("Invalid keys selected")
        return self.new_dict_same_header({k: v for k, v in self.items() if k in keys})

    def get_training_set(
        self, current_table_dict: "TableDict", test_videos: Union[int, list] = 0
    ) -> tuple:
        """Video-level train/test split, drawn as the JAX package draws it
        (``np.random.seed(42)`` then ``choice``), from its own generator."""
        keys = np.array(list(current_table_dict.keys()))
        if isinstance(test_videos, int):
            test_keys = keys[np.random.RandomState(42).choice(
                range(len(current_table_dict)), test_videos, replace=False
            )]
        elif isinstance(test_videos, list) and all(k in keys for k in test_videos):
            test_keys = test_videos
        else:
            raise ValueError("test_videos must be an int or a list of valid experiment keys.")
        train_keys = list(set(keys) - set(test_keys))

        x_test = TableDict({}, current_table_dict._type, current_table_dict._table_path)
        if len(test_keys) > 0:
            x_test = current_table_dict.filter_videos(test_keys)
            x_train = current_table_dict.filter_videos(train_keys)
        else:
            x_train = current_table_dict.filter_videos(list(keys))
        return x_train, x_test, test_keys

    def preprocess(
        self,
        coordinates,
        window_size: int = None,
        window_step: int = 1,
        bin_size=None,
        bin_index=None,
        precomputed_bins=None,
        samples_max: int = 227272,
        scale: str = "standard",
        pretrained_scaler=None,
        test_videos: int = 0,
        interpolate_normalized: int = 10,
        filter_low_variance: bool = False,
        save_as_paths: Optional[bool] = None,
        shuffle: bool = False,
        dist_standardize: str = "groupwise",
        speed_standardize: str = "groupwise",
        coord_standardize: str = "groupwise",
        log_distances: bool = True,
        return_windows: bool = True,
    ) -> tuple:
        """Scale (two-stage local + global) the merged frames on the device.

        Returns ((X_train, X_test) TableDicts of scaled (T, F) frames,
        metainfo dict, global_scaler dict) as the JAX package does with
        ``return_windows=False``.
        """
        if save_as_paths is None:
            save_as_paths = bool(getattr(coordinates, "_very_large_project", False))
        if save_as_paths:
            raise NotImplementedError(PATHS_MODE)
        if return_windows:
            raise NotImplementedError(
                "TableDict.preprocess builds no host window stacks yet "
                "(return_windows=True, training): ROADMAP queue 1 item 9"
            )
        if not _device_scale_applicable(
            scale, filter_low_variance, dist_standardize, speed_standardize, coord_standardize,
        ):
            raise NotImplementedError(
                f"scale={scale!r}, filter_low_variance={filter_low_variance!r} and "
                f"standardize modes ({dist_standardize!r}, {speed_standardize!r}, "
                f"{coord_standardize!r}): the port scales with the standard scaler "
                f"and per-column (or None) modes only; the rest is {HOST_SCALING}"
            )
        bin_info = preprocess_time_bins(
            coordinates, bin_size=bin_size, bin_index=bin_index,
            precomputed_bins=precomputed_bins, tab_dict_for_binning=self,
            samples_max=samples_max,
        )
        table_temp, global_scaler = self._preprocess_scale_device(
            sorted(self.keys()), bin_info, coordinates._animal_ids, pretrained_scaler,
            interpolate_normalized, log_distances,
            dist_standardize, speed_standardize, coord_standardize,
        )

        x_train, x_test, _ = self.get_training_set(table_temp, test_videos)
        for part in (x_train, x_test):
            part._device_frames = {k: table_temp._device_frames[k] for k in part.keys()}
            part._deferred_f32 = {k: table_temp._deferred_f32[k] for k in part.keys()}
        metainfo = {
            "shape_train": tuple(
                tuple(get_dt(x_train, k, only_metainfo=True)["shape"]) for k in x_train.keys()
            ),
            "shape_test": (0,),
            "dist_standardize": dist_standardize,
            "speed_standardize": speed_standardize,
            "coord_standardize": coord_standardize,
        }
        return (x_train, x_test), metainfo, global_scaler

    def _preprocess_scale_device(
        self, keys_list, bin_info, animal_ids, pretrained_scaler,
        interpolate_normalized, log_distances,
        dist_standardize, speed_standardize, coord_standardize,
    ):
        """The scaling passes on the device (table_dict.py:529-822). Every
        table must be a merged frame of the fused lane: a LazyFrame whose
        values are in ``self._device_frames``. Returns (table_temp,
        global_scaler); all-NaN tables are dropped."""
        plan = None
        pend = {}
        live_bytes = 0
        dev_in = getattr(self, "_device_frames", None) or {}
        for key in keys_list:
            dev, entry = dev_in.get(key), self[key]
            if dev is None or not isinstance(entry, LazyFrame):
                raise NotImplementedError(
                    f"table {key!r} is not a merged frame on the device; host tables "
                    f"take {HOST_SCALING}"
                )
            n_rows = int(dev.shape[0])
            if n_rows == 0 or not _rows_are_full_range(bin_info[key], n_rows):
                raise NotImplementedError(
                    f"table {key!r}: its {n_rows} rows are not the full range of the "
                    f"time bins ({len(bin_info[key])} rows: recordings of unequal length "
                    f"are trimmed to the shortest, more than samples_max rows are "
                    f"subsampled); that takes {HOST_SCALING}"
                )
            columns = list(entry.columns)
            if len(set(columns)) != len(columns):
                raise NotImplementedError(f"table {key!r} repeats columns; that takes {HOST_SCALING}")
            if plan is None:
                plan = scale_plan(
                    columns, list(animal_ids), log_distances,
                    dist_standardize, speed_standardize, coord_standardize,
                    interpolate_normalized,
                )
            elif columns != plan["columns"]:
                raise NotImplementedError(
                    f"table {key!r} has other columns than the first; that takes {HOST_SCALING}"
                )
            live_bytes += 2 * dev.numel() * 4
            if live_bytes > DEVICE_SCALE_BUDGET_BYTES:
                raise NotImplementedError(
                    f"the scaling pass would hold {live_bytes} bytes on the device, over its "
                    f"{DEVICE_SCALE_BUDGET_BYTES} budget; that takes {HOST_SCALING}"
                )
            xs, cnt, sm = stage12(dev.to(torch.float32), plan)
            pend[key] = (xs, *column_totals(cnt, sm))

        # All-NaN tables (every column's valid count zero) are dropped.
        pend = {k: v for k, v in pend.items() if v[1].sum() > 0}
        if not pend:
            raise ValueError("every table is all-NaN: nothing to scale")
        global_scaler = (
            pretrained_scaler if pretrained_scaler is not None
            else fit_global_scaler(list(pend.values()), plan)
        )
        vectors = _global_scaler_vectors(global_scaler, plan)
        if vectors is None:
            raise NotImplementedError(
                f"the global scaler holds groupwise sections or another kind of scaler; "
                f"that takes {HOST_SCALING}"
            )

        table_temp = self.new_dict_same_header({})
        dev_frames, deferred = {}, {}
        frames_bytes = 0
        for key in keys_list:
            if key not in pend:
                continue
            out = finish(pend.pop(key)[0], vectors, plan)
            frames_bytes += out.numel() * out.element_size()
            if frames_bytes > DEVICE_FRAMES_BYTES:
                raise NotImplementedError(
                    f"the scaled frames would hold {frames_bytes} bytes on the device, over "
                    f"their {DEVICE_FRAMES_BYTES} budget; that takes {HOST_SCALING}"
                )
            holder = _DeferredScaledFrame(out)
            dev_frames[key] = out
            deferred[key] = holder
            table_temp[key] = LazyFrame(holder.f32, plan["columns"], int(out.shape[0]))
        table_temp._device_frames = dev_frames
        table_temp._deferred_f32 = deferred
        return table_temp, global_scaler


class _DeferredScaledFrame:
    """A scaled (T, F) float32 frame on the device, fetched to the host once,
    on first host access; shared by every lazy host view of it."""

    __slots__ = ("dev", "_host")

    def __init__(self, dev: torch.Tensor):
        self.dev = dev
        self._host = None

    def f32(self) -> np.ndarray:
        if self._host is None:
            self._host = self.dev.cpu().numpy()
        return self._host


def _device_scale_applicable(
    scale, filter_low_variance, dist_standardize, speed_standardize, coord_standardize,
) -> bool:
    """Whether the device scaling formulation covers the call: the standard
    scaler, per-column (or disabled) standardize modes and no low-variance
    filter. (The JAX package also asks for an accelerator backend; the
    port's device branch is its only branch, on the card and on the CPU.)"""
    if scale != "standard" or filter_low_variance:
        return False
    return all(
        m in (None, "per_column")
        for m in (dist_standardize, speed_standardize, coord_standardize)
    )


def _rows_are_full_range(rows, n: int) -> bool:
    rows = np.asarray(rows)
    if rows.dtype == bool:
        return rows.size == n and bool(rows.all())
    return rows.ndim == 1 and rows.size == n and n > 0 and np.array_equal(rows, np.arange(n))


def preprocess_time_bins(
    coordinates,
    bin_size=None,
    bin_index=None,
    precomputed_bins=None,
    tab_dict_for_binning=None,
    samples_max: Optional[int] = 20000,
    down_sample: bool = True,
) -> Dict[str, np.ndarray]:
    """Per-experiment frame indices of the full range (no bins): every
    recording's rows, trimmed to the shortest recording, then subsampled
    evenly to ``samples_max`` (visuals_utils.py:182-199,216-228). Binning
    raises."""
    if bin_size is not None or bin_index is not None or precomputed_bins is not None:
        raise NotImplementedError(f"time bins are not ported yet: {HOST_SCALING}")
    lengths = coordinates.get_table_lengths(tab_dict_for_binning)
    bin_info = {key: np.arange(n) for key, n in lengths.items()}
    if bin_info:
        min_len = min(len(v) for v in bin_info.values())
        bin_info = {k: v[:min_len] for k, v in bin_info.items()}
    if samples_max is not None:
        for key, idx in bin_info.items():
            if len(idx) > samples_max:
                sel = (np.linspace(0, len(idx) - 1, samples_max, dtype=int) if down_sample
                       else np.arange(samples_max))
                bin_info[key] = idx[sel]
    return bin_info
