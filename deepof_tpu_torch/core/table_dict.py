"""TableDict: the dataset container that travels between layers (port of
``deepof_tpu/core/table_dict.py``: ``TableDict`` with its filters, merge,
split, preprocess and window sampling, and of
``deepof_tpu/visuals_utils.py`` ``preprocess_time_bins`` and
``apply_rois_to_bin_info``).

A table is a :class:`LazyFrame` (a (T, F) frame and its column labels); a
TableDict may hold its frames on the device in ``_device_frames`` (the
getters' device route, ``merge`` of such tables, the fused lane of
``get_graph_dataset``), and ``preprocess`` then scales them where they lie.

``preprocess`` takes the JAX package's two routes, chosen as it chooses
them:

* the float32 device formulation (``_preprocess_scale_device``): the
  standard scaler with per-column (or disabled) modes, where every
  fused-lane frame keeps its full row range, or every other table's taken
  rows number at most ``samples_max``. Per recording one size-normalisation
  + local-standardisation pass, a cohort-wide standard fit combined in
  float64 on the host (or a pretrained scaler), one finishing pass;
* the general route (``_preprocess_scale_general``, the JAX package's host
  passes), in float64 on the tables' device: every scaler, groupwise modes,
  ``filter_low_variance``, trimmed or subsampled fused-lane frames.

Either way each scaled frame ends as float32 on the device, in
``_device_frames`` / ``_deferred_f32``, for the window kernel and the
encoder, while the frames kept there fit ``DEVICE_FRAMES_BYTES``; past it
a frame stays on the host (``_host_f32``) and serving uploads it. Past
``DEVICE_SCALE_BUDGET_BYTES`` the device formulation gives way to the
general route. The global fit uses every taken row: the JAX package draws a
``RandomState(2)`` permutation of them, which leaves the fit unchanged but
for summation order (ROADMAP queue 3).

``random_projection`` and ``pca`` restate the JAX package's sklearn
estimators on the tables' device and return a :class:`Projection`.
"""

from __future__ import annotations

import os
import re
import warnings
from functools import reduce
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from deepof_tpu_torch.core.storage import POINTER_KEY, LazyFrame, get_dt, is_pointer, save_dt
from deepof_tpu_torch.device import fetch_together, resolve_device
from deepof_tpu_torch.ops.geometry import point_in_polygon
from deepof_tpu_torch.ops.scaling import (
    SCALERS,
    _global_scaler_vectors,
    apply_global_sections,
    clip_interp,
    column_totals,
    finish,
    finish_general,
    fit_global_scaler,
    fit_standard_lite,
    infer_column_types,
    make_scaler,
    sanitize,
    scale_plan,
    scale_table,
    stage12,
)
from deepof_tpu_torch.ops.windows import aggregate_windows, aggregate_windows_labels, rolling_windows_host
from deepof_tpu_torch.utils import filter_columns

# Device residency budgets of the scaling passes, the JAX package's numbers
# (table_dict.py:557,747): the device route's inputs and scaled frames held
# at once (past it the general route runs, recording by recording, and
# keeps no pass-1 scaling for pass 3), and the scaled frames kept on the
# device (past it a frame is kept on the host, and serving uploads it).
DEVICE_SCALE_BUDGET_BYTES = 8_000_000_000
DEVICE_FRAMES_BYTES = 4_000_000_000

KERNELS = ("linear", "rbf", "poly", "sigmoid", "cosine")


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

    def _keep_frames(self, out: "TableDict") -> "TableDict":
        """``out`` with this dict's device frames (and fused-lane mark) of
        its keys."""
        for name in ("_device_frames", "_deferred_f32", "_host_f32"):
            frames = getattr(self, name, None)
            if frames is not None:
                setattr(out, name, {k: v for k, v in frames.items() if k in out})
        if getattr(self, "_fused_lane", False):
            out._fused_lane = True
        return out

    # ------------------------------------------------------------------ #
    # Filters, projections, merge, split
    # ------------------------------------------------------------------ #

    def filter_videos(self, keys: list) -> "TableDict":
        """Subset to the given experiment keys."""
        if not all(k in self.keys() for k in keys):
            raise KeyError("Invalid keys selected")
        return self._keep_frames(self.new_dict_same_header({k: v for k, v in self.items() if k in keys}))

    def filter_condition(self, exp_filters: dict) -> "TableDict":
        """Subset to the videos whose in-memory experimental conditions
        match every ``{condition: value}`` given."""
        table = self
        for cond, value in exp_filters.items():
            conds = table._exp_conditions
            filtered = {
                k: v for k, v in table.items()
                if conds is not None and k in conds and np.all(np.asarray(conds[k][cond]) == value)
            }
            new = table._keep_frames(table.new_dict_same_header(filtered))
            new._exp_conditions = {k: v for k, v in (conds or {}).items() if k in filtered}
            table = new
        return table

    def filter_id(self, selected_id: str = None) -> "TableDict":
        """Keep only one animal's columns in every table (on the device
        where the table is)."""
        out = self.new_dict_same_header({})
        frames = {}
        dev_in = getattr(self, "_device_frames", None) or {}
        for key in self.keys():
            columns = _columns_of(self[key], key)
            keep = set(filter_columns(columns, selected_id, self._type))
            idx = [i for i, c in enumerate(columns) if c in keep]
            cols = [columns[i] for i in idx]
            if key in dev_in:
                frames[key] = dev_in[key][:, idx]
                out[key] = _device_lazy(frames[key], cols)
            else:
                arr = np.asarray(get_dt(self, key))[:, idx]
                out[key] = LazyFrame(lambda a=arr: a, cols, len(arr))
        out._device_frames = frames
        return out

    def _prepare_projection(self, device) -> torch.Tensor:
        """(n_tables, F) float64: each table's column means (NaN where a
        column holds one), on ``device`` (default: its device frames', else
        "cuda")."""
        frames = getattr(self, "_device_frames", None) or {}
        if device is None:
            device = next(iter(frames.values())).device if frames else "cuda"
        dev = resolve_device(device)
        means = []
        for key in self.keys():
            x = frames.get(key)
            if x is None:
                x = torch.as_tensor(np.asarray(get_dt(self, key), np.float64))
            means.append(x.to(device=dev, dtype=torch.float64).mean(dim=0))
        return torch.stack(means)

    def random_projection(self, n_components: int = 2, kernel: str = "linear", device=None):
        """Each table's column means through a Gaussian random projection
        (``deepof_tpu/core/table_dict.py:118-149``,
        ``GaussianRandomProjection(n_components)``): the (n_components, F)
        matrix drawn as sklearn draws it with ``random_state=None``, from
        numpy's global state. Returns (x (n_tables, n_components) numpy,
        the fitted :class:`Projection`)."""
        x = self._prepare_projection(device)
        proj = Projection.random(n_components, x.shape[1], x.device)
        return proj.transform_tensor(x).cpu().numpy(), proj

    def pca(self, n_components: int = 2, kernel: str = "linear", device=None):
        """Each table's column means through a kernel PCA
        (``KernelPCA(n_components, kernel=kernel)`` at sklearn's defaults,
        restated: the kernel centred, ``torch.linalg.eigh`` in float64,
        sklearn's eigenvalue checks, sign and order rules). Returns (x
        (n_tables, n_components) numpy, the fitted :class:`Projection`)."""
        x = self._prepare_projection(device)
        proj = Projection.kernel_pca(x, n_components, kernel)
        return proj.fitted.cpu().numpy(), proj

    def umap(self, n_components: int = 2):
        """UMAP needs umap-learn, which the port does not carry."""
        try:
            import umap  # noqa: F401
        except ImportError as e:
            raise ImportError("UMAP projections require the optional 'umap-learn' package.") from e
        raise NotImplementedError("UMAP projections are not ported: umap-learn runs on the host")

    def merge(self, *args, ignore_index=False, file_name="merged", save_as_paths=False) -> "TableDict":
        """Concatenate several TableDicts column-wise per experiment. Where
        every part of a key is on the device, the merged frame is made there
        (in the parts' promoted dtype) and enters ``_device_frames``;
        otherwise it is a float64 host frame. With ``save_as_paths`` each
        merged frame is written to ``{table_path}/{key}/{key}_{file_name}``
        (with the parts' promoted dtype) and the value is its pointer."""
        dicts = [self] + list(args)
        merged, frames = {}, {}
        for key in self.keys():
            columns = [c for td in dicts for c in _columns_of(td[key], key)]
            devs = [(getattr(td, "_device_frames", None) or {}).get(key) for td in dicts]
            if save_as_paths:
                arr = np.hstack([np.asarray(get_dt(td, key), np.float64) for td in dicts])
                dtype = str(np.result_type(*[_dtype_of(td, key) for td in dicts]))
                merged[key] = save_dt(LazyFrame(lambda a=arr: a, columns, len(arr), dtype),
                                      self._path_of(key, file_name), True)
            elif all(d is not None for d in devs):
                if len({int(d.shape[0]) for d in devs}) != 1:
                    raise ValueError(f"table {key!r}: the parts to merge differ in length")
                dtype = reduce(torch.promote_types, [d.dtype for d in devs])
                frames[key] = torch.cat([d.to(dtype) for d in devs], dim=1)
                merged[key] = _device_lazy(frames[key], columns)
            else:
                arr = np.hstack([np.asarray(get_dt(td, key), np.float64) for td in dicts])
                merged[key] = LazyFrame(lambda a=arr: a, columns, len(arr))
        out = TableDict(merged, typ="merged", table_path=self._table_path, connectivity=self._connectivity)
        out._animal_ids = self._animal_ids
        out._device_frames = frames
        return out

    def _path_of(self, key, file_name) -> Optional[str]:
        """Where paths mode writes ``key``'s table named ``file_name`` (None
        without a table path: the value then stays in memory)."""
        return os.path.join(self._table_path, key, f"{key}_{file_name}") if self._table_path else None

    def get_training_set(
        self, current_table_dict: "TableDict", test_videos: Union[int, list] = 0
    ) -> tuple:
        """Video-level train/test split, drawn as the JAX package draws it
        (``np.random.seed(42)`` then ``choice``)."""
        keys = np.array(list(current_table_dict.keys()))
        if isinstance(test_videos, int):
            # numpy's global state, seeded as the JAX package seeds it: a
            # shuffled extract_windows draws from it next.
            np.random.seed(42)
            test_keys = keys[np.random.choice(range(len(current_table_dict)), test_videos, replace=False)]
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

    # ------------------------------------------------------------------ #
    # Preprocess: bin -> fit scaler -> scale -> window
    # ------------------------------------------------------------------ #

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
        file_name: str = "preprocessed",
        save_as_paths: Optional[bool] = None,
        shuffle: bool = False,
        quality_to_load=None,
        dist_standardize: str = "groupwise",
        speed_standardize: str = "groupwise",
        coord_standardize: str = "groupwise",
        log_distances: bool = True,
        return_windows: bool = True,
    ) -> tuple:
        """Bin, scale (two-stage local + global) and, with
        ``return_windows``, window the dataset.

        Returns ((X_train, X_test) TableDicts, metainfo dict,
        global_scaler dict): scaled (T, F) frames without
        ``return_windows`` (float32 on the device in ``_device_frames``), or
        (W, window, F) window stacks on the host, as the JAX package does.
        """
        if window_size is None:
            window_size = int(np.round(coordinates._frame_rate))
        if scale and scale not in SCALERS:
            raise ValueError(f"Invalid scaler: {scale}")
        if save_as_paths is None:
            save_as_paths = bool(getattr(coordinates, "_very_large_project", False))
        saving = file_name if save_as_paths and self._table_path else None

        keys_list = sorted(self.keys())
        bin_info = preprocess_time_bins(
            coordinates, bin_size=bin_size, bin_index=bin_index,
            precomputed_bins=precomputed_bins, tab_dict_for_binning=self,
            samples_max=samples_max,
        )
        modes = (dist_standardize, speed_standardize, coord_standardize)
        device = resolve_device(coordinates._device)
        scaled = None
        if _device_scale_applicable(scale, filter_low_variance, *modes):
            scaled = self._preprocess_scale_device(
                keys_list, bin_info, device, coordinates._animal_ids, pretrained_scaler, samples_max,
                interpolate_normalized, log_distances, *modes, saving=saving,
            )
        if scaled is None:
            scaled = self._preprocess_scale_general(
                keys_list, bin_info, device, coordinates._animal_ids, scale, pretrained_scaler,
                interpolate_normalized, filter_low_variance, log_distances, *modes, saving=saving,
            )
        table_temp, global_scaler = scaled

        x_train, x_test, test_index = self.get_training_set(table_temp, test_videos)
        for part in (x_train, x_test):
            table_temp._keep_frames(part)
        metainfo = {"dist_standardize": dist_standardize, "speed_standardize": speed_standardize,
                    "coord_standardize": coord_standardize}
        if not return_windows:
            metainfo["shape_train"] = tuple(
                tuple(get_dt(x_train, k, only_metainfo=True)["shape"]) for k in x_train.keys()
            )
            metainfo["shape_test"] = (0,)
            return (x_train, x_test), {k: metainfo[k] for k in _META_ORDER}, global_scaler
        x_train, metainfo["shape_train"] = extract_windows(x_train, window_size, window_step, save_as_paths, shuffle)
        if test_videos and len(test_index) > 0:
            x_test, metainfo["shape_test"] = extract_windows(x_test, window_size, window_step, save_as_paths,
                                                             shuffle)
        else:
            metainfo["shape_test"] = (0,)
        return (x_train, x_test), {k: metainfo[k] for k in _META_ORDER}, global_scaler

    def _table(self, key, device):
        """(tensor, columns) of one table: its device frame, or its host
        frame uploaded to ``device`` (a pointer's frame read from its file
        and uploaded in the dtype it was made in)."""
        entry = self[key]
        columns = _columns_of(entry, key)
        dev = (getattr(self, "_device_frames", None) or {}).get(key)
        if dev is None:
            dev = torch.as_tensor(np.asarray(get_dt(self, key), np.float64), device=device)
            if is_pointer(entry):
                dev = dev.to(getattr(torch, _dtype_of(self, key)))
        return dev, columns

    def _preprocess_scale_device(
        self, keys_list, bin_info, device, animal_ids, pretrained_scaler, samples_max,
        interpolate_normalized, log_distances,
        dist_standardize, speed_standardize, coord_standardize, saving=None,
    ):
        """The float32 device formulation (table_dict.py:529-822). Returns
        (table_temp, global_scaler), or None where a table falls outside it
        (the caller then takes the general route): a fused-lane frame whose
        rows are not its full range, more than ``samples_max`` or no taken
        rows, repeated or differing columns, or a pretrained scaler it
        cannot express. All-NaN tables are dropped."""
        plan = None
        pend = {}
        live_bytes = 0
        fused = getattr(self, "_fused_lane", False)
        for key in keys_list:
            x, columns = self._table(key, device)
            rows = bin_info[key]
            if fused:
                if not _rows_are_full_range(rows, int(x.shape[0])):
                    return None
                sizes = None
            else:
                # The JAX package measures the body sizes on its float64
                # host table: the taken rows in the table's own precision.
                x = sizes = _take_rows(x, rows)
            if x.shape[0] == 0 or x.shape[0] > samples_max or len(set(columns)) != len(columns):
                return None
            if plan is None:
                plan = scale_plan(
                    columns, list(animal_ids), log_distances,
                    dist_standardize, speed_standardize, coord_standardize, interpolate_normalized,
                )
            elif columns != plan["columns"]:
                return None
            live_bytes += 2 * x.numel() * 4
            if live_bytes > DEVICE_SCALE_BUDGET_BYTES:
                return None
            xs, cnt, sm = stage12(x.to(torch.float32), plan, sizes)
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
            return None
        outs = ((key, finish(pend.pop(key)[0], vectors, plan), plan["columns"]) for key in list(pend))
        return self._scaled_dict(outs, saving=saving), global_scaler

    def _preprocess_scale_general(
        self, keys_list, bin_info, device, animal_ids, scale, pretrained_scaler,
        interpolate_normalized, filter_low_variance, log_distances,
        dist_standardize, speed_standardize, coord_standardize, saving=None,
    ):
        """The JAX package's host passes (table_dict.py:284-473), in float64
        on the tables' device, recording by recording (a host table is
        uploaded when it is read). Pass 1 scales each recording locally and
        collects the global fit's samples (every taken row); pass 2 fits the
        global section scalers; pass 3 applies them, clips and
        re-interpolates, and each finished frame goes to ``_scaled_dict``
        before the next is made. The local scaling of pass 1 is kept for
        pass 3 within ``DEVICE_SCALE_BUDGET_BYTES`` (without
        ``filter_low_variance``, whose columns pass 3 reinstates as zeros),
        and made again past it. Returns (table_temp, global_scaler); all-NaN
        tables are dropped."""
        modes = dict(dist_standardize=dist_standardize, speed_standardize=speed_standardize)
        samples = {"speed": [], "dist": [], "coord": [], "inner": [], "intra": []}
        fit = bool(scale) and pretrained_scaler is None
        cache, budget = {}, DEVICE_SCALE_BUDGET_BYTES
        valid = []
        for key in keys_list:
            x, columns = self._table(key, device)
            x = _take_rows(x, bin_info[key]).to(torch.float64)
            if bool(torch.isnan(x).all()):
                continue
            valid.append(key)
            if not fit:
                continue
            x, columns = _filter_low_variance(x, columns, filter_low_variance)
            local = scale_table(x, columns, scale, animal_ids, coord_standardize=None,
                                log_distances=log_distances, **modes)
            if not filter_low_variance and local.numel() * 8 <= budget:
                cache[key] = local
                budget -= local.numel() * 8
            ct = infer_column_types(columns)
            pos = {c: i for i, c in enumerate(columns)}

            def take(cols, mode, bucket):
                arr = local[:, [pos[c] for c in cols]]
                samples[bucket].append(arr if mode == "per_column" else arr.reshape(-1))

            if speed_standardize and ct["speeds"]:
                take(ct["speeds"], speed_standardize, "speed")
            if dist_standardize == "per_column" and ct["dists"]:
                take(ct["dists"], "per_column", "dist")
            elif dist_standardize and ct["dists"]:
                if ct["inner_dists"]:
                    take(ct["inner_dists"], "groupwise", "inner")
                if ct["intra_dists"]:
                    take(ct["intra_dists"], "groupwise", "intra")
            if coord_standardize and ct["coords"]:
                take(ct["coords"], coord_standardize, "coord")
        if not valid:
            raise ValueError("every table is all-NaN: nothing to scale")

        global_scaler = _fit_global_scaler(
            scale, pretrained_scaler, samples, dist_standardize, speed_standardize, coord_standardize,
        )
        finish_args = (global_scaler if scale else None, scale, interpolate_normalized,
                       speed_standardize, dist_standardize, coord_standardize)
        def finished():
            for key in valid:
                x, columns = self._table(key, device)
                local = cache.pop(key, None)
                if local is None:
                    x = _take_rows(x, bin_info[key]).to(torch.float64)
                    if filter_low_variance:
                        yield key, _finish_filtered(x, columns, filter_low_variance, animal_ids,
                                                    log_distances, finish_args), columns
                        continue
                    local = scale_table(x, columns, scale, animal_ids, coord_standardize=None,
                                        log_distances=log_distances, **modes) if scale else x
                yield key, finish_general(local, columns, *finish_args), columns

        return self._scaled_dict(finished(), keep64=True, saving=saving), global_scaler

    def _scaled_dict(self, outs, keep64: bool = False, saving: Optional[str] = None) -> "TableDict":
        """The scaled frames ((key, frame, columns), each taken as it comes)
        as a TableDict of LazyFrames. A frame is kept on the device, float32
        (``_device_frames``, ``_deferred_f32``) and, where ``keep64`` (the
        general route), float64 beside it for the host views, while the
        frames kept there stay within ``DEVICE_FRAMES_BYTES`` (each frame
        that fits is kept, as the JAX package's table_dict.py:771-813
        pins them); a frame that does not fit is copied to the host, its
        float32 copy in ``_host_f32`` for windowing and serving, and
        dropped from the device. In paths mode (``saving``, the file name)
        each frame is copied to the host and written to its file, in the
        precision its windows are cut in (float64 where ``keep64``, else
        float32), and the value is its pointer; its float32 frame is still
        kept on the device within the budget (table_dict.py:807-813), and no
        host copy is kept."""
        table_temp = self.new_dict_same_header({})
        dev_frames, deferred, host_f32 = {}, {}, {}
        budget = DEVICE_FRAMES_BYTES
        for key, out, columns in outs:
            out32 = out.to(torch.float32)
            if saving is not None:
                host = (out if keep64 else out32).cpu().numpy()
                table_temp[key] = save_dt(LazyFrame(lambda h=host: h, columns, len(host), str(host.dtype)),
                                          self._path_of(key, saving), True)
                if out32.numel() * 4 <= budget:
                    budget -= out32.numel() * 4
                    dev_frames[key] = out32
                del out, out32, host
                continue
            nbytes = out32.numel() * 4 + (out.numel() * 8 if keep64 else 0)
            if nbytes <= budget:
                budget -= nbytes
                holder = _DeferredScaledFrame(out32, out if keep64 else None)
                dev_frames[key] = out32
            else:
                host_f32[key] = out32.cpu().numpy()
                holder = _DeferredScaledFrame(None, host=out.cpu().numpy() if keep64 else host_f32[key])
            deferred[key] = holder
            table_temp[key] = LazyFrame(holder.host, columns, int(out.shape[0]))
            del out, out32  # a host-kept frame leaves the device before the next one is made
        table_temp._device_frames = dev_frames
        table_temp._deferred_f32 = deferred
        table_temp._host_f32 = host_f32
        return table_temp

    # ------------------------------------------------------------------ #
    # Window sampling (deepof_tpu/core/table_dict.py:1390-1462)
    # ------------------------------------------------------------------ #

    def sample_windows_from_data(
        self,
        time_bin_info: Dict[str, np.ndarray] = None,
        n_windows: int = 10000,
        no_nans: bool = False,
        return_edges: bool = False,
        seed: int = 0,
        N_windows_tab: int = None,
    ):
        """A random contiguous block of up to ``n_windows`` rows per
        experiment (after dropping rows with NaNs when ``no_nans``), or the
        rows ``time_bin_info`` gives when it covers every key; indices are
        relative to the original table. ``N_windows_tab`` is the
        reference's name for ``n_windows``.

        Returns (X (N, ...), [a (N, ...),] per-key index dict).
        """
        if N_windows_tab is not None:
            n_windows = N_windows_tab
        rng = np.random.default_rng(seed)
        use_provided = bool(time_bin_info) and set(self.keys()).issubset(time_bin_info.keys())
        xs, edges, indices = [], [], {}
        for key in self.keys():
            main, edge = self._get_data_tables(key)
            arr = np.asarray(main)
            if use_provided:
                take_idx = np.asarray(time_bin_info[key])
                take_idx = take_idx[take_idx < len(arr)]
            else:
                base_idx = np.arange(len(arr))
                pool = arr
                if no_nans:
                    ok = ~np.isnan(arr).any(axis=tuple(range(1, arr.ndim)))
                    pool = arr[ok]
                    base_idx = base_idx[ok]
                take = min(n_windows, len(pool))
                if take == 0:
                    indices[key] = np.zeros(0, dtype=int)
                    continue
                start = rng.integers(0, max(1, len(pool) - take + 1))
                take_idx = base_idx[start:start + take]
            xs.append(arr[take_idx])
            indices[key] = take_idx
            edges.append(np.asarray(edge)[take_idx] if edge is not None else np.zeros_like(arr[take_idx]))
        x = np.concatenate(xs) if xs else np.zeros((0,))
        a = np.concatenate(edges) if edges else np.zeros((0,))
        if return_edges:
            return x, a, indices
        return x, indices

    def _get_data_tables(self, key):
        raw = get_dt(self, key)
        if isinstance(raw, tuple) and len(raw) > 0:
            return raw[0], raw[1] if len(raw) > 1 else None
        return raw, None


_META_ORDER = ("shape_train", "shape_test", "dist_standardize", "speed_standardize", "coord_standardize")


def _pairwise_kernel(x: torch.Tensor, y: torch.Tensor, kernel: str, gamma: float) -> torch.Tensor:
    """sklearn's ``pairwise_kernels(x, y, metric=kernel, gamma=gamma)`` at
    its defaults (degree 3, coef0 1), in its order of operations; ``y is
    x`` zeroes the rbf distances' diagonal, as sklearn does for one input."""
    if kernel == "cosine":
        def unit(a):
            norm = torch.sqrt((a * a).sum(dim=1))
            return a / torch.where(norm == 0, torch.ones_like(norm), norm)[:, None]
        return unit(x) @ unit(y).T
    if kernel == "rbf":
        xx, yy = (x * x).sum(dim=1), (y * y).sum(dim=1)
        d = -2 * (x @ y.T) + xx[:, None] + yy[None, :]
        d = d.clamp_min(0)
        if y is x:
            d.fill_diagonal_(0)
        return torch.exp(d * -gamma)
    k = x @ y.T
    if kernel == "linear":
        return k
    if kernel == "poly":
        return (k * gamma + 1) ** 3
    if kernel == "sigmoid":
        return torch.tanh(k * gamma + 1)
    raise ValueError(f"Unknown kernel {kernel!r}: use one of {KERNELS}")


class Projection:
    """A fitted projection, in place of the sklearn estimator that the JAX
    package's ``random_projection`` / ``pca`` return: ``kind`` ("random" or
    "pca"), its float64 matrices on the fit's device, and :meth:`transform`
    for new rows. ``random``: ``components`` (n_components, F). ``pca``: the
    training rows ``x_fit``, the kernel's centring terms, ``eigenvalues``
    and ``eigenvectors`` (sklearn's names without the trailing underscore)
    and ``fitted``, the training rows' projection."""

    def __init__(self, kind: str, **state):
        self.kind = kind
        for name, value in state.items():
            setattr(self, name, value)

    @classmethod
    def random(cls, n_components: int, n_features: int, device) -> "Projection":
        """sklearn's ``GaussianRandomProjection(n_components).fit``: N(0,
        1 / n_components) entries drawn by numpy's global state."""
        if n_components <= 0 or n_features <= 0:
            raise ValueError(f"n_components ({n_components}) and n_features ({n_features}) must be positive")
        if n_components > n_features:
            warnings.warn(
                "The number of components is higher than the number of features: n_features < "
                f"n_components ({n_features} < {n_components}).The dimensionality of the problem will "
                "not be reduced."
            )
        comp = np.random.normal(loc=0.0, scale=1.0 / np.sqrt(n_components), size=(n_components, n_features))
        return cls("random", n_components=n_components, components=torch.as_tensor(comp, device=device))

    @classmethod
    def kernel_pca(cls, x: torch.Tensor, n_components: int, kernel: str = "linear") -> "Projection":
        """sklearn's ``KernelPCA(n_components, kernel=kernel).fit_transform``
        with its dense solver (sklearn takes ARPACK past 200 rows at fewer
        than 10 components; the port is exact at every size): the kernel
        centred as ``KernelCenterer``, every eigenpair from
        ``torch.linalg.eigh`` and the top ``n_components`` kept,
        ``_check_psd_eigenvalues``, ``svd_flip``'s signs, the descending
        order of ``argsort()[::-1]``, then eigenvectors * sqrt(eigenvalues)."""
        if kernel not in KERNELS:
            raise ValueError(f"Unknown kernel {kernel!r}: use one of {KERNELS}")
        if not bool(torch.isfinite(x).all()):
            raise ValueError("Input X contains NaN or infinity.")
        n = x.shape[0]
        gamma = 1.0 / x.shape[1]
        k = _pairwise_kernel(x, x, kernel, gamma)
        fit_rows = k.sum(dim=0) / n
        fit_all = fit_rows.sum() / n
        k = k - fit_rows - (k.sum(dim=1) / n)[:, None] + fit_all
        n_comp = min(n, n_components)
        values, vectors = torch.linalg.eigh(k)
        values = _check_psd_eigenvalues(values[n - n_comp:].cpu().numpy())
        vectors = vectors[:, n - n_comp:]
        # svd_flip: each column's largest |entry| made positive.
        pivot = vectors.abs().argmax(dim=0)
        vectors = vectors * torch.sign(vectors[pivot, torch.arange(n_comp, device=vectors.device)])
        order = values.argsort()[::-1].copy()
        values = values[order]
        vectors = vectors[:, torch.as_tensor(order, device=vectors.device)]
        eigenvalues = torch.as_tensor(values, device=vectors.device)
        return cls("pca", n_components=n_components, kernel=kernel, gamma=gamma, x_fit=x, fit_rows=fit_rows,
                   fit_all=fit_all, eigenvalues=eigenvalues, eigenvectors=vectors,
                   fitted=vectors * torch.sqrt(eigenvalues))

    def transform_tensor(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "random":
            return x @ self.components.T
        k = _pairwise_kernel(x, self.x_fit, self.kernel, self.gamma)
        k = k - self.fit_rows - (k.sum(dim=1) / self.fit_rows.shape[0])[:, None] + self.fit_all
        nonzero = self.eigenvalues != 0
        alphas = torch.where(nonzero, self.eigenvectors / torch.sqrt(self.eigenvalues), 0.0)
        return k @ alphas

    def transform(self, x) -> np.ndarray:
        """(n, F) rows (numpy or tensor) -> (n, n_components) numpy, float64,
        computed on the fit's device."""
        ref = self.components if self.kind == "random" else self.x_fit
        x = torch.as_tensor(np.asarray(x, np.float64)) if not isinstance(x, torch.Tensor) else x
        return self.transform_tensor(x.to(device=ref.device, dtype=torch.float64)).cpu().numpy()


def _check_psd_eigenvalues(values: np.ndarray) -> np.ndarray:
    """sklearn's ``_check_psd_eigenvalues`` on float64 eigenvalues, its
    warnings off: raise where they are not PSD, zero the small negative and
    the badly conditioned ones."""
    values = np.array(values, np.float64)
    max_eig = values.max()
    if max_eig < 0:
        raise ValueError(
            f"All eigenvalues are negative (maximum is {max_eig:g}). Either the matrix is not PSD, or "
            "there was an issue while computing the eigendecomposition of the matrix.")
    min_eig = values.min()
    if min_eig < -1e-5 * max_eig and min_eig < -1e-10:
        raise ValueError(
            f"There are significant negative eigenvalues ({-min_eig / max_eig:g} of the maximum positive). "
            "Either the matrix is not PSD, or there was an issue while computing the eigendecomposition "
            "of the matrix.")
    values[values < 0] = 0
    values[(0 < values) & (values < 1e-12 * max_eig)] = 0
    return values


class _DeferredScaledFrame:
    """A scaled (T, F) frame on the device, float32 (``dev``, what the
    window kernel and the encoder read), with the float64 frame it was cast
    from where the general route made it (``dev64``); fetched to the host
    once, on first host access, in the finer of the two, and shared by every
    lazy host view of it. A frame kept on the host past the frames budget
    has no device tensor and holds that host copy (``host``) from the
    start."""

    __slots__ = ("dev", "dev64", "_host")

    def __init__(self, dev: Optional[torch.Tensor], dev64: Optional[torch.Tensor] = None,
                 host: Optional[np.ndarray] = None):
        self.dev = dev
        self.dev64 = dev64
        self._host = host

    def host(self) -> np.ndarray:
        if self._host is None:
            self._host = (self.dev if self.dev64 is None else self.dev64).cpu().numpy()
        return self._host


def _device_lazy(frame: torch.Tensor, columns) -> LazyFrame:
    return LazyFrame(lambda f=frame: f.cpu().numpy(), columns, int(frame.shape[0]))


def _columns_of(entry, key) -> list:
    if is_pointer(entry) and entry.get("kind") == "frame":
        return list(get_dt({key: entry}, key, only_metainfo=True)["columns"])
    if not isinstance(entry, LazyFrame):
        raise TypeError(f"table {key!r} is a {type(entry).__name__}, not a frame with columns (LazyFrame)")
    return list(entry.columns)


def _dtype_of(td, key) -> str:
    """The precision of ``td``'s table ``key``: its device frame's, the
    dtype a pointer's frame was made in, or a LazyFrame's (float64 if
    unset)."""
    dev = (getattr(td, "_device_frames", None) or {}).get(key)
    if dev is not None:
        return str(dev.dtype).replace("torch.", "")
    entry = td[key]
    if is_pointer(entry):
        return get_dt(td, key, only_metainfo=True)["dtype"]
    return entry.dtype or "float64"


def _device_scale_applicable(
    scale, filter_low_variance, dist_standardize, speed_standardize, coord_standardize,
) -> bool:
    """Whether the float32 device formulation covers the call: the standard
    scaler, per-column (or disabled) standardize modes and no low-variance
    filter. (The JAX package also asks for an accelerator backend; the port
    takes it on the card and on the CPU alike.)"""
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


def _take_rows(x: torch.Tensor, rows) -> torch.Tensor:
    """``x[rows]`` on ``x``'s device: a slice for a contiguous range, one
    ``index_select`` otherwise (``deepof_tpu/core/table_dict.py:1164``)."""
    rows = np.asarray(rows)
    if rows.dtype == bool:
        rows = np.flatnonzero(rows)
    rows = rows.astype(np.int64).reshape(-1)
    if rows.size > 1 and rows[-1] - rows[0] + 1 == rows.size and np.array_equal(
        rows, np.arange(rows[0], rows[-1] + 1)
    ):
        return x[int(rows[0]):int(rows[-1]) + 1]
    return x.index_select(0, torch.as_tensor(rows, device=x.device))


def _filter_low_variance(x: torch.Tensor, columns, threshold):
    """The columns whose variance (ddof 1, NaNs skipped, as pandas' ``var``)
    exceeds ``threshold``, and every "pheno" column, in column order
    (``deepof_tpu/core/table_dict.py:1060``). Returns (x, columns)."""
    if not threshold:
        return x, list(columns)
    ok = ~torch.isnan(x)
    n = ok.sum(dim=0).to(x.dtype)
    mean = torch.where(ok, x, 0.0).sum(dim=0) / n
    d = torch.where(ok, x - mean, 0.0)
    var = (d * d).sum(dim=0) / (n - 1)
    keep = set(np.flatnonzero((var > threshold).cpu().numpy()).tolist())
    keep |= {i for i, c in enumerate(columns) if str(c).lower().startswith("pheno")}
    idx = sorted(keep)
    return x[:, idx], [columns[i] for i in idx]


def _finish_filtered(x, columns, threshold, animal_ids, log_distances, finish_args):
    """Pass 3 with ``filter_low_variance`` (the JAX package's label path,
    table_dict.py:375-460): the angles set aside and interpolated; the rest
    filtered, scaled, given the global sections (column kinds read on the
    kept columns) and clipped (on the kept speeds and distances of the whole
    table, and the kept coordinates); the filtered columns come back as
    zeros."""
    scaler, scale, interp, speed_standardize, dist_standardize, coord_standardize = finish_args
    ct = infer_column_types(columns)
    angles = set(ct["angles"])
    rest = [i for i, c in enumerate(columns) if c not in angles]
    tab, kept = _filter_low_variance(x[:, rest], [columns[i] for i in rest], threshold)
    if scale:
        tab = scale_table(tab, kept, scale, animal_ids, dist_standardize=dist_standardize,
                          speed_standardize=speed_standardize, coord_standardize=None,
                          log_distances=log_distances)
        apply_global_sections(tab, kept, scaler, speed_standardize, dist_standardize, coord_standardize)
        if scale == "standard" and interp:
            at = {c: i for i, c in enumerate(kept)}
            clip = [c for c in ct["scalars"] if c in at] + infer_column_types(kept)["coords"]
            clip_interp(tab, [at[c] for c in dict.fromkeys(clip)], interp)
    pos = {c: i for i, c in enumerate(columns)}
    out = torch.full_like(x, torch.nan)
    out[:, [pos[c] for c in kept]] = tab
    angle_idx = [pos[c] for c in ct["angles"]]
    out[:, angle_idx] = x[:, angle_idx]
    return sanitize(out, angle_idx)


def _fit_global_scaler(scale, pretrained_scaler, samples,
                       dist_standardize, speed_standardize, coord_standardize):
    """The global section scalers, as the JAX package's dict {"kind",
    "speed", "dist", "dist_inner", "dist_intra", "coord"}
    (table_dict.py:1254): standard fits through :func:`fit_standard_lite`,
    the other kinds through the port's scaler classes."""
    if pretrained_scaler is not None:
        return pretrained_scaler
    if not scale:
        return None

    def fit(bucket, groupwise):
        if not bucket:
            return None
        if scale == "standard":
            return fit_standard_lite([b.reshape(-1, 1) for b in bucket] if groupwise else bucket)
        data = torch.cat(bucket)
        return make_scaler(scale).fit(data.reshape(-1, 1) if groupwise else data)

    gs = {"kind": scale, "speed": None, "dist": None, "dist_inner": None, "dist_intra": None, "coord": None}
    for name, mode in (("speed", speed_standardize), ("coord", coord_standardize)):
        if mode in ("per_column", "groupwise"):
            gs[name] = fit(samples[name], mode == "groupwise")
    if dist_standardize == "per_column":
        gs["dist"] = fit(samples["dist"], False)
    elif dist_standardize == "groupwise":
        gs["dist_inner"] = fit(samples["inner"], True)
        gs["dist_intra"] = fit(samples["intra"], True)
    if all(v is None for k, v in gs.items() if k != "kind"):
        return None
    return gs


def extract_windows(
    to_window: TableDict,
    window_size: int,
    window_step: int,
    save_as_paths: bool = False,
    shuffle: bool = False,
    aggregate: str = None,
):
    """Slide windows over every table, on the host; returns (windowed dict,
    total shape) (``deepof_tpu/core/table_dict.py:1342``). ``aggregate``:
    None, "mid", "mean", or "wta" / "lta" for label tables. Shuffling draws
    from numpy's global state, as the JAX package does. With
    ``save_as_paths``, a table read from a pointer has its windows written
    over the pointer's files (the path it read) and the value is the new
    pointer."""
    out_len, window_len, n_features = 0, 0, 0
    for key in to_window.keys():
        entry = to_window[key]
        path = entry[POINTER_KEY] if is_pointer(entry) else None
        windows = rolling_windows_host(np.asarray(get_dt(to_window, key)), window_size, window_step)
        if aggregate in ("mid", "mean"):
            windows = aggregate_windows(torch.from_numpy(windows), aggregate).numpy()
        elif aggregate in ("wta", "lta"):
            windows = aggregate_windows_labels(windows.astype(int), aggregate)
        if shuffle:
            windows = windows[np.random.choice(len(windows), len(windows), replace=False)]
        out_len += windows.shape[0]
        window_len = windows.shape[1]
        n_features = windows.shape[2] if windows.ndim > 2 else 1
        to_window[key] = save_dt(windows, path, save_as_paths)
    return to_window, (out_len, window_len, n_features)


# --------------------------------------------------------------------------- #
# Time bins (deepof_tpu/visuals_utils.py:85-228)
# --------------------------------------------------------------------------- #

_TIME_STR = r"^\d{1,6}:\d{1,6}:\d{1,6}(?:\.\d{1,12})?$"
_TIME_RE = re.compile(r"(\d{1,6}):(\d{1,6}):(\d{1,6})(\.\d{1,9})?")


def time_to_seconds(time_string: str) -> Optional[float]:
    """"HH:MM:SS(.sss)" -> float seconds at ns resolution (None if
    malformed; ``deepof_tpu/utils.py:52``)."""
    m = _TIME_RE.fullmatch(time_string)
    if m is None:
        return None
    h, mi, sec, frac = m.groups()
    total_ns = (int(h) * 3600 + int(mi) * 60 + int(sec)) * 10**9
    if frac:
        total_ns += int(round(float(frac) * 10**9))
    return total_ns / 10**9


def seconds_to_time(seconds: float, cut_milliseconds: bool = True) -> str:
    """Float seconds -> "HH:MM:SS" or "HH:MM:SS.sssssssss"
    (``deepof_tpu/utils.py:67``)."""
    whole = int(seconds)
    hours, rem = divmod(whole, 3600)
    minutes, secs = divmod(rem, 60)
    stamp = f"{hours:02d}:{minutes:02d}:{secs:02d}"
    if cut_milliseconds:
        return stamp
    frac_ns = int(round((seconds - whole) * 10**9))
    return f"{stamp}.{frac_ns:09d}"[: len(stamp) + 10]


def preprocess_time_bins(
    coordinates,
    bin_size: Optional[Union[int, str]] = None,
    bin_index: Optional[Union[int, str]] = None,
    precomputed_bins: Optional[np.ndarray] = None,
    tab_dict_for_binning=None,
    experiment_id: Optional[str] = None,
    start_marker: Optional[str] = None,
    samples_max: Optional[int] = 20000,
    down_sample: bool = True,
    given_in_frames: bool = False,
) -> Dict[str, np.ndarray]:
    """Per-experiment frame indices of a time bin.

    Accepted inputs (anything else warns and takes a 60 s bin at 0):
    ``precomputed_bins``, a boolean array applied to each video from its
    start; int ``bin_size`` (seconds, or frames with ``given_in_frames``)
    with int ``bin_index`` (the bin number, or its first frame);
    "HH:MM:SS(.sss)" ``bin_size`` (a duration) with ``bin_index`` (its
    absolute start); both None, the full range. Bins shift by each video's
    start time (its ``start_marker``), are cut to the shortest video's
    length, checked against each video's length (a bin starting past the
    end raises, one running past it warns) and subsampled evenly to
    ``samples_max`` rows (the first ``samples_max`` without
    ``down_sample``).
    """
    if precomputed_bins is not None and (bin_size is not None or bin_index is not None):
        warnings.warn("precomputed_bins is provided. Ignoring bin_size and bin_index.")

    frame_rate = coordinates._frame_rate
    start_times = coordinates.get_start_times(start_marker=start_marker)
    start_frames = {key: int(np.round(time_to_seconds(t) * frame_rate)) for key, t in start_times.items()}
    table_lengths = coordinates.get_table_lengths(tab_dict_for_binning=tab_dict_for_binning)
    start_frames = {k: v for k, v in start_frames.items() if k in table_lengths}

    if experiment_id:
        if experiment_id not in table_lengths:
            raise KeyError(f"Experiment ID '{experiment_id}' not found.")
        start_frames = {experiment_id: start_frames[experiment_id]}
        table_lengths = {experiment_id: table_lengths[experiment_id]}

    bin_info: Dict[str, np.ndarray] = {}
    start_too_late: Dict[str, bool] = {}
    end_too_late: Dict[str, bool] = {}

    def windowed(start_frame: int, size_frames: int):
        for key, length in table_lengths.items():
            if start_frame >= length:
                start_too_late[key] = True
            if start_frame + size_frames > length:
                end_too_late[key] = True
            lo = min(length, start_frame + start_frames[key])
            hi = min(length, start_frame + size_frames + start_frames[key])
            bin_info[key] = np.arange(lo, hi)

    if precomputed_bins is not None:
        for key, length in table_lengths.items():
            arr = np.zeros(length, dtype=bool)
            eff = min(length - start_frames[key], len(precomputed_bins))
            if eff <= 0:
                eff = 0
                start_too_late[key] = True
            arr[:eff] = precomputed_bins[:eff]
            bin_info[key] = np.where(arr)[0] + start_frames[key]
            if len(precomputed_bins) > length:
                end_too_late[key] = True
    elif isinstance(bin_size, int) and isinstance(bin_index, int) and given_in_frames:
        if bin_size <= 0:
            raise ValueError("bin_size must be > 0 frames.")
        windowed(bin_index, bin_size)
    elif isinstance(bin_size, int) and isinstance(bin_index, int):
        size_frames = int(round(bin_size * frame_rate))
        if size_frames <= 0:
            raise ValueError("bin_size must round to > 0 frames.")
        windowed(size_frames * bin_index, size_frames)
    elif (
        isinstance(bin_size, str) and re.match(_TIME_STR, bin_size)
        and isinstance(bin_index, str) and re.match(_TIME_STR, bin_index)
    ):
        size_frames = int(round(time_to_seconds(bin_size) * frame_rate))
        if size_frames <= 0:
            raise ValueError("bin_size must represent a duration > 0.")
        start = int(round(time_to_seconds(bin_index) * frame_rate))
        for key, length in table_lengths.items():
            if start >= length:
                start_too_late[key] = True
            lo = int(np.clip(start + start_frames[key], 0, length))
            hi = int(np.clip(lo + size_frames, 0, length))
            if lo + size_frames > length:
                end_too_late[key] = True
            bin_info[key] = np.arange(lo, hi)
    elif bin_size is None and bin_index is None:
        for key in table_lengths:
            bin_info[key] = np.arange(start_frames[key], table_lengths[key])
    else:
        warnings.warn(
            "Invalid or mismatched bin_size/bin_index format. "
            "Defaulting to a 60-second bin starting at 0."
        )
        return preprocess_time_bins(
            coordinates, bin_size=60, bin_index=0, tab_dict_for_binning=tab_dict_for_binning,
            experiment_id=experiment_id, samples_max=samples_max, down_sample=down_sample,
        )

    if bin_info:
        min_len = min(len(v) for v in bin_info.values())
        bin_info = {k: v[:min_len] for k, v in bin_info.items()}

    for key, late in start_too_late.items():
        if late:
            max_time = seconds_to_time(table_lengths[key] / frame_rate, False)
            raise ValueError(f"[Error in {key}]: bin_index is out of range (max {max_time}).")
    for key, truncated in end_too_late.items():
        if truncated:
            warnings.warn(
                f"[For {key} and possibly others]: chosen time range exceeds "
                "signal length; bin was truncated."
            )
            break

    if samples_max is not None:
        for key, idx in bin_info.items():
            if len(idx) > samples_max:
                sel = (np.linspace(0, len(idx) - 1, samples_max, dtype=int) if down_sample
                       else np.arange(samples_max))
                bin_info[key] = idx[sel]
    return bin_info


def apply_rois_to_bin_info(
    coordinates,
    roi_number: Optional[int],
    bin_info_time: Optional[Dict[str, np.ndarray]] = None,
    in_roi_criterion: str = "Center",
    invert_roi: bool = False,
    device=None,
) -> Dict[str, dict]:
    """Per-animal in-ROI masks beside each recording's time bin
    (``deepof_tpu/visuals_utils.py:23``): {key: {"time": frame indices,
    animal: (len(time),) bool mask}}, the mask telling whether the animal's
    ``in_roi_criterion`` bodyparts (or every bodypart with "all") lie inside
    ROI ``roi_number`` (outside with ``invert_roi``). A 2-element ``time``
    array (start, end) with end > start + 1 is read as the inclusive span.
    The masks are computed on ``device`` (default: the project's) from the
    float64 positions and come back to the host in one copy."""
    animal_ids = list(coordinates._animal_ids or [""])
    if bin_info_time is None:
        bin_info_time = {key: np.arange(len(tab), dtype=int) for key, tab in coordinates._tables.items()}
    criteria = [in_roi_criterion] if isinstance(in_roi_criterion, str) else list(in_roi_criterion)
    nodes = list(coordinates._nodes)
    bin_info: Dict[str, dict] = {}
    pending = []
    for key, time_idx in bin_info_time.items():
        time_idx = np.asarray(time_idx)
        if len(time_idx) == 2 and time_idx[0] + 1 < time_idx[1]:
            time_idx = np.arange(time_idx[0], time_idx[1] + 1, dtype=int)
        bin_info[key] = {"time": time_idx}
        if roi_number is None:
            continue
        dev = resolve_device(coordinates._device if device is None else device)
        pos = torch.as_tensor(np.asarray(coordinates._tables[key], np.float64), device=dev)
        rows = torch.as_tensor(time_idx.astype(np.int64), device=dev)
        polygon = np.asarray(coordinates._roi_dicts[key][roi_number])
        for aid in animal_ids:
            prefix = f"{aid}_" if aid else ""
            bps = [bp for bp in nodes if bp.startswith(prefix)] if "all" in criteria else [
                f"{prefix}{c}" for c in criteria]
            mask = torch.ones(len(pos), dtype=torch.bool, device=dev)
            for bp in bps:
                if bp in nodes:
                    mask &= point_in_polygon(pos[:, nodes.index(bp)], polygon)
            pending.append((key, aid, (~mask if invert_roi else mask)[rows]))
    for (key, aid, _), mask in zip(pending, fetch_together([m for _, _, m in pending])):
        bin_info[key][aid] = mask
    return bin_info
