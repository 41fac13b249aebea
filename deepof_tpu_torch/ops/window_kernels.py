"""Stride-1 windows of a frame, standardised and laid out as the encoder's
streams, in one kernel launch.

Port of the TPU kernel ``deepof_tpu/ops/pallas_kernels.py``
``window_gather_standardize`` (:65, ``pallas_call`` at :111), widened to
write what the encoder reads: the JAX package gathers the node and edge
columns out of the windows, stacks the x / y / speed slices and splits the
result into per-stream sequences (``deepof_tpu/models/encoders.py:69-70``);
here one launch of ``csrc/window_gather.cu`` writes those streams straight
from the frame's rows. ``window_gather_standardize`` is the case of the
single table 0..F-1.

On a CUDA tensor a wrapper launches the kernel or raises; on a CPU tensor it
runs the plain version below, which the tests and ``chip_smoke.py`` hold the
kernel against. There is no fallback from a CUDA tensor to the plain version.

Bound on an H100: bytes (the outputs are about ``window`` times the rows).
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import numpy as np
import torch

from deepof_tpu_torch.ops import cuda_build

MAX_TABLES = 4
MAX_COLS = 768  # columns of all tables of one launch
_MODES = ("scalar", "float4")


def window_streams_plain(
    rows: torch.Tensor, tables: Sequence, mu: torch.Tensor, sd: torch.Tensor, window: int
) -> List[torch.Tensor]:
    """For each (G, k) column table, the (n*G, window, k) streams
    ``out[i*G + g, w, j] = (rows[i + w, c] - mu[c]) * (1 / sd[c])``,
    ``c = cols[g, j]``, n = R - window + 1, by indexing."""
    n = rows.shape[0] - window + 1
    z = (rows - mu) * (1.0 / sd)
    t = torch.arange(n, device=rows.device)[:, None] + torch.arange(window, device=rows.device)[None, :]
    outs = []
    for cols in tables:
        cols = torch.as_tensor(np.asarray(cols), dtype=torch.long, device=rows.device)
        g, k = cols.shape
        outs.append(z[t[:, None, :, None], cols[None, :, None, :]].reshape(n * g, window, k))
    return outs


def window_gather_standardize_plain(
    feats: torch.Tensor, mu: torch.Tensor, sd: torch.Tensor, window: int
) -> torch.Tensor:
    """(T, F) -> (T - window + 1, window, F) windows of ``(x - mu) / sd``,
    by indexing; the affine multiplies by ``1 / sd`` as the kernel does."""
    return window_streams_plain(feats, [_identity(feats.shape[1])], mu, sd, window)[0]


def _identity(f: int) -> np.ndarray:
    return np.arange(f, dtype=np.int32)[None]


def _check(rows, mu, sd, window):
    if rows.ndim != 2:
        raise ValueError(f"rows must be (R, F), got shape {tuple(rows.shape)}")
    r, f = rows.shape
    if not 1 <= window <= r:
        raise ValueError(f"window {window} must lie in [1, R={r}]")
    for name, v in (("mu", mu), ("sd", sd)):
        if v.shape != (f,):
            raise ValueError(f"{name} must be ({f},), got {tuple(v.shape)}")
        if v.device != rows.device or v.dtype != rows.dtype:
            raise ValueError(f"{name} must share the rows' device and dtype")


def _host_tables(tables: Sequence, f: int) -> List[np.ndarray]:
    """The column tables as int32 host arrays, checked: 2-D, integer, every
    column in [0, F). Tables are index data the wrapper reads on the host, so
    checking them costs the card no synchronisation."""
    if not 1 <= len(tables) <= MAX_TABLES:
        raise ValueError(f"1 to {MAX_TABLES} column tables, got {len(tables)}")
    out = []
    for cols in tables:
        if isinstance(cols, torch.Tensor):
            if cols.device.type != "cpu":
                raise ValueError(f"column tables are host index data, got one on {cols.device}")
            cols = cols.numpy()
        a = np.asarray(cols)
        if a.dtype.kind not in "iu":
            raise TypeError(f"column tables must be integers, got {a.dtype}")
        if a.ndim != 2 or 0 in a.shape:
            raise ValueError(f"a column table must be (G, k) with G, k >= 1, got shape {a.shape}")
        if a.min() < 0 or a.max() >= f:
            raise ValueError(f"table columns must lie in [0, F={f}), got [{a.min()}, {a.max()}]")
        out.append(np.ascontiguousarray(a, dtype=np.int32))
    return out


def _launch(rows, tables, mu, sd, window):
    """One kernel launch writing every table's streams (tables as from
    ``_host_tables``). Returns the outputs."""
    if rows.device.type != "cuda":
        raise ValueError(f"unsupported device {rows.device}")
    if rows.dtype != torch.float32:
        raise TypeError(f"the CUDA kernel takes float32, got {rows.dtype}")
    if not (rows.is_contiguous() and mu.is_contiguous() and sd.is_contiguous()):
        raise ValueError("rows, mu and sd must be contiguous")
    r, f = rows.shape
    n = r - window + 1
    if sum(c.size for c in tables) > MAX_COLS:
        raise ValueError(f"the kernel takes at most {MAX_COLS} table columns in all")
    outs = [torch.empty((n * c.shape[0], window, c.shape[1]), device=rows.device, dtype=torch.float32)
            for c in tables]
    gk = np.array([c.shape for c in tables], np.int32)
    cols = np.concatenate([c.ravel() for c in tables])
    out_ptrs = (ctypes.c_void_p * len(outs))(*[o.data_ptr() for o in outs])
    launch = cuda_build.load("window_gather").window_streams_launch
    with torch.cuda.device(rows.device):
        err = launch(
            rows.data_ptr(), mu.data_ptr(), sd.data_ptr(), r, f, window, len(tables),
            gk.ctypes.data, cols.ctypes.data, ctypes.addressof(out_ptrs),
            torch.cuda.current_stream(rows.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"window_streams launch failed with CUDA error {err} (R={r}, F={f}, window={window}, "
            f"tables {[c.shape for c in tables]})"
        )
    return outs


def window_streams(
    rows: torch.Tensor, tables: Sequence, mu: torch.Tensor, sd: torch.Tensor, window: int
) -> List[torch.Tensor]:
    """Every stride-1 window of ``rows``, standardised, as the streams of each
    column table: one (n*G, window, k) tensor per (G, k) table, stream
    ``i*G + g`` being group g of window i (window-major, the order of
    ``tf_style_group_reshape(x).reshape(b * n, t, f)``), n = R - window + 1.

    Args:
        rows: (R, F) per-frame features; float32 and contiguous on the card.
        tables: 1 to ``MAX_TABLES`` int column tables (G, k) on the host
            (numpy arrays, lists or CPU tensors), columns in [0, F); on the
            card at most ``MAX_COLS`` columns in all. All are written by one
            kernel launch.
        mu, sd: (F,) standardisation constants on the rows' device.
        window: window length.
    """
    _check(rows, mu, sd, window)
    tables = _host_tables(tables, rows.shape[1])
    if rows.device.type == "cpu":
        return window_streams_plain(rows, tables, mu, sd, window)
    outs = _launch(rows, tables, mu, sd, window)
    window_streams.launches += 1
    return outs


def window_gather_standardize(
    feats: torch.Tensor, mu: torch.Tensor, sd: torch.Tensor, window: int
) -> torch.Tensor:
    """All stride-1 windows of ``feats``, standardised: (T - window + 1, window, F).

    Args:
        feats: (T, F) per-frame features; float32 and contiguous on the card,
            where F is at most ``MAX_COLS`` (the kernel's table 0..F-1).
        mu, sd: (F,) standardisation constants on the same device.
        window: window length.
    """
    _check(feats, mu, sd, window)
    if feats.device.type == "cpu":
        return window_gather_standardize_plain(feats, mu, sd, window)
    out = _launch(feats, [_identity(feats.shape[1])], mu, sd, window)[0]
    window_gather_standardize.launches += 1
    return out


# Kernel launches since the last reset (set to 0 to reset).
window_streams.launches = 0
window_gather_standardize.launches = 0


def window_streams_config(r: int, f: int, window: int, table_shapes) -> dict:
    """The launch the kernel makes on the current CUDA device for rows (R, F)
    and tables of these (G, k) shapes: store mode, CTAs in the grid, windows
    per chunk, threads and shared memory per CTA, CTAs resident per SM."""
    fn = cuda_build.load("window_gather").window_streams_config
    gk = np.array(table_shapes, np.int32).reshape(-1, 2)
    info = (ctypes.c_int * 6)()
    err = fn(r, f, window, len(gk), gk.ctypes.data, ctypes.addressof(info))
    if err != 0:
        raise RuntimeError(f"window_streams_config failed with CUDA error {err}")
    mode, grid, chunk, threads, smem, per_sm = info
    return {"mode": _MODES[mode], "grid": grid, "windows_per_chunk": chunk, "threads": threads,
            "smem_bytes": smem, "ctas_per_sm": per_sm}
