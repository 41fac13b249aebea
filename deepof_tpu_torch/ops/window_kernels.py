"""Stride-1 window gather with the standardisation affine fused in.

Port of the TPU kernel ``deepof_tpu/ops/pallas_kernels.py``
``window_gather_standardize`` (:65, ``pallas_call`` at :111). On a CUDA
tensor the wrapper launches ``csrc/window_gather.cu`` or raises; on a CPU
tensor it runs the plain version below, which the tests and
``chip_smoke.py`` hold the kernel against. There is no fallback from a CUDA
tensor to the plain version.

Bound on an H100: bytes (the output is ``window`` times the input).
"""

from __future__ import annotations

import ctypes

import torch

from deepof_tpu_torch.ops import cuda_build


def window_gather_standardize_plain(
    feats: torch.Tensor, mu: torch.Tensor, sd: torch.Tensor, window: int
) -> torch.Tensor:
    """(T, F) -> (T - window + 1, window, F) windows of ``(x - mu) / sd``,
    by indexing; the affine multiplies by ``1 / sd`` as the kernel does."""
    n = feats.shape[0] - window + 1
    idx = (
        torch.arange(n, device=feats.device)[:, None]
        + torch.arange(window, device=feats.device)[None, :]
    )
    return (feats[idx] - mu) * (1.0 / sd)


def _check(feats, mu, sd, window):
    if feats.ndim != 2:
        raise ValueError(f"feats must be (T, F), got shape {tuple(feats.shape)}")
    t, f = feats.shape
    if not 1 <= window <= t:
        raise ValueError(f"window {window} must lie in [1, T={t}]")
    for name, v in (("mu", mu), ("sd", sd)):
        if v.shape != (f,):
            raise ValueError(f"{name} must be ({f},), got {tuple(v.shape)}")
        if v.device != feats.device or v.dtype != feats.dtype:
            raise ValueError(f"{name} must share feats' device and dtype")


def _windows_per_block(n_windows: int, device: torch.device) -> int:
    """At least two blocks per SM, at most 64 windows per block."""
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(64, n_windows // (2 * n_sm)))


def window_gather_standardize(
    feats: torch.Tensor, mu: torch.Tensor, sd: torch.Tensor, window: int
) -> torch.Tensor:
    """All stride-1 windows of ``feats``, standardised: (T - window + 1, window, F).

    Args:
        feats: (T, F) per-frame features; float32 and contiguous on the card.
        mu, sd: (F,) standardisation constants on the same device.
        window: window length.
    """
    _check(feats, mu, sd, window)
    if feats.device.type == "cpu":
        return window_gather_standardize_plain(feats, mu, sd, window)
    if feats.device.type != "cuda":
        raise ValueError(f"unsupported device {feats.device}")
    if feats.dtype != torch.float32:
        raise TypeError(f"the CUDA kernel takes float32, got {feats.dtype}")
    if not (feats.is_contiguous() and mu.is_contiguous() and sd.is_contiguous()):
        raise ValueError("feats, mu and sd must be contiguous")

    t, f = feats.shape
    n_windows = t - window + 1
    out = torch.empty((n_windows, window, f), device=feats.device, dtype=torch.float32)
    launch = cuda_build.load("window_gather").window_gather_launch
    launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    launch.restype = ctypes.c_int
    with torch.cuda.device(feats.device):
        err = launch(
            feats.data_ptr(), mu.data_ptr(), sd.data_ptr(), out.data_ptr(),
            f, window, n_windows, _windows_per_block(n_windows, feats.device),
            torch.cuda.current_stream(feats.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"window_gather launch failed with CUDA error {err}")
    window_gather_standardize.launches += 1
    return out


# Kernel launches since the last reset (set to 0 to reset).
window_gather_standardize.launches = 0
