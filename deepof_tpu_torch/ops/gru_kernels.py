"""Masked GRU scan with flax GRUCell math.

Port of the TPU kernel ``deepof_tpu/ops/pallas_gru.py`` ``gru_scan_pallas``
(:55, ``pallas_call`` at :100). The input projection ``x W_i + b_i`` is one
GEMM outside the kernel, as on the TPU; the wrapper takes its result.

On a CUDA tensor the wrapper launches ``csrc/gru_scan.cu`` or raises; on a
CPU tensor it runs the plain version below (a Python loop over T: prefix
lengths can be 0, which ``pack_padded_sequence`` rejects, and the gates are
flax's, not ``nn.GRU``'s). There is no fallback from a CUDA tensor.

Bound on an H100 at the serving widths (H = 8, 16): bytes.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from deepof_tpu_torch.ops import cuda_build

MAX_HIDDEN = 128


def gru_scan_plain(
    xg: torch.Tensor,
    mask: torch.Tensor,
    wh: torch.Tensor,
    bhn: torch.Tensor,
    reverse: Sequence[bool],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Loop over T per direction; same arguments and results as :func:`gru_scan`."""
    b, t, d, h3 = xg.shape
    h = h3 // 3
    outs = xg.new_zeros((b, t, d, h))
    finals = []
    for k in range(d):
        carry = xg.new_zeros((b, h))
        for s in (range(t - 1, -1, -1) if reverse[k] else range(t)):
            g = xg[:, s, k]
            hg = carry @ wh[k]
            r = torch.sigmoid(g[:, :h] + hg[:, :h])
            z = torch.sigmoid(g[:, h:2 * h] + hg[:, h:2 * h])
            n = torch.tanh(g[:, 2 * h:] + r * (hg[:, 2 * h:] + bhn[k]))
            new = (1.0 - z) * n + z * carry
            m = mask[:, s, None]
            carry = torch.where(m, new, carry)
            outs[:, s, k] = torch.where(m, new, 0.0)
        finals.append(carry)
    return outs.reshape(b, t, d * h), torch.cat(finals, dim=-1)


def _check(xg, mask, wh, bhn, reverse):
    if xg.ndim != 4 or xg.shape[-1] % 3:
        raise ValueError(f"xg must be (B, T, D, 3H), got {tuple(xg.shape)}")
    b, t, d, h3 = xg.shape
    h = h3 // 3
    if d not in (1, 2) or len(reverse) != d:
        raise ValueError(f"{d} directions with reverse={tuple(reverse)}: need 1 or 2, one flag each")
    if not 1 <= h <= MAX_HIDDEN:
        raise ValueError(f"hidden size {h} outside [1, {MAX_HIDDEN}]")
    if mask.shape != (b, t) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be bool ({b}, {t}), got {mask.dtype} {tuple(mask.shape)}")
    if wh.shape != (d, h, h3) or bhn.shape != (d, h):
        raise ValueError(f"wh must be ({d}, {h}, {h3}) and bhn ({d}, {h})")
    for v in (mask, wh, bhn):
        if v.device != xg.device:
            raise ValueError("xg, mask, wh and bhn must share one device")
    if wh.dtype != xg.dtype or bhn.dtype != xg.dtype:
        raise ValueError("xg, wh and bhn must share one dtype")


def gru_scan(
    xg: torch.Tensor,
    mask: torch.Tensor,
    wh: torch.Tensor,
    bhn: torch.Tensor,
    reverse: Sequence[bool] = (False,),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked GRU recurrence over T for D = 1 or 2 directions.

    Args:
        xg: (B, T, D, 3H) input projections ``x W_i + b_i``, gates [r|z|n].
        mask: (B, T) bool; a False step keeps the carry and outputs 0.
        wh: (D, H, 3H) recurrent kernels [W_hr | W_hz | W_hn].
        bhn: (D, H) candidate-gate recurrent bias.
        reverse: per direction, whether it walks T backwards.

    Returns:
        (outputs (B, T, D*H), final carries (B, D*H)), directions concatenated.
    """
    _check(xg, mask, wh, bhn, reverse)
    if xg.device.type == "cpu":
        return gru_scan_plain(xg, mask, wh, bhn, reverse)
    if xg.device.type != "cuda":
        raise ValueError(f"unsupported device {xg.device}")
    if xg.dtype != torch.float32:
        raise TypeError(f"the CUDA kernel takes float32, got {xg.dtype}")
    if not all(v.is_contiguous() for v in (xg, mask, wh, bhn)):
        raise ValueError("xg, mask, wh and bhn must be contiguous")

    b, t, d, h3 = xg.shape
    h = h3 // 3
    out = torch.empty((b, t, d * h), device=xg.device, dtype=torch.float32)
    fin = torch.empty((b, d * h), device=xg.device, dtype=torch.float32)
    if b == 0 or t == 0:
        return out, fin.zero_()
    launch = cuda_build.load("gru_scan").gru_scan_launch
    launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    launch.restype = ctypes.c_int
    rev_mask = sum(1 << k for k, r in enumerate(reverse) if r)
    with torch.cuda.device(xg.device):
        err = launch(
            xg.data_ptr(), mask.data_ptr(), wh.data_ptr(), bhn.data_ptr(),
            out.data_ptr(), fin.data_ptr(), b, t, d, h, rev_mask,
            torch.cuda.current_stream(xg.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"gru_scan launch failed with CUDA error {err}")
    gru_scan.launches += 1
    return out, fin


# Kernel launches since the last reset (set to 0 to reset).
gru_scan.launches = 0
