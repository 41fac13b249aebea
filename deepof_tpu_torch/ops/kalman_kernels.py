"""Kalman filter + RTS smoother of every channel of a (T, C) float32 block:
the serial part of full imputation.

No TPU kernel is replaced: the JAX package runs ``_kalman_rts_1d``
(``deepof_tpu/ops/imputation.py:44-86``) as two ``lax.scan``s over frames,
vmapped over the channels. PyTorch runs eagerly, so a loop over frames
would launch a handful of operators for every one of the 2 T steps; on a
CUDA tensor :func:`kalman_rts` launches ``csrc/kalman_rts.cu`` instead (the
data-independent covariances in one thread, the smoother's gains a thread
a step, then a thread a channel), or raises. On a CPU tensor it runs :func:`kalman_rts_plain`: the gains as a
float32 scalar recursion, then the filter and the smoother as loops over T
batched over the channels. There is no fallback from a CUDA tensor.

Both round every operation as XLA's CPU program of the JAX scan does: its
2 x 2 products as fma(a_i1, b_1j, a_i0 b_0j), ``a - b c`` as fma(-b, c, a)
and ``a + b c`` as fma(b, c, a) (the plain version takes an FMA as the
float32 rounding of the float64 result, exact but for a double rounding
once in ~2^29). The model's first steps (P0 = 1000) make the smoother's
2 x 2 inverse cancel badly, so another rounding moves the output by ~1e-3;
with these the plain version equals the JAX scan bit for bit on the CPU.

Bound on an H100: neither bytes nor operations; each channel is a chain of
2 T dependent steps (the note in the source).
"""

from __future__ import annotations

import numpy as np
import torch

from deepof_tpu_torch.ops import cuda_build

# The model's constants (deepof_tpu/ops/imputation.py:33-36), in float32.
_Q = (np.array([[0.25, 0.5], [0.5, 1.0]]) * 0.01).astype(np.float32)
_R = np.float32(0.1)
_P0 = np.float32(1000.0)


def _fma(a, b, c):
    """float32 a * b + c, rounded once (numpy scalars or tensors)."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return (a.double() * b.double() + c.double()).float()
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def kalman_gains(t_len: int) -> np.ndarray:
    """(T, 8) float32: row t holds the smoother gain C_t (row-major; rows
    0..T-2) and the filter gain k_t (floats 4-5; rows 1..T-1), as the
    kernel's workspace holds them. The covariances do not depend on the
    data, so this is a scalar recursion in numpy's float32 scalars
    (correctly rounded, as the card's ``__f*_rn`` intrinsics)."""
    f32 = np.float32
    q00, q01, q11 = _Q[0, 0], _Q[0, 1], _Q[1, 1]
    out = np.zeros((max(t_len, 1), 8), np.float32)
    f00, f01, f10, f11 = _P0, f32(0.0), f32(0.0), _P0
    for t in range(1, t_len):
        a00, a01 = f00 + f10, f01 + f11
        p00, p01 = (a00 + a01) + q00, a01 + q01
        p10, p11 = (f10 + f11) + q01, f11 + q11
        b00, b01, b10, b11 = f00 + f01, f01, f10 + f11, f11
        det = _fma(p00, p11, -(p01 * p10))
        i00, i01, i10, i11 = p11 / det, -p01 / det, -p10 / det, p00 / det
        out[t - 1, :4] = (_fma(b01, i10, b00 * i00), _fma(b01, i11, b00 * i01),
                          _fma(b11, i10, b10 * i00), _fma(b11, i11, b10 * i01))
        s = p00 + _R
        k0, k1 = p00 / s, p10 / s
        out[t, 4:6] = (k0, k1)
        f00, f01 = _fma(-k0, p00, p00), _fma(-k0, p01, p01)
        f10, f11 = _fma(-k1, p00, p10), _fma(-k1, p01, p11)
    return out


def kalman_rts_plain(z: torch.Tensor) -> torch.Tensor:
    """The filter and the smoother as loops over T, batched over the
    channels; the argument and result of :func:`kalman_rts`. The gains come
    from :func:`kalman_gains` on the host."""
    t_len, _ = z.shape
    gains = torch.as_tensor(kalman_gains(t_len), device=z.device)
    k0, k1 = gains[:, 4], gains[:, 5]
    xf0, xf1 = torch.empty_like(z), torch.empty_like(z)
    x0, x1 = z[0].clone(), z[0].clone()
    xf0[0], xf1[0] = x0, x1
    for t in range(1, t_len):
        xp0 = x0 + x1
        innov = z[t] - xp0
        x0 = _fma(k0[t], innov, xp0)
        x1 = _fma(k1[t], innov, x1)
        xf0[t], xf1[t] = x0, x1
    out = torch.empty_like(z)
    out[t_len - 1] = x0
    c = gains[:, :4]
    for t in range(t_len - 2, -1, -1):
        d0 = x0 - (xf0[t] + xf1[t])
        d1 = x1 - xf1[t]
        x0 = xf0[t] + _fma(c[t, 1], d1, c[t, 0] * d0)
        x1 = xf1[t] + _fma(c[t, 3], d1, c[t, 2] * d0)
        out[t] = x0
    return out


def _check(z: torch.Tensor) -> None:
    if z.ndim != 2:
        raise ValueError(f"z must be (T, C), got {tuple(z.shape)}")
    if z.dtype != torch.float32:
        raise TypeError(f"z must be float32, got {z.dtype}")
    if not z.is_contiguous():
        raise ValueError("z must be contiguous")
    if z.shape[0] < 1:
        raise ValueError("z needs at least one frame")


def _launch(z: torch.Tensor) -> torch.Tensor:
    t_len, channels = z.shape
    out = torch.empty_like(z)
    cov, gains = torch.empty((2, t_len, 8), dtype=torch.float32, device=z.device)
    x_filt = torch.empty((t_len, channels, 2), dtype=torch.float32, device=z.device)
    launch = cuda_build.load("kalman_rts").kalman_rts_launch
    with torch.cuda.device(z.device):
        err = launch(z.data_ptr(), out.data_ptr(), cov.data_ptr(), gains.data_ptr(), x_filt.data_ptr(), t_len,
                     channels, torch.cuda.current_stream(z.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"kalman_rts launch failed with CUDA error {err} (T={t_len}, C={channels})")
    return out


def kalman_rts(z: torch.Tensor) -> torch.Tensor:
    """RTS-smoothed positions of every channel.

    Args:
        z: (T, C) measurements, float32 and contiguous, T >= 1.

    Returns:
        (T, C) smoothed positions.
    """
    _check(z)
    if z.device.type == "cpu":
        return kalman_rts_plain(z)
    if z.device.type != "cuda":
        raise ValueError(f"unsupported device {z.device}")
    out = _launch(z)
    if z.shape[1]:
        kalman_rts.launches += 1
    return out


# Kernel launches since the last reset (set to 0 to reset).
kalman_rts.launches = 0
