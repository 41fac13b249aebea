"""Kalman filter + RTS smoother of every channel of a (T, C) float32 block:
the serial part of full imputation.

No TPU kernel is replaced: the JAX package runs ``_kalman_rts_1d``
(``deepof_tpu/ops/imputation.py:44-86``) as two ``lax.scan``s over frames,
vmapped over the channels. PyTorch runs eagerly, so a loop over frames
would launch a handful of operators for every one of the 2 T steps; on a
CUDA tensor :func:`kalman_rts` launches ``csrc/kalman_rts.cu`` instead, or
raises. On a CPU tensor it runs :func:`kalman_rts_plain`: the gains as a
float32 scalar recursion, then the filter and the smoother as loops over T
batched over the channels. There is no fallback from a CUDA tensor.

Both round every operation as XLA's CPU program of the JAX scan does: its
2 x 2 products as fma(a_i1, b_1j, a_i0 b_0j), ``a - b c`` as fma(-b, c, a)
and ``a + b c`` as fma(b, c, a) (the plain version takes an FMA as the
float32 rounding of the float64 result, exact but for a double rounding
once in ~2^29). The model's first steps (P0 = 1000) make the smoother's
2 x 2 inverse cancel badly, so another rounding moves the output by ~1e-3;
with these the plain version equals the JAX scan bit for bit on the CPU.

The gains do not depend on the data, and the float32 chain of filter
covariances repeats exactly: on this model P_filt[28] has the bits of
P_filt[26], so every later row is a copy of one of the first period's.
:func:`kalman_gains` and the kernel run the chain to its first repeat
(compared with the last ``HISTORY`` states) and fill the rest from the
period, the same bits as the chain run to T.

The kernel is a chunked parallel-in-time scan (the note in the source):
each pass (filter, smoother) cuts its T - 1 steps into chunks of L
(:func:`kalman_rts_config`), walks every chunk from a zero start for its
affine offset while one CTA a chunk forms its 2 x 2 transfer matrix,
carries the chunk starts (a warp a channel, a scan over the chunks), then
reruns every chunk from its start with the serial step's arithmetic (a
CTA's gains staged in shared memory, z loaded a tile ahead of the chain).
The maps contract by 0.674 a step, so a rerun's few ulp of start
difference fade within ~50 steps. :func:`kalman_rts_chunked_plain` states
the same phases with the chunks batched as tensors, for the tests.

Bound on an H100: the function's bytes (8 T C: z read once, the output
written once, ~3 us at (45,000, 28)), and the algorithm's (z read twice,
x_filt written once and read twice, the gains: 36 T C + 80 T bytes, ~14
us); what sets the time is 32 steps of the covariance chain, ~2 (L + L)
dependent steps a channel (~380 at (45,000, 28), not the 2 T = 90,000 of
a chain a channel) and the carries' scans, and eight launches.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from deepof_tpu_torch.ops import cuda_build

# The model's constants (deepof_tpu/ops/imputation.py:33-36), in float32.
_Q = (np.array([[0.25, 0.5], [0.5, 1.0]]) * 0.01).astype(np.float32)
_R = np.float32(0.1)
_P0 = np.float32(1000.0)

HISTORY = 8  # filter covariances compared with each new one for a repeat
MIN_CHUNK = 64  # below this many steps a pass is one chunk: the serial chain
MAX_CHUNK = 2048  # csrc/kalman_rts.cu's kMaxChunk: a chunk's C_t fill 32 KB of shared memory
# The kernels of csrc/kalman_rts.cu in launch order (the walks' and carries'
# template arguments: rerun or offsets; filter or smoother).
LAUNCHES = ("kalman_period", "kalman_fill", "kalman_filter_walk<false>", "kalman_carry<true>",
            "kalman_filter_walk<true>", "kalman_smoother_walk<false>", "kalman_carry<false>",
            "kalman_smoother_walk<true>")


def _fma(a, b, c):
    """a * b + c, rounded once to float32 (numpy scalars or float32
    tensors); float64 tensors stay float64."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return (a.double() * b.double() + c.double()).to(c.dtype)
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def kalman_gains_period(t_len: int) -> Tuple[np.ndarray, int, int]:
    """(gains, first, lag): the (T, 8) float32 gains of :func:`kalman_gains`
    and where the chain of filter covariances first repeats, P_filt[first +
    lag] having the bits of P_filt[first] (lag 0 and first = T where it does
    not repeat within T). The chain runs to that repeat only; every later
    row is copied from the period."""
    f32 = np.float32
    q00, q01, q11 = _Q[0, 0], _Q[0, 1], _Q[1, 1]
    out = np.zeros((max(t_len, 1), 8), np.float32)
    f00, f01, f10, f11 = _P0, f32(0.0), f32(0.0), _P0
    history = [np.array([f00, f01, f10, f11], np.float32).tobytes()]  # P_filt[0 ..] as bytes
    first, lag = t_len, 0
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
        state = np.array([f00, f01, f10, f11], np.float32).tobytes()
        recent = history[-HISTORY:][::-1]
        if state in recent:
            lag = recent.index(state) + 1
            first = t - lag
            break
        history.append(state)
    if lag:
        # The loop stopped at step first + lag having written C_t for t <
        # first + lag and k_t for t <= first + lag. C_t comes from P_filt[t],
        # k_t from P_filt[t - 1]: past the repeat, from their period rows.
        end = first + lag
        t = np.arange(end, t_len - 1)
        out[t, :4] = out[first + (t - first) % lag, :4]
        t = np.arange(end + 1, t_len)
        out[t, 4:6] = out[first + 1 + (t - 1 - first) % lag, 4:6]
    return out, first, lag


def kalman_gains(t_len: int) -> np.ndarray:
    """(T, 8) float32: row t holds the smoother gain C_t (row-major; rows
    0..T-2) and the filter gain k_t (floats 4-5; rows 1..T-1), as the
    kernel's workspace holds them. The covariances do not depend on the
    data, so this is a scalar recursion in numpy's float32 scalars
    (correctly rounded, as the card's ``__f*_rn`` intrinsics), run to its
    first exact repeat and filled from the period past it
    (:func:`kalman_gains_period`)."""
    return kalman_gains_period(t_len)[0]


def kalman_rts_plain(z: torch.Tensor) -> torch.Tensor:
    """The filter and the smoother as loops over T, batched over the
    channels; the argument and result of :func:`kalman_rts`. The gains come
    from :func:`kalman_gains` on the host. A float64 ``z`` runs the same
    chain in float64 from the same float32 gains."""
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


def _chunks(t_len: int, chunk: int) -> Tuple[int, int]:
    """(L, n): chunks of L <= ``chunk`` steps covering the T - 1 steps of a
    pass (one chunk of one step where T = 1)."""
    steps = t_len - 1
    length = max(1, min(chunk, steps))
    return length, max(1, -(-steps // length))


def kalman_rts_config(t: int, c: int, chunk: Optional[int] = None) -> dict:
    """The scan :func:`kalman_rts` launches for T frames and C channels:
    the chunk length L = max(MIN_CHUNK, ceil(sqrt((T - 1) / 5))), at most
    MAX_CHUNK and T - 1 (one chunk, the serial chain, where T - 1 <=
    MIN_CHUNK, the ~30-step transient included); the chunk count n; its
    launches (eight, four with one chunk); and the float32 workspace's
    layout (offsets in floats of cov, gains, maps, x_filt, off, start and
    the two period ints), whose size is ``scratch_floats``. A walk takes L
    steps and a carry lane ~n / 32 chunks, so the time goes as a L + b T /
    L; on an H100 the chunk lengths 48-425 at (45,000, 28) and (180,000,
    28) were fastest near sqrt(T / 5) (``scripts/torch_ab_path.py --kalman
    ROOT --chunks``). L depends on T alone: C only widens each launch.
    ``chunk`` sets L instead (at most MAX_CHUNK), for measurements."""
    steps = t - 1
    if chunk is None:
        chunk = min(MAX_CHUNK, max(MIN_CHUNK, math.isqrt((steps - 1) // 5) + 1)) if steps > 0 else 1
    length, n = _chunks(t, chunk)
    sizes = (("cov", 8 * t), ("gains", 8 * t), ("maps", 8 * n), ("x_filt", 2 * t * c), ("off", 2 * n * c),
             ("start", 2 * n * c), ("period", 4))
    layout, at = {}, 0
    for name, size in sizes:
        layout[name] = at
        at += size
    launches = list(LAUNCHES) if n > 1 else [LAUNCHES[i] for i in (0, 1, 4, 7)]
    return {"chunk": length, "chunks": n, "launches": launches, "layout": layout, "scratch_floats": at}


def kalman_rts_chunked_plain(z: torch.Tensor, chunk: int) -> torch.Tensor:
    """The kernel's phases in plain torch, with chunks of ``chunk`` steps
    batched as tensors: the argument and result of :func:`kalman_rts`
    (float32, or float64 from the same float32 gains). For the tests: the
    CPU wrapper runs the serial :func:`kalman_rts_plain`."""
    t_len, channels = z.shape
    length, n = _chunks(t_len, chunk)
    last = (t_len - 1) - (n - 1) * length  # steps of the last chunk; the others have L
    gains = torch.as_tensor(kalman_gains(t_len), device=z.device)
    k0, k1, cg = gains[:, 4, None], gains[:, 5, None], gains[:, :4, None]
    base = torch.arange(n, device=z.device) * length
    top = (base + length).clamp(max=t_len - 1)

    def walks(s):
        """The chunks that take a step s of their walk."""
        return n if s < last else n - 1

    # The filter: chunk c walks steps 1 + cL .. min(cL + L, T - 1).
    def filter_walk(x0, x1, x_filt=None):
        for s in range(length):
            m = walks(s)
            t = 1 + base[:m] + s
            xp0 = x0[:m] + x1[:m]
            innov = z[t] - xp0
            x0[:m], x1[:m] = _fma(k0[t], innov, xp0), _fma(k1[t], innov, x1[:m])
            if x_filt is not None:
                x_filt[t, :, 0], x_filt[t, :, 1] = x0[:m], x1[:m]

    # The smoother: chunk c walks steps min(cL + L, T - 1) - 1 .. cL.
    def smoother_walk(x0, x1, x_filt, out=None):
        for s in range(length):
            m = walks(s)
            t = top[:m] - 1 - s
            xf0, xf1, g = x_filt[t, :, 0], x_filt[t, :, 1], cg[t]
            d0, d1 = x0[:m] - (xf0 + xf1), x1[:m] - xf1
            x0[:m], x1[:m] = xf0 + _fma(g[:, 1], d1, g[:, 0] * d0), xf1 + _fma(g[:, 3], d1, g[:, 2] * d0)
            if out is not None:
                out[t] = x0[:m]

    def transfer(mats):
        """The chunks' transfer matrices: the product of each chunk's
        (n, L, 2, 2) step matrices, the later steps on the left."""
        prod = torch.eye(2, dtype=z.dtype, device=z.device).repeat(n, 1, 1)
        for s in range(length):
            m = walks(s)
            prod[:m] = mats[:m, s] @ prod[:m]
        return prod

    def carry(maps, off, first):
        """Each chunk's start: first, then x <- M x + o over the chunks."""
        starts = [first]
        for m, o in zip(maps, off):
            starts.append(starts[-1] @ m.T + o)
        return torch.stack(starts)

    x_filt = torch.empty((t_len, channels, 2), dtype=z.dtype, device=z.device)
    x_filt[0, :, 0] = x_filt[0, :, 1] = z[0]
    steps = (1 + base[:, None] + torch.arange(length, device=z.device)).clamp(max=t_len - 1)  # (n, L)
    if n > 1:
        off = z.new_zeros((2, n, channels))
        filter_walk(off[0], off[1])
        a, b, kk1 = 1 - k0[steps, 0].to(z.dtype), 1 - k1[steps, 0].to(z.dtype), k1[steps, 0].to(z.dtype)
        mats = torch.stack((torch.stack((a, a), -1), torch.stack((-kk1, b), -1)), -2)
        starts = carry(transfer(mats)[:-1], off.permute(1, 2, 0)[:-1], x_filt[0])
    else:
        starts = x_filt[0][None]
    filter_walk(starts[..., 0].clone(), starts[..., 1].clone(), x_filt)

    out = torch.empty_like(z)
    out[t_len - 1] = x_filt[t_len - 1, :, 0]
    if n > 1:
        off = z.new_zeros((2, n, channels))
        smoother_walk(off[0], off[1], x_filt)
        backward = (top[:, None] - 1 - torch.arange(length, device=z.device)).clamp(min=0)  # (n, L)
        mats = cg[backward, :, 0].to(z.dtype).view(n, length, 2, 2)
        ends = carry(transfer(mats).flip(0)[:-1], off.permute(1, 2, 0).flip(0)[:-1], x_filt[t_len - 1]).flip(0)
    else:
        ends = x_filt[t_len - 1][None]
    smoother_walk(ends[..., 0].clone(), ends[..., 1].clone(), x_filt, out)
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
    plan = kalman_rts_config(t_len, channels)
    work = torch.empty(plan["scratch_floats"], dtype=torch.float32, device=z.device)
    at = {name: work.data_ptr() + 4 * offset for name, offset in plan["layout"].items()}
    launch = cuda_build.load("kalman_rts").kalman_rts_launch
    with torch.cuda.device(z.device):
        err = launch(z.data_ptr(), out.data_ptr(), at["cov"], at["gains"], at["maps"], at["x_filt"], at["off"],
                     at["start"], at["period"], t_len, channels, plan["chunk"],
                     torch.cuda.current_stream(z.device).cuda_stream)
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
