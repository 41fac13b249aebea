"""Fused masked GRU layer with flax GRUCell math: optional LayerNorm of the
input rows, the input projection ``x W_i + b_i`` and the recurrence, for one
or two directions in one launch.

Port of the TPU kernel ``deepof_tpu/ops/pallas_gru.py`` ``gru_scan_pallas``
(:55, ``pallas_call`` at :100), whose input projection (:91) sits in the
same function outside the Pallas body; here it runs inside the kernel. The
optional LayerNorm is flax's (ddof 0, eps inside the root), so the
RecurrentBlock's LayerNorm_0 folds into the second BiGRU.

On a CUDA tensor the wrapper launches ``csrc/gru_scan.cu`` or raises; on a
CPU tensor it runs the plain version below (LayerNorm, one matmul per
direction, then a Python loop over T: prefix lengths can be 0, which
``pack_padded_sequence`` rejects, and the gates are flax's, not
``nn.GRU``'s). There is no fallback from a CUDA tensor.

Bound on an H100 at the serving widths ((F, H) = (16, 16) and (32, 8)):
FP32 operations of the projections.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from deepof_tpu_torch.ops import cuda_build

MAX_HIDDEN = 128

# (gamma (F,), beta (F,), eps): the LayerNorm applied to each input row.
Norm = Tuple[torch.Tensor, torch.Tensor, float]


def gru_scan_plain(
    x: torch.Tensor,
    mask: torch.Tensor,
    wi: torch.Tensor,
    bi: torch.Tensor,
    wh: torch.Tensor,
    bhn: torch.Tensor,
    reverse: Sequence[bool],
    norm: Optional[Norm] = None,
    outputs: bool = True,
) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Loop over T per direction; same arguments and results as :func:`gru_scan`."""
    b, t, f = x.shape
    d, h = bhn.shape
    if norm is not None:
        x = F.layer_norm(x, (f,), norm[0], norm[1], norm[2])
    x2 = x.reshape(b * t, f)
    outs = x.new_zeros((b, t, d, h))
    finals = []
    for k in range(d):
        xg = torch.addmm(bi[k], x2, wi[k]).reshape(b, t, 3 * h)
        carry = x.new_zeros((b, h))
        for s in (range(t - 1, -1, -1) if reverse[k] else range(t)):
            g = xg[:, s]
            hg = carry @ wh[k]
            r = torch.sigmoid(g[:, :h] + hg[:, :h])
            z = torch.sigmoid(g[:, h:2 * h] + hg[:, h:2 * h])
            n = torch.tanh(g[:, 2 * h:] + r * (hg[:, 2 * h:] + bhn[k]))
            new = (1.0 - z) * n + z * carry
            m = mask[:, s, None]
            carry = torch.where(m, new, carry)
            outs[:, s, k] = torch.where(m, new, 0.0)
        finals.append(carry)
    return (outs.reshape(b, t, d * h) if outputs else None), torch.cat(finals, dim=-1)


def _check(x, mask, wi, bi, wh, bhn, reverse, norm):
    if x.ndim != 3:
        raise ValueError(f"x must be (B, T, F), got {tuple(x.shape)}")
    b, t, f = x.shape
    if wh.ndim != 3 or wh.shape[-1] != 3 * wh.shape[1]:
        raise ValueError(f"wh must be (D, H, 3H), got {tuple(wh.shape)}")
    d, h, h3 = wh.shape
    if d not in (1, 2) or len(reverse) != d:
        raise ValueError(f"{d} directions with reverse={tuple(reverse)}: need 1 or 2, one flag each")
    if not 1 <= h <= MAX_HIDDEN:
        raise ValueError(f"hidden size {h} outside [1, {MAX_HIDDEN}]")
    if mask.shape != (b, t) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be bool ({b}, {t}), got {mask.dtype} {tuple(mask.shape)}")
    if wi.shape != (d, f, h3) or bi.shape != (d, h3) or bhn.shape != (d, h):
        raise ValueError(
            f"wi must be ({d}, {f}, {h3}), bi ({d}, {h3}) and bhn ({d}, {h}); got "
            f"{tuple(wi.shape)}, {tuple(bi.shape)}, {tuple(bhn.shape)}"
        )
    params = [wi, bi, wh, bhn]
    if norm is not None:
        if len(norm) != 3 or norm[0].shape != (f,) or norm[1].shape != (f,):
            raise ValueError(f"norm must be (gamma ({f},), beta ({f},), eps)")
        params += [norm[0], norm[1]]
    for v in [mask, *params]:
        if v.device != x.device:
            raise ValueError("x, mask, the weights and the norm must share one device")
    if any(v.dtype != x.dtype for v in params):
        raise ValueError("x, the weights and the norm must share one dtype")


def gru_scan(
    x: torch.Tensor,
    mask: torch.Tensor,
    wi: torch.Tensor,
    bi: torch.Tensor,
    wh: torch.Tensor,
    bhn: torch.Tensor,
    reverse: Sequence[bool] = (False,),
    norm: Optional[Norm] = None,
    outputs: bool = True,
) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Masked GRU layer over T for D = 1 or 2 directions.

    Args:
        x: (B, T, F) inputs.
        mask: (B, T) bool; a False step keeps the carry and outputs 0.
        wi: (D, F, 3H) input kernels [W_ir | W_iz | W_in]; bi: (D, 3H).
        wh: (D, H, 3H) recurrent kernels [W_hr | W_hz | W_hn].
        bhn: (D, H) candidate-gate recurrent bias.
        reverse: per direction, whether it walks T backwards.
        norm: optional (gamma (F,), beta (F,), eps): each row of ``x`` is
            LayerNorm'ed (flax semantics) before the projection.
        outputs: when False, only the final carries are computed and the
            per-step outputs are never written.

    Returns:
        (outputs (B, T, D*H) or None, final carries (B, D*H)), directions
        concatenated.
    """
    _check(x, mask, wi, bi, wh, bhn, reverse, norm)
    if x.device.type == "cpu":
        return gru_scan_plain(x, mask, wi, bi, wh, bhn, reverse, norm, outputs)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"the CUDA kernel takes float32, got {x.dtype}")
    tensors = [x, mask, wi, bi, wh, bhn] + ([norm[0], norm[1]] if norm is not None else [])
    if not all(v.is_contiguous() for v in tensors):
        raise ValueError("x, mask, the weights and the norm must be contiguous")

    b, t, f = x.shape
    d, h = bhn.shape
    out = torch.empty((b, t, d * h), device=x.device, dtype=torch.float32) if outputs else None
    fin = torch.empty((b, d * h), device=x.device, dtype=torch.float32)
    if b == 0 or t == 0:
        return (out.zero_() if outputs else None), fin.zero_()
    launch = cuda_build.load("gru_scan").gru_scan_launch
    launch.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_float] + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    launch.restype = ctypes.c_int
    rev_mask = sum(1 << k for k, r in enumerate(reverse) if r)
    gamma, beta, eps = (norm[0].data_ptr(), norm[1].data_ptr(), float(norm[2])) if norm is not None else (None, None, 0.0)
    with torch.cuda.device(x.device):
        err = launch(
            x.data_ptr(), mask.data_ptr(), wi.data_ptr(), bi.data_ptr(), wh.data_ptr(),
            bhn.data_ptr(), gamma, beta, eps, out.data_ptr() if outputs else None,
            fin.data_ptr(), b, t, f, h, d, rev_mask,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"gru_scan launch failed with CUDA error {err} (B={b}, T={t}, F={f}, H={h}, D={d})")
    gru_scan.launches += 1
    return out, fin


# Kernel launches since the last reset (set to 0 to reset).
gru_scan.launches = 0


def gru_scan_config(t: int, f: int, h: int, d: int, outputs: bool = True, norm: bool = False) -> dict:
    """The launch ``gru_scan`` makes on the current CUDA device for this shape:
    weight route ("registers", with x and the outputs staged in shared
    memory, or "L1", with them in global memory), streams and threads per
    CTA, shared memory per CTA, CTAs resident per SM."""
    fn = cuda_build.load("gru_scan").gru_scan_config
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    info = (ctypes.c_int * 5)()
    err = fn(t, f, h, d, int(outputs), int(norm), ctypes.cast(info, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"gru_scan_config failed with CUDA error {err}")
    route, s, threads, smem, per_sm = info
    return {"route": "registers" if route else "L1", "streams_per_cta": s,
            "threads": threads, "smem_bytes": smem, "ctas_per_sm": per_sm}
