"""Fused masked GRU layer with flax GRUCell math: optional LayerNorm of the
input rows, the input projection ``x W_i + b_i`` and the recurrence, for one
or two directions in one launch, and its backward for training.

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

Training. The JAX package's Pallas GRU has no VJP (JAX trains through flax
``nn.scan`` and lets XLA differentiate it), so the backward is this port's
own: ``GRULayerFunction``, whose forward launches the forward kernel with
the carry store on (each step's starting carry, (B, T, D, H)) and whose
backward launches ``csrc/gru_scan_bwd.cu`` (``gru_scan_backward``), which
forms the input, weight and bias gradients itself: the gate gradients never
leave the kernel, and no matrix product follows it. On a CUDA
tensor ``gru_scan`` takes it whenever grad mode is on and x or a weight
requires grad; with a LayerNorm it then runs ``F.layer_norm`` in front of
an un-normed launch, which autograd differentiates (the fused norm stays on
the serving launch). On the CPU the plain loop is differentiated by
autograd.

Bound on an H100 at the serving widths ((F, H) = (16, 16) and (32, 8)):
FP32 operations of the projections. The backward kernel's note is in its
source.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from deepof_tpu_torch.ops import cuda_build

MAX_HIDDEN = 128

# (gamma (F,), beta (F,), eps): the LayerNorm applied to each input row.
Norm = Tuple[torch.Tensor, torch.Tensor, float]


def _plain_scan(x, mask, wi, bi, wh, bhn, reverse):
    """The masked recurrence over un-normed rows: (outputs (B, T, D, H),
    final carries (B, D*H), the carry each step starts from (B, T, D, H))."""
    b, t, f = x.shape
    d, h = bhn.shape
    x2 = x.reshape(b * t, f)
    outs = x.new_zeros((b, t, d, h))
    carries = x.new_zeros((b, t, d, h))
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
            carries[:, s, k] = carry
            carry = torch.where(m, new, carry)
            outs[:, s, k] = torch.where(m, new, 0.0)
        finals.append(carry)
    return outs, torch.cat(finals, dim=-1), carries


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
    if norm is not None:
        x = F.layer_norm(x, (f,), norm[0], norm[1], norm[2])
    outs, finals, _ = _plain_scan(x, mask, wi, bi, wh, bhn, reverse)
    return (outs.reshape(b, t, -1) if outputs else None), finals


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


def _check_cuda(tensors) -> None:
    if tensors[0].dtype != torch.float32:
        raise TypeError(f"the CUDA kernels take float32, got {tensors[0].dtype}")
    if not all(v.is_contiguous() for v in tensors):
        raise ValueError("x, mask, the weights, the norm and the carries must be contiguous")


def _launch_forward(x, mask, wi, bi, wh, bhn, reverse, norm, outputs, carries):
    """One launch of ``csrc/gru_scan.cu``: (outputs (B, T, D*H) or None,
    finals (B, D*H), the carry each step starts from (B, T, D, H) where
    ``carries``, else None)."""
    tensors = [x, mask, wi, bi, wh, bhn] + ([norm[0], norm[1]] if norm is not None else [])
    _check_cuda(tensors)
    b, t, f = x.shape
    d, h = bhn.shape
    out = torch.empty((b, t, d * h), device=x.device, dtype=torch.float32) if outputs else None
    fin = torch.empty((b, d * h), device=x.device, dtype=torch.float32)
    hs = torch.empty((b, t, d, h), device=x.device, dtype=torch.float32) if carries else None
    if b == 0 or t == 0:
        return (out.zero_() if outputs else None), fin.zero_(), (hs.zero_() if carries else None)
    launch = cuda_build.load("gru_scan").gru_scan_launch
    rev_mask = sum(1 << k for k, r in enumerate(reverse) if r)
    gamma, beta, eps = (norm[0].data_ptr(), norm[1].data_ptr(), float(norm[2])) if norm is not None else (None, None, 0.0)
    with torch.cuda.device(x.device):
        err = launch(
            x.data_ptr(), mask.data_ptr(), wi.data_ptr(), bi.data_ptr(), wh.data_ptr(),
            bhn.data_ptr(), gamma, beta, eps, out.data_ptr() if outputs else None,
            fin.data_ptr(), hs.data_ptr() if carries else None, b, t, f, h, d, rev_mask,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"gru_scan launch failed with CUDA error {err} (B={b}, T={t}, F={f}, H={h}, D={d})")
    gru_scan.launches += 1
    return out, fin, hs


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
        concatenated. On a CUDA tensor with grad mode on and x, a weight or
        the norm requiring grad, both come from :class:`GRULayerFunction`
        and carry its ``grad_fn``: no call returns a CUDA output without
        one while its inputs require grad.
    """
    _check(x, mask, wi, bi, wh, bhn, reverse, norm)
    if x.device.type == "cpu":
        return gru_scan_plain(x, mask, wi, bi, wh, bhn, reverse, norm, outputs)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    params = [x, wi, bi, wh, bhn] + ([norm[0], norm[1]] if norm is not None else [])
    if torch.is_grad_enabled() and any(v.requires_grad for v in params):
        if norm is not None:
            x = F.layer_norm(x, (x.shape[-1],), norm[0], norm[1], norm[2])
        out, fin = GRULayerFunction.apply(x, mask, wi, bi, wh, bhn, tuple(reverse), outputs)
        return (out if outputs else None), fin
    out, fin, _ = _launch_forward(x, mask, wi, bi, wh, bhn, reverse, norm, outputs, carries=False)
    return out, fin


# Kernel launches since the last reset (set to 0 to reset): serving and
# training launches of the forward kernel.
gru_scan.launches = 0


def gru_scan_carries(x, mask, wi, bi, wh, bhn, reverse, outputs=True):
    """The forward of a training step, no LayerNorm: (outputs (B, T, D*H) or
    None, finals (B, D*H), the carry each step starts from (B, T, D, H)),
    which :func:`gru_scan_backward` reads. One launch of the forward kernel
    with its carry store on a CUDA tensor, the plain loop on the CPU."""
    _check(x, mask, wi, bi, wh, bhn, reverse, None)
    if x.device.type == "cpu":
        outs, fin, hs = _plain_scan(x, mask, wi, bi, wh, bhn, reverse)
        return (outs.reshape(x.shape[0], x.shape[1], -1) if outputs else None), fin, hs
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _launch_forward(x, mask, wi, bi, wh, bhn, reverse, None, outputs, carries=True)


def gru_gate_grads_plain(x, mask, wi, bi, wh, bhn, reverse, hs, d_out=None, d_fin=None):
    """The gate pre-activation gradients of the un-normed layer, as a loop
    over T from the carries ``hs``: (dG (B, T, D, 3H) = [da_r | da_z | da_n],
    the gradients of x W_i + b_i; dHn (B, T, D, H), of h W_hn + b_hn). Both
    are 0 at masked steps. The backward kernel forms them in shared memory
    and never writes them; this helper is the plain version's first half."""
    b, t, f = x.shape
    d, h = bhn.shape
    dg = x.new_zeros((b, t, d, 3 * h))
    dhn = x.new_zeros((b, t, d, h))
    dout = None if d_out is None else d_out.reshape(b, t, d, h)
    x2 = x.reshape(b * t, f)
    for k in range(d):
        xg = torch.addmm(bi[k], x2, wi[k]).reshape(b, t, 3 * h)
        dh = x.new_zeros((b, h)) if d_fin is None else d_fin.reshape(b, d, h)[:, k]
        # The direction's processing order, walked backwards.
        for s in (range(t) if reverse[k] else range(t - 1, -1, -1)):
            hp = hs[:, s, k]
            g = xg[:, s]
            hg = hp @ wh[k]
            r = torch.sigmoid(g[:, :h] + hg[:, :h])
            z = torch.sigmoid(g[:, h:2 * h] + hg[:, h:2 * h])
            hn = hg[:, 2 * h:] + bhn[k]
            n = torch.tanh(g[:, 2 * h:] + r * hn)
            dht = dh if dout is None else dh + dout[:, s, k]
            m = mask[:, s, None]
            dan = torch.where(m, dht * (1.0 - z) * (1.0 - n * n), 0.0)
            dar = dan * hn * r * (1.0 - r)
            daz = torch.where(m, dht * (hp - n) * z * (1.0 - z), 0.0)
            dhs = dan * r
            dg[:, s, k] = torch.cat([dar, daz, dan], dim=-1)
            dhn[:, s, k] = dhs
            dh = torch.where(m, z * dht + torch.cat([dar, daz, dhs], dim=-1) @ wh[k].T, dh)
    return dg, dhn


def gru_scan_backward_plain(x, mask, wi, bi, wh, bhn, reverse, hs, d_out=None, d_fin=None):
    """The gate gradients (:func:`gru_gate_grads_plain`), then the layer's
    gradients as sums over all stream-steps: dx = sum_d dG_d W_i,d^T,
    dW_i = x^T dG, db_i = sum dG, dW_h = h^T [dG_r | dG_z | dHn],
    db_hn = sum dHn. Same arguments and results as :func:`gru_scan_backward`."""
    h = bhn.shape[1]
    dg, dhn = gru_gate_grads_plain(x, mask, wi, bi, wh, bhn, reverse, hs, d_out, d_fin)
    dx = torch.einsum("btdc,dfc->btf", dg, wi)
    dwi = torch.einsum("btf,btdc->dfc", x, dg)
    dwh = torch.einsum("btdk,btdc->dkc", hs, torch.cat([dg[..., :2 * h], dhn], dim=-1))
    return dx, dwi, dg.sum((0, 1)), dwh, dhn.sum((0, 1))


_BwdPlan = collections.namedtuple(
    "_BwdPlan", "streams threads smem per_sm grid steps chunks scratch serial staged")


@functools.lru_cache(maxsize=64)
def _bwd_plan(b, t, f, h, d, device):
    """gru_scan_bwd_config's numbers for a shape on CUDA device ``device``
    (the current one)."""
    info = (ctypes.c_longlong * 10)()
    err = cuda_build.load("gru_scan_bwd").gru_scan_bwd_config(b, t, f, h, d, ctypes.cast(info, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"gru_scan_bwd_config failed with CUDA error {err} (B={b}, T={t}, F={f}, H={h}, D={d})")
    return _BwdPlan(*info)


def gru_scan_backward(
    x: torch.Tensor,
    mask: torch.Tensor,
    wi: torch.Tensor,
    bi: torch.Tensor,
    wh: torch.Tensor,
    bhn: torch.Tensor,
    reverse: Sequence[bool],
    hs: torch.Tensor,
    d_out: Optional[torch.Tensor] = None,
    d_fin: Optional[torch.Tensor] = None,
):
    """Gradients of the un-normed GRU layer from the carries its forward stored.

    Args:
        x, mask, wi, bi, wh, bhn, reverse: as in :func:`gru_scan` (x un-normed).
        hs: (B, T, D, H) the carry each step started from
            (:func:`gru_scan_carries`).
        d_out: (B, T, D*H) gradient of the outputs, or None (final-only
            layers; zero).
        d_fin: (B, D*H) gradient of the final carries, or None (zero).

    Returns:
        (dx (B, T, F), dW_i (D, F, 3H), db_i (D, 3H), dW_h (D, H, 3H),
        db_hn (D, H)). On a CUDA tensor ``csrc/gru_scan_bwd.cu`` computes
        them all (two launches, after a transposed copy of W_h where the
        weights do not fit the kernel's shared memory), and the same inputs
        give the same bits.
    """
    _check(x, mask, wi, bi, wh, bhn, reverse, None)
    b, t, f = x.shape
    d, h = bhn.shape
    if hs.shape != (b, t, d, h):
        raise ValueError(f"hs must be ({b}, {t}, {d}, {h}), got {tuple(hs.shape)}")
    if d_out is not None and d_out.shape != (b, t, d * h):
        raise ValueError(f"d_out must be ({b}, {t}, {d * h}), got {tuple(d_out.shape)}")
    if d_fin is not None and d_fin.shape != (b, d * h):
        raise ValueError(f"d_fin must be ({b}, {d * h}), got {tuple(d_fin.shape)}")
    if any(v is not None and v.device != x.device for v in (hs, d_out, d_fin)):
        raise ValueError("the carries and the gradients must lie on x's device")
    if x.device.type == "cpu":
        return gru_scan_backward_plain(x, mask, wi, bi, wh, bhn, reverse, hs, d_out, d_fin)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    d_out = None if d_out is None else d_out.contiguous()
    d_fin = None if d_fin is None else d_fin.contiguous()
    _check_cuda([x, mask, wi, bi, wh, bhn, hs] + [v for v in (d_out, d_fin) if v is not None])
    dx = torch.empty((b, t, f), device=x.device, dtype=torch.float32)
    n_wi, n_bi, n_wh = d * f * 3 * h, d * 3 * h, d * h * 3 * h
    wout = torch.empty(n_wi + n_bi + n_wh + d * h, device=x.device, dtype=torch.float32)
    if b == 0 or t == 0:
        dx.zero_()
        wout.zero_()
    else:
        with torch.cuda.device(x.device):
            plan = _bwd_plan(b, t, f, h, d, torch.cuda.current_device())
            scratch = torch.empty(plan.scratch, device=x.device, dtype=torch.float32)
            rev_mask = sum(1 << k for k, r in enumerate(reverse) if r)
            # Where the weights do not fit the kernel's shared memory, it reads
            # rows of W_h as columns of this copy.
            wht = None if plan.staged else wh.transpose(1, 2).contiguous()
            err = cuda_build.load("gru_scan_bwd").gru_scan_bwd_launch(
                x.data_ptr(), mask.data_ptr(), wi.data_ptr(), bi.data_ptr(), wh.data_ptr(),
                None if wht is None else wht.data_ptr(), bhn.data_ptr(), hs.data_ptr(),
                None if d_out is None else d_out.data_ptr(), None if d_fin is None else d_fin.data_ptr(),
                dx.data_ptr(), wout.data_ptr(), scratch.data_ptr(),
                b, t, f, h, d, rev_mask, torch.cuda.current_stream(x.device).cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"gru_scan_backward launch failed with CUDA error {err} (B={b}, T={t}, H={h}, D={d})")
        gru_scan_backward.launches += 1
    dwi, dbi, dwh, dbhn = torch.split(wout, [n_wi, n_bi, n_wh, d * h])
    return dx, dwi.view(d, f, 3 * h), dbi.view(d, 3 * h), dwh.view(d, h, 3 * h), dbhn.view(d, h)


# Backward kernel launches since the last reset (set to 0 to reset).
gru_scan_backward.launches = 0


class GRULayerFunction(torch.autograd.Function):
    """The un-normed GRU layer as an autograd node: forward through
    :func:`gru_scan_carries` (the carries saved for the backward), backward
    through :func:`gru_scan_backward`. The kernels on a CUDA tensor, the
    plain versions on the CPU.

    ``apply(x, mask, wi, bi, wh, bhn, reverse, outputs)`` -> (outputs
    (B, T, D*H), an empty tensor where ``outputs`` is False; finals (B, D*H)).
    """

    @staticmethod
    def forward(ctx, x, mask, wi, bi, wh, bhn, reverse, outputs):
        out, fin, hs = gru_scan_carries(x, mask, wi, bi, wh, bhn, reverse, outputs)
        ctx.save_for_backward(x, mask, wi, bi, wh, bhn, hs)
        ctx.reverse = reverse
        ctx.set_materialize_grads(False)
        if out is None:
            out = x.new_empty(0)
            ctx.mark_non_differentiable(out)
        return out, fin

    @staticmethod
    def backward(ctx, d_out, d_fin):
        x, mask, wi, bi, wh, bhn, hs = ctx.saved_tensors
        if d_out is not None and d_out.numel() == 0:
            d_out = None
        if d_out is None and d_fin is None:
            return (None,) * 8
        dx, dwi, dbi, dwh, dbhn = gru_scan_backward(x, mask, wi, bi, wh, bhn, ctx.reverse, hs, d_out, d_fin)
        return dx, None, dwi, dbi, dwh, dbhn, None, None


def gru_scan_config(t: int, f: int, h: int, d: int, outputs: bool = True, norm: bool = False) -> dict:
    """The launch ``gru_scan`` makes on the current CUDA device for this shape:
    weight route ("registers", with x and the outputs staged in shared
    memory, or "L1", with them in global memory), streams and threads per
    CTA, shared memory per CTA, CTAs resident per SM."""
    fn = cuda_build.load("gru_scan").gru_scan_config
    info = (ctypes.c_int * 5)()
    err = fn(t, f, h, d, int(outputs), int(norm), ctypes.cast(info, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"gru_scan_config failed with CUDA error {err}")
    route, s, threads, smem, per_sm = info
    return {"route": "registers" if route else "L1", "streams_per_cta": s,
            "threads": threads, "smem_bytes": smem, "ctas_per_sm": per_sm}


def gru_scan_bwd_config(b: int, t: int, f: int, h: int, d: int) -> dict:
    """The launches ``gru_scan_backward`` makes on the current CUDA device for
    this shape: streams, serial threads and threads per CTA, shared memory
    per CTA, CTAs resident per SM, CTAs launched, walk steps a chunk and
    chunks a walk, where the weights are read from and their gradients
    accumulate ("shared" memory, or "global": W_h transposed and the CTA's
    partial), the scratch bytes, and the launches of a call: the W_h
    transpose (where the weights are read from global memory), the kernel
    and its reduction; no matrix product, no gate-gradient tensor."""
    pl = _bwd_plan(b, t, f, h, d, torch.cuda.current_device())
    return {"streams_per_cta": pl.streams, "serial_threads": pl.serial, "threads": pl.threads,
            "smem_bytes": pl.smem, "ctas_per_sm": pl.per_sm, "grid": pl.grid, "steps_per_chunk": pl.steps,
            "chunks": pl.chunks, "weights": "shared" if pl.staged else "global", "scratch_bytes": 4 * pl.scratch,
            "launches": ([] if pl.staged else ["wh.transpose(1, 2).contiguous()"]) + ["gru_bwd_kernel", "gru_bwd_reduce"]}
