"""Log-space forward and backward recursions of a hidden Markov model, and
the forward-backward's posteriors formed from them.

No TPU kernel is replaced: the JAX package runs the recursions as two
``lax.scan``s over frames (``deepof_tpu/msm.py:39-78``,
``_forward_backward``), vmapped over sequences. PyTorch runs eagerly, so a
loop over frames would launch a handful of operators for every one of the
T steps; on a CUDA tensor :func:`hmm_scan` launches ``csrc/hmm_scan.cu``
instead (a chunked parallel-in-time scan: the chunks' transfer matrices in
parallel, the start vectors carried over the chunks, then each chunk's
frames rerun from its start; lane j holding state j, K <= 32; one chunk,
the serial chain, where N and K make the chunk products cost more than
the chain), or raises.
On a CPU tensor it runs :func:`hmm_scan_plain`, the sequential loop over T
batched over the sequences. There is no fallback from a CUDA tensor.

:func:`forward_backward` forms the state posteriors, the transition
posteriors summed over frames (a logsumexp over t) and the log-likelihood
from the two recursions with the JAX formulas (``msm.py:62-77``), each
frame normalised on its own (the reason is in its docstring), in plain
tensor ops.

Bound on an H100: neither bytes nor operations; the scan's chains of
dependent log-sum-exps, ~sqrt(8T) steps in all (the note in the source).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from deepof_tpu_torch.ops import cuda_build

MAX_STATES = 32


def hmm_scan_plain(log_b: torch.Tensor, log_pi: torch.Tensor, log_a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two recursions as loops over T, batched over N; the arguments
    and results of :func:`hmm_scan`."""
    n, t, k = log_b.shape
    alpha = torch.empty_like(log_b)
    beta = torch.empty_like(log_b)
    if t == 0:
        return alpha, beta
    la = log_pi + log_b[:, 0]
    alpha[:, 0] = la
    for s in range(1, t):
        la = log_b[:, s] + torch.logsumexp(la[:, :, None] + log_a, dim=1)
        alpha[:, s] = la
    lbeta = log_b.new_zeros((n, k))
    beta[:, t - 1] = lbeta
    for s in range(t - 2, -1, -1):
        lbeta = torch.logsumexp(log_a + (log_b[:, s + 1] + lbeta)[:, None, :], dim=2)
        beta[:, s] = lbeta
    return alpha, beta


def _check(log_b, log_pi, log_a):
    if log_b.ndim != 3:
        raise ValueError(f"log_b must be (N, T, K), got {tuple(log_b.shape)}")
    k = log_b.shape[2]
    if log_pi.shape != (k,) or log_a.shape != (k, k):
        raise ValueError(f"log_pi must be ({k},) and log_a ({k}, {k}); got {tuple(log_pi.shape)}, "
                         f"{tuple(log_a.shape)}")
    if log_pi.device != log_b.device or log_a.device != log_b.device:
        raise ValueError("log_b, log_pi and log_a must share one device")
    if log_pi.dtype != log_b.dtype or log_a.dtype != log_b.dtype:
        raise ValueError("log_b, log_pi and log_a must share one dtype")


def _launch(log_b, log_pi, log_a):
    if log_b.dtype != torch.float32:
        raise TypeError(f"the CUDA kernel takes float32, got {log_b.dtype}")
    n, t, k = log_b.shape
    if not 1 <= k <= MAX_STATES:
        raise ValueError(f"the CUDA kernel takes 1 to {MAX_STATES} states, got {k}")
    if not (log_b.is_contiguous() and log_pi.is_contiguous() and log_a.is_contiguous()):
        raise ValueError("log_b, log_pi and log_a must be contiguous")
    alpha = torch.empty_like(log_b)
    beta = torch.empty_like(log_b)
    if n == 0 or t == 0:
        return alpha, beta
    with torch.cuda.device(log_b.device):
        scratch = torch.empty(hmm_scan_config(n, t, k)["scratch_floats"], device=log_b.device, dtype=torch.float32)
        err = cuda_build.load("hmm_scan").hmm_scan_launch(
            log_b.data_ptr(), log_pi.data_ptr(), log_a.data_ptr(), alpha.data_ptr(), beta.data_ptr(),
            scratch.data_ptr(), n, t, k, torch.cuda.current_stream(log_b.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"hmm_scan launch failed with CUDA error {err} (N={n}, T={t}, K={k})")
    return alpha, beta


@functools.lru_cache(maxsize=64)
def _plan(n: int, t: int, k: int, device: int) -> Tuple[int, int, int]:
    info = (ctypes.c_longlong * 3)()
    err = cuda_build.load("hmm_scan").hmm_scan_config(n, t, k, ctypes.cast(info, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"hmm_scan_config failed with CUDA error {err} (N={n}, T={t}, K={k})")
    return tuple(info)


def hmm_scan_config(n: int, t: int, k: int) -> dict:
    """The scan :func:`hmm_scan` runs on the current CUDA device for N
    sequences of T frames and K states: the chunk length L and the chunks
    C of the frames' T - 1 transfer matrices (C = 1, the serial chain,
    where N and K make the chunk products the dearer route), the scratch it
    allocates, and its three launches (chunk products, carry, reruns)."""
    chunk, chunks, scratch = _plan(n, t, k, torch.cuda.current_device())
    return {"chunk": chunk, "chunks": chunks, "scratch_floats": scratch,
            "launches": ["hmm_chunk_products", "hmm_chunk_carry", "hmm_chunk_rerun"]}


def hmm_scan(log_b: torch.Tensor, log_pi: torch.Tensor, log_a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Log-space forward and backward variables of N sequences.

    Args:
        log_b: (N, T, K) log emission densities; float32 and contiguous on
            the card, K <= ``MAX_STATES``.
        log_pi: (K,) log initial distribution.
        log_a: (K, K) log transition matrix, rows the state left.

    Returns:
        (log_alpha, log_beta), each (N, T, K).
    """
    _check(log_b, log_pi, log_a)
    if log_b.device.type == "cpu":
        return hmm_scan_plain(log_b, log_pi, log_a)
    if log_b.device.type != "cuda":
        raise ValueError(f"unsupported device {log_b.device}")
    out = _launch(log_b, log_pi, log_a)
    if log_b.shape[0] and log_b.shape[1]:
        hmm_scan.launches += 1
    return out


# Kernel launches since the last reset (set to 0 to reset).
hmm_scan.launches = 0


def forward_backward(log_b: torch.Tensor, log_pi: torch.Tensor, log_a: torch.Tensor,
                     with_xi: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """(gamma (N, T, K), xi_sum (N, K, K) or None, log-likelihood (N,)) of
    N sequences of T >= 1 frames: ``deepof_tpu/msm.py`` ``_forward_backward``
    vmapped, its recursions through :func:`hmm_scan`.

    gamma and each frame's xi are normalised frame by frame (a softmax over
    the states, over the state pairs): the JAX package's formulas
    ``exp(log_alpha + log_beta - ll)`` renormalised, and ``exp(log_xi)``,
    where ``ll`` is the global log-likelihood. Over tens of thousands of
    float32 frames the forward and the backward recursions round apart by
    up to ~100 nats, so that ``log_alpha + log_beta - ll`` exceeds float32's
    exp range and the JAX formulas give inf / inf = NaN; the frame-wise
    normalisation gives the same values wherever those are finite."""
    log_alpha, log_beta = hmm_scan(log_b, log_pi, log_a)
    ll = torch.logsumexp(log_alpha[:, -1], dim=-1)
    gamma = torch.softmax(log_alpha + log_beta - ll[:, None, None], dim=-1)
    if not with_xi:
        return gamma, None, ll
    log_xi = (log_alpha[:, :-1, :, None] + log_a + (log_b[:, 1:] + log_beta[:, 1:])[:, :, None, :]
              - ll[:, None, None, None])
    log_xi = log_xi - torch.logsumexp(log_xi.flatten(2), dim=2)[:, :, None, None]
    return gamma, torch.exp(torch.logsumexp(log_xi, dim=1)), ll
