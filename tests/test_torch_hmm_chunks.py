"""The chunked parallel-in-time formulation of the HMM recursions that
``csrc/hmm_scan.cu`` runs on the card, stated here in plain torch and held
against the sequential recursions on the CPU.

Both recursions are log-semiring products with the matrices M_t[i, j] =
log_a[i, j] + log_b[t, j], t = 1..T-1. The frames' T - 1 matrices fall into
chunks of L; the formulation forms each chunk's transfer matrix (its rows
max-normalised before every step, the offsets summed apart), carries the
start vectors over the chunks (alpha forward, beta backward), then reruns
each chunk's frames from its start with the sequential recursion: the
kernel's three launches, with the chunks batched as tensors (the last
chunk padded with log-semiring identities, which change nothing).

Held, at K 3 and 10, T 3,000 and chunk lengths 1, 7, 64 and T:
- against ``hmm_scan_plain`` in float64 at 1e-10 and in float32 at the
  card's bar (chip_smoke.py's HMM_TOL, 1e-5 of max(1, |value|));
- through the frame-wise posteriors (``forward_backward`` with its
  recursions from the formulation) against the JAX package's
  ``_forward_backward``, jitted and vmapped as tests/test_torch_softcounts.py
  runs it, at that file's tolerances, both in float64: at 3,000 float32
  frames the JAX package's float32 posteriors drift from any float32
  implementation's, the sequential ``hmm_scan_plain``'s included, past
  those tolerances.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepof_tpu import msm as jmsm

from deepof_tpu_torch.ops import hmm_kernels
from deepof_tpu_torch.ops.hmm_kernels import forward_backward, hmm_scan_plain

from test_torch_encoders import one_torch_thread  # noqa: F401 (an autouse fixture of this module too)

T = 3_000
N = 2
STATES = (3, 10)
CHUNKS = (1, 7, 64, T)
HMM_TOL = 1e-5  # chip_smoke.py's bar for hmm_scan against hmm_scan_plain on the card
F64_TOL = 1e-10
# tests/test_torch_softcounts.py's bars for the posteriors against the JAX package's.
GAMMA_TOL, XI_JAX_RTOL, LL_RTOL = 5e-5, 1e-3, 1e-6


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):  # noqa: F811
    yield


def _hmm_inputs(rng, n, t, k):
    """tests/test_torch_softcounts.py's draws: emissions of -5 +- 3 nats, a
    diagonal-heavy transition matrix."""
    log_b = (rng.normal(size=(n, t, k)) * 3 - 5).astype(np.float32)
    a = rng.random((k, k)) + np.eye(k) * k
    pi = rng.random(k)
    return log_b, np.log(pi / pi.sum()).astype(np.float32), np.log(a / a.sum(1, keepdims=True)).astype(np.float32)


def _shift(v, dim):
    """The kernel's max shift: the max over ``dim``, 0 where it is not finite."""
    m = v.amax(dim, keepdim=True)
    return torch.where(torch.isfinite(m), m, torch.zeros_like(m))


def chunked_scan(log_b, log_pi, log_a, chunk):
    """(log_alpha, log_beta) of N sequences by the chunked scan with
    ``chunk`` matrices a chunk."""
    n, t, k = log_b.shape
    steps = t - 1
    length = max(1, min(chunk, steps))
    c_n = max(1, math.ceil(steps / length))
    # The matrices of each chunk, (N, C, L, K, K); past T - 1 the identity.
    eye = torch.full((k, k), -math.inf, dtype=log_b.dtype).fill_diagonal_(0.0)
    idx = 1 + torch.arange(c_n * length).view(c_n, length)
    valid = idx < t
    lb = log_b[:, idx.clamp(max=t - 1)]  # (N, C, L, K)
    mats = torch.where(valid[None, :, :, None, None], log_a + lb[..., None, :], eye)

    # Pass 1: the transfer matrices, rows normalised before every step.
    rows = eye.expand(n, c_n, k, k)
    off = log_b.new_zeros((n, c_n, k))
    for s in range(length):
        m = _shift(rows, -1)
        off = off + m[..., 0]
        rows = torch.logsumexp((rows - m)[..., :, :, None] + mats[:, :, s, None], dim=-2)
    m = _shift(rows, -1)
    pn, off = rows - m, off + m[..., 0]

    # Pass 2: start vectors alpha_{cL} and end vectors beta_{min(cL+L, T-1)}.
    start = [log_pi + log_b[:, 0]]
    for c in range(c_n - 1):
        w = start[-1] + off[:, c]
        start.append(torch.logsumexp(w[:, :, None] + pn[:, c], dim=1))
    end = [log_b.new_zeros((n, k))]
    for c in range(c_n - 1, 0, -1):
        end.append(off[:, c] + torch.logsumexp(pn[:, c] + end[-1][:, None, :], dim=2))
    start = torch.stack(start, 1)           # (N, C, K)
    end = torch.stack(end[::-1], 1)         # (N, C, K): chunk c's end vector

    # Pass 3: each chunk's frames from its start, the sequential recursion.
    alpha = torch.empty_like(log_b)
    beta = torch.empty_like(log_b)
    alpha[:, 0] = start[:, 0]
    beta[:, t - 1] = 0.0
    base = torch.arange(c_n) * length
    top = (base + length).clamp(max=t - 1)
    fa, fb = start, end
    for s in range(length):
        ta = base + 1 + s                   # frame of the forward step
        ok_a = ta < t
        ta = ta.clamp(max=t - 1)
        fa = torch.where(ok_a[None, :, None],
                         log_b[:, ta] + torch.logsumexp(fa[..., :, None] + log_a, dim=-2), fa)
        alpha[:, ta[ok_a]] = fa[:, ok_a]
        tb = top - 1 - s                    # frame of the backward step
        ok_b = tb >= base
        tb = tb.clamp(min=0)
        fb = torch.where(ok_b[None, :, None],
                         torch.logsumexp(log_a + (log_b[:, (tb + 1).clamp(max=t - 1)] + fb)[..., None, :], dim=-1),
                         fb)
        beta[:, tb[ok_b]] = fb[:, ok_b]
    return alpha, beta


@pytest.fixture(scope="module")
def cases():
    """{K: (float32 inputs, the JAX package's (gamma, xi_sum, ll) from them
    in float64)}."""
    fb = jax.jit(jax.vmap(jmsm._forward_backward, in_axes=(0, None, None)))
    out = {}
    for k in STATES:
        args = _hmm_inputs(np.random.default_rng(k), N, T, k)
        want = fb(*(jnp.asarray(v.astype(np.float64)) for v in args))
        assert want[0].dtype == jnp.float64
        out[k] = args, tuple(np.asarray(v) for v in want)
    return out


def _rel_err(got, want):
    return float(((got - want).abs() / want.abs().clamp(min=1.0)).max())


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("k", STATES)
def test_chunked_scan_matches_sequential(cases, k, chunk):
    """The formulation against hmm_scan_plain, in float64 and float32."""
    args = [torch.as_tensor(v) for v in cases[k][0]]
    for dtype, tol in ((torch.float64, F64_TOL), (torch.float32, HMM_TOL)):
        a = [v.to(dtype) for v in args]
        got, want = chunked_scan(*a, chunk), hmm_scan_plain(*a)
        for g, w in zip(got, want):
            assert g.dtype == dtype and torch.isfinite(g).all()
            err = _rel_err(g, w)
            assert err <= tol, (dtype, err)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("k", STATES)
def test_chunked_posteriors_match_jax(cases, k, chunk, monkeypatch):
    """gamma, xi_sum and the log-likelihood from the formulation's
    recursions, through forward_backward's frame-wise normalisation,
    against the JAX package's _forward_backward, sequence by sequence."""
    (log_b, log_pi, log_a), (jg, jx, jl) = cases[k]
    monkeypatch.setattr(hmm_kernels, "hmm_scan", lambda *a: chunked_scan(*a, chunk))
    gamma, xi, ll = forward_backward(*(torch.as_tensor(v).double() for v in (log_b, log_pi, log_a)))
    for i in range(N):
        np.testing.assert_allclose(gamma[i].numpy(), jg[i], rtol=0, atol=GAMMA_TOL)
        scale = max(1.0, float(np.abs(jx[i]).max()))
        assert float(np.abs(xi[i].numpy() - jx[i]).max()) <= XI_JAX_RTOL * scale
        np.testing.assert_allclose(float(ll[i]), float(jl[i]), rtol=LL_RTOL)


def test_chunk_padding_and_single_frames():
    """T = 1 and 2, a chunk longer than the sequence and a ragged last
    chunk: the formulation equals hmm_scan_plain in float64."""
    rng = np.random.default_rng(1)
    for t, chunk in ((1, 1), (2, 1), (2, 5), (10, 4), (11, 3)):
        args = [torch.as_tensor(v).double() for v in _hmm_inputs(rng, 3, t, 4)]
        for g, w in zip(chunked_scan(*args, chunk), hmm_scan_plain(*args)):
            torch.testing.assert_close(g, w, rtol=0, atol=F64_TOL)
