"""The chunked parallel-in-time formulation of the Kalman filter and RTS
smoother that ``csrc/kalman_rts.cu`` runs on the card, stated here in plain
torch (``kalman_rts_chunked_plain``) and held against the serial chain on
the CPU; and the gains filled from the covariance chain's period.

Given the gains, a filter step is the affine map x <- A_t x + k_t z_t and a
smoother step x <- C_t x + (x_f - C_t F x_f). Each pass cuts its T - 1
steps into chunks of L, walks every chunk from a zero start for its
offset, forms each chunk's transfer matrix, carries the chunk starts, then
reruns every chunk from its start with the serial step: the kernel's
launches, with the chunks batched as tensors.

Held, at chunk lengths 1, 7, 64, T (and 1,000, where the chunk products
underflow to zero), at T 1, 2, 27-30 (inside the ~30-step transient of the
covariances), a chunk - 1, a chunk and a chunk + 1 of steps, and 5,000, at
C 1 and 33:
- against the serial chain in float64 from the same float32 gains
  (``kalman_rts_plain`` on a float64 ``z``) at 1e-10 of max(1, |value|);
- against ``kalman_rts_plain`` in float32 at the card's bar (chip_smoke.py's
  KALMAN_TOL, 1e-5 of max(1, |value|)), and bit for bit where the pass is
  one chunk (the serial chain);
- against the JAX package's ``kalman_rts_smooth`` at T 3,000 in float32 at
  KALMAN_TOL.
The gains: ``kalman_gains`` (the chain to its first exact repeat, the rest
copied from the period) equal to the chain run to T (kept here) bit for bit
at T 5,000 and 45,000, and the repeat found where the full chain has it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepof_tpu.ops import imputation as jimp

from deepof_tpu_torch.ops import kalman_kernels
from deepof_tpu_torch.ops.kalman_kernels import (_P0, _Q, _R, _fma, kalman_gains, kalman_gains_period,
                                                 kalman_rts_chunked_plain, kalman_rts_config, kalman_rts_plain)

from test_torch_encoders import one_torch_thread  # noqa: F401 (an autouse fixture of this module too)

KALMAN_TOL = 1e-5  # chip_smoke.py's bar for kalman_rts against kalman_rts_plain on the card
F64_TOL = 1e-10
T_LONG = 5_000
T_JAX = 3_000
SHORT = (1, 2, 27, 28, 29, 30, 7, 8, 9, 64, 65, 66)  # the transient; chunk - 1, chunk, chunk + 1 steps at 7 and 64
CHANNELS = (1, 33)


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):  # noqa: F811
    yield


def _walk(t, c, seed=0):
    """tests/test_torch_imputation.py's kind of track: a random walk of 2 px
    steps around 300 px with 1 px jitter, each channel its own."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(t, c)).cumsum(axis=0) * 2.0 + 300.0 + rng.normal(size=(t, c))).astype(np.float32)


def _rel_err(got, want):
    return float(((got.double() - want.double()).abs() / want.double().abs().clamp(min=1.0)).max())


@pytest.fixture(scope="module")
def long_case():
    """z (T_LONG, 33) and the serial chain's outputs in float32 and float64."""
    z = torch.from_numpy(_walk(T_LONG, 33))
    return z, kalman_rts_plain(z), kalman_rts_plain(z.double())


@pytest.mark.parametrize("chunk", [1, 7, 64, 1_000, T_LONG])
def test_chunked_matches_serial(long_case, chunk):
    """T 5,000: the formulation against the serial chain, float64 and
    float32; chunk 1,000's transfer matrices underflow to zero (0.674^1000)
    and change nothing."""
    z, want32, want64 = long_case
    got64 = kalman_rts_chunked_plain(z.double(), chunk)
    assert got64.dtype == torch.float64 and torch.isfinite(got64).all()
    assert _rel_err(got64, want64) <= F64_TOL
    got32 = kalman_rts_chunked_plain(z, chunk)
    assert got32.dtype == torch.float32 and torch.isfinite(got32).all()
    assert _rel_err(got32, want32) <= KALMAN_TOL
    if chunk >= T_LONG - 1:
        assert torch.equal(got32, want32)  # one chunk: the serial chain


@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("t", SHORT)
def test_chunked_short_and_chunk_edges(t, c):
    """Short tracks, inside the covariances' transient and around a chunk's
    length, at every chunk length: float64 at 1e-10, float32 at KALMAN_TOL,
    one chunk bit for bit."""
    z = torch.from_numpy(_walk(t, c, seed=t))
    want32, want64 = kalman_rts_plain(z), kalman_rts_plain(z.double())
    for chunk in (1, 7, 64, t):
        got64, got32 = kalman_rts_chunked_plain(z.double(), chunk), kalman_rts_chunked_plain(z, chunk)
        assert got32.shape == z.shape and torch.isfinite(got32).all()
        assert _rel_err(got64, want64) <= F64_TOL, chunk
        assert _rel_err(got32, want32) <= KALMAN_TOL, chunk
        if chunk >= t - 1:
            assert torch.equal(got32, want32), chunk


@pytest.fixture(scope="module")
def jax_case():
    """z (T_JAX, 34), 17 bodyparts' x and y, and the JAX package's smoothed
    positions (its lax.scans, jitted once)."""
    z = _walk(T_JAX, 34, seed=3)
    want = np.array(jax.jit(jimp.kalman_rts_smooth)(jnp.asarray(z.reshape(T_JAX, 17, 2))))
    return z, want.reshape(T_JAX, 34)


@pytest.mark.parametrize("chunk", [7, kalman_rts_config(T_JAX, 34)["chunk"]])
def test_chunked_matches_jax(jax_case, chunk):
    """The formulation in float32 against the JAX package's
    kalman_rts_smooth at T 3,000 (the kernel's own chunk length, 64, and
    7)."""
    z, want = jax_case
    got = kalman_rts_chunked_plain(torch.from_numpy(z), chunk)
    assert _rel_err(got, torch.from_numpy(want)) <= KALMAN_TOL


def _full_chain_gains(t_len):
    """The gains by the covariance chain run to T, and its filter
    covariances (T, 4) as float32 bits: the plain version before the period
    fill."""
    f32 = np.float32
    q00, q01, q11 = _Q[0, 0], _Q[0, 1], _Q[1, 1]
    out = np.zeros((max(t_len, 1), 8), np.float32)
    states = np.zeros((max(t_len, 1), 4), np.float32)
    f00, f01, f10, f11 = _P0, f32(0.0), f32(0.0), _P0
    states[0] = (f00, f01, f10, f11)
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
        states[t] = (f00, f01, f10, f11)
    return out, states.view(np.uint32)


@pytest.mark.parametrize("t_len", [T_LONG, 45_000])
def test_gains_from_the_period_equal_the_full_chain(t_len):
    """kalman_gains equals the chain run to T bit for bit, and its repeat is
    the full chain's first: the first step whose filter covariance has the
    bits of one of the HISTORY before it (on this model step 28 repeats step
    26, and the chain has period 2 from there on)."""
    want, states = _full_chain_gains(t_len)
    got, first, lag = kalman_gains_period(t_len)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(kalman_gains(t_len).view(np.uint32), want.view(np.uint32))
    repeat = next(t for t in range(1, t_len) for lag_ in range(1, kalman_kernels.HISTORY + 1)
                  if t >= lag_ and (states[t] == states[t - lag_]).all())
    lags = [g for g in range(1, kalman_kernels.HISTORY + 1) if (states[repeat] == states[repeat - g]).all()]
    assert (first + lag, lag) == (repeat, lags[0]) == (28, 2)
    assert (np.tile(states[first:first + lag], (-(-t_len // lag), 1))[:t_len - first] == states[first:]).all()


def test_gains_without_a_repeat():
    """Tracks shorter than the transient: no repeat, the chain runs to T."""
    for t_len in (1, 2, 28):
        got, first, lag = kalman_gains_period(t_len)
        assert (first, lag) == (t_len, 0)
        np.testing.assert_array_equal(got.view(np.uint32), _full_chain_gains(t_len)[0].view(np.uint32))


def test_kalman_rts_config():
    """The plan: L = max(64, ceil(sqrt((T - 1) / 5))) capped at 2,048 and T - 1, n chunks,
    eight launches (four with one chunk), an aligned workspace."""
    cases = {1: (1, 1), 2: (1, 1), 29: (28, 1), 65: (64, 1), 66: (64, 2), 130: (64, 3), 45_000: (95, 474),
             180_000: (190, 948), 5_000_000: (1000, 5000), 100_000_000: (2048, 48829)}
    for t, (chunk, chunks) in cases.items():
        plan = kalman_rts_config(t, 28)
        assert (plan["chunk"], plan["chunks"]) == (chunk, chunks), t
        assert chunk * (chunks - 1) < max(t - 1, 1) <= chunk * chunks
        assert len(plan["launches"]) == (8 if chunks > 1 else 4)
        lay = plan["layout"]
        assert all(lay[k] % 4 == 0 for k in ("cov", "gains", "maps")) and all(
            lay[k] % 2 == 0 for k in ("x_filt", "off", "start"))
        assert plan["scratch_floats"] == lay["period"] + 4
        assert lay["x_filt"] - lay["maps"] == 8 * chunks and lay["off"] - lay["x_filt"] == 2 * t * 28
    assert kalman_rts_config(45_000, 28, chunk=64)["chunks"] == 704  # a chunk length set for measurements
