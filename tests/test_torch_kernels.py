"""The port's two kernel wrappers on the CPU: their plain versions against
the JAX package's Pallas kernels (interpret mode, as the JAX package's own
tests run them) and reference paths, plus the wrappers' input checks.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
each against its plain version there.

Bars: windows rtol 1e-6 (float32; the kernel multiplies by 1/sd where the
XLA oracle divides, one rounding apart); GRU atol 1e-6 (float32, as
tests/test_pallas.py holds the Pallas GRU to the scan).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepof_tpu.models.blocks import MaskedGRU as JaxMaskedGRU
from deepof_tpu.ops.pallas_kernels import (
    window_gather_standardize as jax_window_gather,
    window_gather_standardize_xla,
)

from deepof_tpu_torch.ops.gru_kernels import gru_scan, gru_scan_plain
from deepof_tpu_torch.ops.window_kernels import (
    window_gather_standardize,
    window_gather_standardize_plain,
)
from deepof_tpu_torch.weights import from_flax_params


@pytest.mark.parametrize("t,f,window,block", [(301, 12, 25, 128), (97, 117, 8, 32)])
def test_window_plain_matches_pallas_and_xla(t, f, window, block):
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(t, f)).astype(np.float32)
    mu = rng.normal(size=f).astype(np.float32)
    sd = (np.abs(rng.normal(size=f)) + 0.5).astype(np.float32)

    got = window_gather_standardize(torch.as_tensor(feats), torch.as_tensor(mu), torch.as_tensor(sd), window)
    assert got.shape == (t - window + 1, window, f)
    pallas = jax_window_gather(jnp.asarray(feats), jnp.asarray(mu), jnp.asarray(sd), window, block=block, interpret=True)
    xla = window_gather_standardize_xla(jnp.asarray(feats), jnp.asarray(mu), jnp.asarray(sd), window)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=1e-6, atol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), rtol=1e-6, atol=0)


def test_window_wrapper_checks_and_cpu_dispatch():
    feats = torch.zeros(10, 4)
    ones = torch.ones(4)
    before = window_gather_standardize.launches
    out = window_gather_standardize(feats, ones * 0, ones, 3)
    assert window_gather_standardize.launches == before  # the plain version ran
    torch.testing.assert_close(out, window_gather_standardize_plain(feats, ones * 0, ones, 3))
    with pytest.raises(ValueError):
        window_gather_standardize(feats, ones[:3], ones, 3)
    with pytest.raises(ValueError):
        window_gather_standardize(feats, ones, ones, 11)
    with pytest.raises(ValueError):
        window_gather_standardize(feats[0], ones, ones, 1)
    with pytest.raises(ValueError):
        window_gather_standardize(feats, ones.double(), ones, 3)


def _gru_params(rng, f, h):
    p = {g: {"kernel": rng.normal(scale=0.5, size=(f, h)).astype(np.float32),
             "bias": rng.normal(scale=0.2, size=h).astype(np.float32)} for g in ("ir", "iz", "in")}
    p.update({g: {"kernel": rng.normal(scale=0.5, size=(h, h)).astype(np.float32)} for g in ("hr", "hz")})
    p["hn"] = {"kernel": rng.normal(scale=0.5, size=(h, h)).astype(np.float32),
               "bias": rng.normal(scale=0.2, size=h).astype(np.float32)}
    return p


def _prefix_mask(rng, b, t):
    lengths = rng.integers(0, t + 1, b)
    lengths[0], lengths[1] = 0, t  # always cover the empty and the full prefix
    return np.arange(t)[None] < lengths[:, None]


@pytest.mark.parametrize("h,reverse", [(8, False), (16, True)])
def test_gru_plain_matches_pallas_and_masked_scan(h, reverse, monkeypatch):
    rng = np.random.default_rng(3 + h)
    b, t, f = 7, 9, 5
    x = rng.normal(size=(b, t, f)).astype(np.float32)
    mask = _prefix_mask(rng, b, t)
    cell = _gru_params(rng, f, h)

    st = from_flax_params({"GRUCell_0": cell}, kind="MaskedGRU")
    xg = (torch.as_tensor(x).reshape(b * t, f) @ st["wi"] + st["bi"]).reshape(b, t, 1, 3 * h)
    out, fin = gru_scan(xg, torch.as_tensor(mask), st["wh"][None], st["bhn"][None], (reverse,))

    module = JaxMaskedGRU(h, reverse=reverse)
    variables = {"params": {"GRUCell_0": jax.tree_util.tree_map(jnp.asarray, cell)}}
    monkeypatch.setenv("DEEPOF_TPU_GRU_PALLAS", "0")
    s_out, s_fin = module.apply(variables, jnp.asarray(x), jnp.asarray(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(s_out), atol=1e-6, rtol=0)
    np.testing.assert_allclose(fin.numpy(), np.asarray(s_fin), atol=1e-6, rtol=0)
    # The JAX module's Pallas branch (gru_scan_pallas in interpret mode off
    # the TPU), switched on by its environment variable.
    monkeypatch.setenv("DEEPOF_TPU_GRU_PALLAS", "1")
    e_out, e_fin = module.apply(variables, jnp.asarray(x), jnp.asarray(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(e_out), atol=1e-6, rtol=0)
    np.testing.assert_allclose(fin.numpy(), np.asarray(e_fin), atol=1e-6, rtol=0)


def test_gru_two_directions_equal_two_single_launches():
    rng = np.random.default_rng(11)
    b, t, h = 6, 7, 4
    xg = torch.as_tensor(rng.normal(size=(b, t, 2, 3 * h)).astype(np.float32))
    mask = torch.as_tensor(_prefix_mask(rng, b, t))
    wh = torch.as_tensor(rng.normal(scale=0.5, size=(2, h, 3 * h)).astype(np.float32))
    bhn = torch.as_tensor(rng.normal(size=(2, h)).astype(np.float32))
    out, fin = gru_scan(xg, mask, wh, bhn, (False, True))
    f_out, f_fin = gru_scan(xg[:, :, :1].contiguous(), mask, wh[:1], bhn[:1], (False,))
    b_out, b_fin = gru_scan(xg[:, :, 1:].contiguous(), mask, wh[1:], bhn[1:], (True,))
    torch.testing.assert_close(out, torch.cat([f_out, b_out], -1), rtol=0, atol=0)
    torch.testing.assert_close(fin, torch.cat([f_fin, b_fin], -1), rtol=0, atol=0)
    # A zero-length prefix keeps the zero carry and writes zeros.
    assert torch.all(out[0] == 0) and torch.all(fin[0] == 0)


def test_gru_wrapper_checks():
    xg = torch.zeros(2, 3, 1, 12)
    mask = torch.ones(2, 3, dtype=torch.bool)
    wh, bhn = torch.zeros(1, 4, 12), torch.zeros(1, 4)
    before = gru_scan.launches
    gru_scan(xg, mask, wh, bhn, (False,))
    assert gru_scan.launches == before
    with pytest.raises(ValueError):
        gru_scan(xg, mask.float(), wh, bhn, (False,))
    with pytest.raises(ValueError):
        gru_scan(xg, mask, wh, bhn, (False, True))
    with pytest.raises(ValueError):
        gru_scan(xg[..., :11], mask, wh, bhn, (False,))
    with pytest.raises(ValueError):
        gru_scan(torch.zeros(2, 3, 1, 3 * 129), mask, torch.zeros(1, 129, 387), torch.zeros(1, 129), (False,))
    torch.testing.assert_close(gru_scan(xg, mask, wh, bhn, (True,)), gru_scan_plain(xg, mask, wh, bhn, (True,)))
