"""The port's two kernel wrappers on the CPU: their plain versions against
the JAX package's Pallas kernels (interpret mode, as the JAX package's own
tests run them) and reference paths, plus the wrappers' input checks.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
each against its plain version there.

Bars: windows rtol 1e-6 (float32; the kernel multiplies by 1/sd where the
XLA oracle divides, one rounding apart), the encoder streams of
``window_streams`` too, against the JAX package's composition (the Pallas
window kernel in interpret mode, ``jnp.take`` of the node and edge columns,
the three-slice ``jnp.stack`` and ``tf_style_group_reshape``); GRU atol 1e-6 (float32, as
tests/test_pallas.py holds the Pallas GRU to the scan), the LayerNorm'd
GRU included (a two-pass variance against flax's E[x^2] - E[x]^2 differs
by ~1e-7 at eps 1e-3).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import flax.linen as fnn

from deepof_tpu.models.blocks import BiGRU as JaxBiGRU
from deepof_tpu.models.blocks import tf_style_group_reshape as jax_group_reshape
from deepof_tpu.models.blocks import MaskedGRU as JaxMaskedGRU
from deepof_tpu.ops.pallas_gru import gru_scan_pallas
from deepof_tpu.ops.pallas_kernels import (
    window_gather_standardize as jax_window_gather,
    window_gather_standardize_xla,
)

from deepof_tpu_torch.ops.gru_kernels import gru_scan, gru_scan_plain
from deepof_tpu_torch.core.graph import build_body_graph, connect_mouse
from deepof_tpu_torch.data import merged_feature_layout
from deepof_tpu_torch.ops.window_kernels import (
    MAX_TABLES,
    window_gather_standardize,
    window_gather_standardize_plain,
    window_streams,
    window_streams_plain,
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


def _deepof14_layout():
    """Node and edge columns of the merged frame of two deepof_14 animals."""
    ids = ["B", "W"]
    graph = build_body_graph(sorted(f"{a}_{bp}" for a in ids for bp in connect_mouse().nodes), ids)
    columns = merged_feature_layout(graph, ids, include_angles=False)[0]
    nodes = list(graph.nodes)
    node_cols = [(bp, "x") for bp in nodes] + [(bp, "y") for bp in nodes] + nodes
    node = [columns.index(c) for c in node_cols]
    edge = [columns.index(c) for c in sorted(graph.edge_names)]
    return len(columns), np.array(node), np.array(edge)


@pytest.mark.parametrize("t,f,window,block,layout", [
    (301, 12, 25, 128, "random"), (97, 117, 8, 32, "random"), (60, 116, 25, 32, "deepof14"),
])
def test_window_streams_plain_matches_jax_composition(t, f, window, block, layout):
    rng = np.random.default_rng(t)
    if layout == "deepof14":
        f_layout, node, edge = _deepof14_layout()
        assert f_layout == f and len(node) == 3 * 28 and len(edge) == 32
    else:
        node = rng.permutation(f)[:3 * (f // 4)]
        edge = rng.integers(0, f, size=f // 3)
    n_nodes = len(node) // 3
    feats = rng.normal(size=(t, f)).astype(np.float32)
    mu = rng.normal(size=f).astype(np.float32)
    sd = (np.abs(rng.normal(size=f)) + 0.5).astype(np.float32)

    # The JAX package's windows -> encoder streams (inference.py:173-186,
    # encoders.py:69-70), with its Pallas window kernel in interpret mode.
    w = jax_window_gather(jnp.asarray(feats), jnp.asarray(mu), jnp.asarray(sd), window, block=block, interpret=True)
    xf = jnp.take(w, jnp.asarray(node), axis=2)
    xw = jnp.stack([xf[..., :n_nodes], xf[..., n_nodes:2 * n_nodes], xf[..., 2 * n_nodes:]], axis=-1)
    aw = jnp.take(w, jnp.asarray(edge), axis=2)[..., None]
    n = t - window + 1
    want_x = jax_group_reshape(xw).reshape(n * n_nodes, window, 3)
    want_a = jax_group_reshape(aw).reshape(n * len(edge), window, 1)

    tables = [node.reshape(3, -1).T, edge[:, None]]
    args = (torch.as_tensor(feats), tables, torch.as_tensor(mu), torch.as_tensor(sd), window)
    before = window_streams.launches
    for got_x, got_a in (window_streams_plain(*args), window_streams(*args)):
        assert got_x.shape == (n * n_nodes, window, 3) and got_a.shape == (n * len(edge), window, 1)
        np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=1e-6, atol=0)
        np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=1e-6, atol=0)
    assert window_streams.launches == before  # CPU tensors: the plain version ran


def test_window_streams_identity_and_repeated_columns():
    rng = np.random.default_rng(7)
    feats = torch.as_tensor(rng.normal(size=(40, 5)).astype(np.float32))
    mu = torch.as_tensor(rng.normal(size=5).astype(np.float32))
    sd = torch.as_tensor((rng.random(5) + 0.5).astype(np.float32))
    # The single table 0..F-1 is the (n, W, F) window gather.
    (ident,) = window_streams(feats, [np.arange(5)[None]], mu, sd, 6)
    assert torch.equal(ident, window_gather_standardize_plain(feats, mu, sd, 6))
    # k = 2 with a repeated column, beside a k = 1 table, lists and tensors.
    pair, single = window_streams(feats, [[[4, 4], [0, 2]], torch.tensor([[3]])], mu, sd, 6)
    assert pair.shape == (35 * 2, 6, 2) and single.shape == (35, 6, 1)
    assert torch.equal(pair[0::2, :, 0], pair[0::2, :, 1])
    assert torch.equal(pair[0::2, :, 0], ident[:, :, 4])
    assert torch.equal(pair[1::2], ident[:, :, [0, 2]])
    assert torch.equal(single[:, :, 0], ident[:, :, 3])


def test_window_streams_wrapper_checks():
    feats = torch.zeros(10, 4)
    zeros, ones = torch.zeros(4), torch.ones(4)
    table = np.array([[0, 1, 2]])
    with pytest.raises(ValueError):  # a column out of range
        window_streams(feats, [np.array([[0, 4]])], zeros, ones, 3)
    with pytest.raises(ValueError):
        window_streams(feats, [np.array([[-1]])], zeros, ones, 3)
    with pytest.raises(TypeError):  # a float table
        window_streams(feats, [table.astype(np.float32)], zeros, ones, 3)
    with pytest.raises(ValueError):  # a table on a device
        window_streams(feats, [torch.tensor(table, device="meta")], zeros, ones, 3)
    with pytest.raises(ValueError):  # mu on a foreign device
        window_streams(feats, [table], torch.zeros(4, device="meta"), ones, 3)
    with pytest.raises(ValueError):  # rows on a device the kernel does not take
        window_streams(torch.zeros(10, 4, device="meta"), [table], zeros.to("meta"), ones.to("meta"), 3)
    with pytest.raises(ValueError):
        window_streams(feats, [table[0]], zeros, ones, 3)
    with pytest.raises(ValueError):
        window_streams(feats, [table] * (MAX_TABLES + 1), zeros, ones, 3)
    with pytest.raises(ValueError):
        window_streams(feats, [], zeros, ones, 3)
    with pytest.raises(ValueError):
        window_streams(feats[0], [table], zeros, ones, 1)
    with pytest.raises(ValueError):
        window_streams(feats, [table], zeros, ones, 11)
    before = window_streams.launches
    (out,) = window_streams(feats + 1.0, [table], zeros, ones * 2.0, 3)
    assert window_streams.launches == before  # the plain version ran
    assert out.shape == (8, 3, 3) and torch.all(out == 0.5)


def _gru_params(rng, f, h):
    # Weights of scale 0.5 at the serving widths; 1/sqrt(H)-like above, so
    # that wide pre-activations stay O(1) as trained weights keep them.
    sc = min(0.5, 2.0 / h ** 0.5)
    p = {g: {"kernel": rng.normal(scale=sc, size=(f, h)).astype(np.float32),
             "bias": rng.normal(scale=0.2, size=h).astype(np.float32)} for g in ("ir", "iz", "in")}
    p.update({g: {"kernel": rng.normal(scale=sc, size=(h, h)).astype(np.float32)} for g in ("hr", "hz")})
    p["hn"] = {"kernel": rng.normal(scale=sc, size=(h, h)).astype(np.float32),
               "bias": rng.normal(scale=0.2, size=h).astype(np.float32)}
    return p


def _prefix_mask(rng, b, t):
    lengths = rng.integers(0, t + 1, b)
    lengths[0], lengths[1] = 0, t  # always cover the empty and the full prefix
    return np.arange(t)[None] < lengths[:, None]


def _stacked(cells):
    """flax GRUCell trees, one per direction -> (wi, bi, wh, bhn) stacked over D."""
    st = [from_flax_params({"GRUCell_0": c}, kind="MaskedGRU") for c in cells]
    return tuple(torch.stack([s[k] for s in st]) for k in ("wi", "bi", "wh", "bhn"))


def _random_gru(rng, b, t, f, h, d):
    x = torch.as_tensor(rng.normal(size=(b, t, f)).astype(np.float32))
    mask = torch.as_tensor(_prefix_mask(rng, b, t))
    return x, mask, _stacked([_gru_params(rng, f, h) for _ in range(d)])


@pytest.mark.parametrize("h", [8, 16, 128])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_plain_matches_pallas_and_masked_scan(h, reverse, monkeypatch):
    rng = np.random.default_rng(3 + h)
    b, t, f = 7, 9, 5
    x = rng.normal(size=(b, t, f)).astype(np.float32)
    mask = _prefix_mask(rng, b, t)
    cell = _gru_params(rng, f, h)

    out, fin = gru_scan(torch.as_tensor(x), torch.as_tensor(mask), *_stacked([cell]), (reverse,))

    # The TPU kernel itself, in interpret mode, on the same x and cell; it
    # scans forward, so the reverse direction is the flip, scan, flip.
    flip = (lambda a: a[:, ::-1]) if reverse else (lambda a: a)
    p_out, p_fin = gru_scan_pallas(jnp.asarray(flip(x)), jnp.asarray(flip(mask)),
                                   jax.tree_util.tree_map(jnp.asarray, cell), interpret=True)
    np.testing.assert_allclose(out.numpy(), flip(np.asarray(p_out)), atol=1e-6, rtol=0)
    np.testing.assert_allclose(fin.numpy(), np.asarray(p_fin), atol=1e-6, rtol=0)

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


@pytest.mark.parametrize("f,h", [(32, 8), (6, 5)])
def test_gru_norm_matches_flax_layernorm_then_bigru(f, h):
    rng = np.random.default_rng(20 + f)
    b, t = 8, 7
    x = rng.normal(loc=0.5, scale=2.0, size=(b, t, f)).astype(np.float32)
    mask = _prefix_mask(rng, b, t)
    x[~mask] = 0.0  # masked rows are zeros, which the LayerNorm maps to beta
    gamma = rng.normal(loc=1.0, scale=0.3, size=f).astype(np.float32)
    beta = rng.normal(scale=0.3, size=f).astype(np.float32)
    cells = [_gru_params(rng, f, h) for _ in range(2)]

    out, fin = gru_scan(torch.as_tensor(x), torch.as_tensor(mask), *_stacked(cells), (False, True),
                        norm=(torch.as_tensor(gamma), torch.as_tensor(beta), 1e-3))

    y = fnn.LayerNorm(epsilon=1e-3).apply(
        {"params": {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)}}, jnp.asarray(x))
    params = {f"MaskedGRU_{k}": {"GRUCell_0": jax.tree_util.tree_map(jnp.asarray, c)} for k, c in enumerate(cells)}
    w_out, w_fin = JaxBiGRU(h).apply({"params": params}, y, jnp.asarray(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(w_out), atol=1e-6, rtol=0)
    np.testing.assert_allclose(fin.numpy(), np.asarray(w_fin), atol=1e-6, rtol=0)
    assert torch.all(out[0] == 0) and torch.all(fin[0] == 0)  # prefix length 0


def test_gru_two_directions_equal_two_single_launches():
    rng = np.random.default_rng(11)
    x, mask, (wi, bi, wh, bhn) = _random_gru(rng, 6, 7, 3, 4, 2)
    out, fin = gru_scan(x, mask, wi, bi, wh, bhn, (False, True))
    f_out, f_fin = gru_scan(x, mask, wi[:1], bi[:1], wh[:1], bhn[:1], (False,))
    b_out, b_fin = gru_scan(x, mask, wi[1:], bi[1:], wh[1:], bhn[1:], (True,))
    torch.testing.assert_close(out, torch.cat([f_out, b_out], -1), rtol=0, atol=0)
    torch.testing.assert_close(fin, torch.cat([f_fin, b_fin], -1), rtol=0, atol=0)
    # A zero-length prefix keeps the zero carry and writes zeros.
    assert torch.all(out[0] == 0) and torch.all(fin[0] == 0)


@pytest.mark.parametrize("with_norm", [False, True])
def test_gru_final_only_equals_finals_with_outputs(with_norm):
    rng = np.random.default_rng(12)
    x, mask, w = _random_gru(rng, 5, 6, 4, 3, 2)
    norm = (torch.linspace(0.5, 1.5, 4), torch.linspace(-0.2, 0.2, 4), 1e-3) if with_norm else None
    out, fin = gru_scan(x, mask, *w, (False, True), norm=norm)
    none, fin_only = gru_scan(x, mask, *w, (False, True), norm=norm, outputs=False)
    assert out.shape == (5, 6, 6) and none is None
    torch.testing.assert_close(fin_only, fin, rtol=0, atol=0)


def test_gru_wrapper_checks():
    rng = np.random.default_rng(13)
    x, mask, (wi, bi, wh, bhn) = _random_gru(rng, 2, 3, 5, 4, 1)
    norm = (torch.ones(5), torch.zeros(5), 1e-3)
    before = gru_scan.launches
    gru_scan(x, mask, wi, bi, wh, bhn, (False,), norm=norm)
    assert gru_scan.launches == before  # the plain version ran
    with pytest.raises(ValueError):
        gru_scan(x, mask.float(), wi, bi, wh, bhn, (False,))
    with pytest.raises(ValueError):
        gru_scan(x, mask, wi, bi, wh, bhn, (False, True))
    with pytest.raises(ValueError):  # wi's F is not x's
        gru_scan(x, mask, wi[:, :4], bi, wh, bhn, (False,))
    with pytest.raises(ValueError):  # wi's 3H is not wh's
        gru_scan(x, mask, wi[..., :9], bi, wh, bhn, (False,))
    with pytest.raises(ValueError):
        gru_scan(x, mask, wi, bi[:, :11], wh, bhn, (False,))
    with pytest.raises(ValueError):
        gru_scan(x, mask, wi, bi, wh, bhn, (False,), norm=(torch.ones(4), torch.zeros(5), 1e-3))
    with pytest.raises(ValueError):
        gru_scan(x, mask, wi, bi, wh, bhn, (False,), norm=(torch.ones(5), torch.zeros(6), 1e-3))
    with pytest.raises(ValueError):
        gru_scan(x, mask, wi, bi, wh, bhn, (False,), norm=(torch.ones(5, dtype=torch.float64), torch.zeros(5), 1e-3))
    with pytest.raises(ValueError):
        gru_scan(x, mask, torch.zeros(1, 5, 387), torch.zeros(1, 387), torch.zeros(1, 129, 387),
                 torch.zeros(1, 129), (False,))
    got = gru_scan(x, mask, wi, bi, wh, bhn, (True,), norm=norm)
    want = gru_scan_plain(x, mask, wi, bi, wh, bhn, (True,), norm)
    torch.testing.assert_close(got, want)
