"""Parity of the port's graph, preprocess, kinematics and scaling ops with
the JAX package, in float64 on the CPU.

Inputs are made with numpy from a seed and fed to both packages. Bar:
max |diff| <= 1e-8 with equal NaN patterns (the JAX package's own bar
against upstream deepof for float64 preprocess and kinematics).
"""

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

from deepof_tpu.core import graph as jgraph
from deepof_tpu.ops import interp as jinterp
from deepof_tpu.ops import kinematics as jkin
from deepof_tpu.ops import outliers as jout
from deepof_tpu.ops import scaling as jscale
from deepof_tpu.ops import smoothing as jsmooth

from deepof_tpu_torch.core import graph as pgraph
from deepof_tpu_torch.ops import interp as pinterp
from deepof_tpu_torch.ops import kinematics as pkin
from deepof_tpu_torch.ops import outliers as pout
from deepof_tpu_torch.ops import scaling as pscale
from deepof_tpu_torch.ops import smoothing as psmooth

TOL = 1e-8


def close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol, equal_nan=True)


def t64(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def _bodyparts(ids, preset):
    base = jgraph.connect_mouse(graph_preset=preset).nodes
    return sorted(f"{a}_{bp}" if a else bp for a in ids for bp in base)


@pytest.mark.parametrize("ids", [None, ["B"], ["B", "W"], ["A", "B", "C"]])
@pytest.mark.parametrize("preset", ["deepof_14", "deepof_11", "deepof_8"])
@pytest.mark.parametrize("exclude", [None, ["Tail_1"]])
def test_body_graph_matches_networkx(ids, preset, exclude):
    gj = jgraph.connect_mouse(ids, exclude, preset)
    gp = pgraph.connect_mouse(ids, exclude, preset)
    assert list(gj.nodes) == gp.nodes
    assert list(gj.edges()) == gp.edges()
    assert [list(gj[n]) for n in gj.nodes] == [gp[n] for n in gp.nodes]
    assert [list(b) for b in jgraph.enumerate_all_bridges(gj)] == pgraph.enumerate_all_bridges(gp)

    aids = ids or [""]
    bps = _bodyparts(aids, preset)
    bj = jgraph.build_body_graph(bps, aids, preset, exclude)
    bp = pgraph.build_body_graph(bps, aids, preset, exclude)
    assert bj.nodes == bp.nodes
    assert bj.edge_names == bp.edge_names
    assert bj.bridge_names == bp.bridge_names
    for k in ("edges", "bridges", "adjacency"):
        np.testing.assert_array_equal(getattr(bj, k), getattr(bp, k))
    assert bj.area_polys.keys() == bp.area_polys.keys()
    for aid in bj.area_polys:
        assert bj.area_polys[aid].keys() == bp.area_polys[aid].keys()
        for name, verts in bj.area_polys[aid].items():
            np.testing.assert_array_equal(verts, bp.area_polys[aid][name])
    if preset == "deepof_14" and ids == ["B", "W"] and exclude is None:
        assert (bp.n_nodes, bp.n_edges) == (28, 32)


@pytest.mark.parametrize("window,polyorder,with_edges", [(15, 14, True), (11, 3, False), (5, 2, True)])
def test_savgol_smooth(window, polyorder, with_edges):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(97, 6)).cumsum(0) + 300.0
    edges = jsmooth.savgol_edges_host(x, window, polyorder) if with_edges else None
    pe = psmooth.savgol_edges_host(x, window, polyorder)
    if with_edges:
        close(pe[0], edges[0], 0)
        close(pe[1], edges[1], 0)
    got = psmooth.savgol_smooth(t64(x), window, polyorder, edges=pe if with_edges else None)
    want = jsmooth.savgol_smooth(jnp.asarray(x), window, polyorder, edges=edges)
    close(got, want)


@pytest.mark.parametrize("lag", [5, 4, 1])
def test_moving_average(lag):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(83, 4)) * 30 + 300
    close(psmooth.moving_average(t64(x), lag), jsmooth.moving_average(jnp.asarray(x), lag))
    close(psmooth.moving_average(t64(x[:, 0]), lag), jsmooth.moving_average(jnp.asarray(x[:, 0]), lag))


@pytest.mark.parametrize("mode", ["or", "and"])
def test_outliers(mode):
    rng = np.random.default_rng(2)
    xy = rng.normal(size=(120, 5, 2)).cumsum(0)
    xy[rng.random((120, 5, 2)) < 0.02] += 40.0
    lik = rng.random((120, 5))
    gm = pout.mask_outliers(t64(xy), t64(lik), 0.2, 5, 3.0, mode)
    wm = jout.mask_outliers(jnp.asarray(xy), jnp.asarray(lik), 0.2, 5, 3.0, mode)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    gc, gf = pout.remove_outliers(t64(xy), t64(lik), 0.2, 5, 3.0, mode)
    wc, wf = jout.remove_outliers(jnp.asarray(xy), jnp.asarray(lik), 0.2, 5, 3.0, mode)
    close(gc, wc)
    assert abs(float(gf) - float(wf)) < 1e-6


def test_fill_indices_and_masked_interp():
    rng = np.random.default_rng(3)
    t, c = 60, 7
    x = rng.normal(size=(t, c))
    x[rng.random((t, c)) < 0.3] = np.nan
    x[:4, 0] = np.nan
    x[-5:, 1] = np.nan
    x[:, 2] = np.nan
    present = rng.random(t) > 0.2
    valid = np.isfinite(x[:, 3])
    np.testing.assert_array_equal(
        pinterp.ffill_indices(torch.as_tensor(valid)).numpy(), np.asarray(jinterp.ffill_indices(jnp.asarray(valid)))
    )
    np.testing.assert_array_equal(
        pinterp.bfill_indices(torch.as_tensor(valid)).numpy(), np.asarray(jinterp.bfill_indices(jnp.asarray(valid)))
    )
    for limit in (None, 1, 3):
        got = pinterp.masked_linear_interpolate(t64(x), torch.as_tensor(present), limit)
        for j in range(c):
            want = jinterp.masked_linear_interpolate(jnp.asarray(x[:, j]), jnp.asarray(present), limit)
            close(got[:, j], want)
        one = pinterp.masked_linear_interpolate(t64(x[:, 5]), torch.as_tensor(present), limit)
        close(one, got[:, 5], 0)


def test_kinematics():
    rng = np.random.default_rng(4)
    t, n = 90, 6
    x = rng.normal(size=(t, n, 2)).cumsum(0) * 3 + 200
    x[10:14, 2] = np.nan
    pairs = pkin.all_pair_indices(n)
    np.testing.assert_array_equal(pairs, jkin.all_pair_indices(n))
    bridges = np.asarray([[0, 1, 2], [3, 2, 5], [1, 4, 0]], np.int32)
    close(pkin.pairwise_distances(t64(x), pairs), jkin.pairwise_distances(jnp.asarray(x), pairs))
    close(pkin.bridge_angles(t64(x), bridges), jkin.bridge_angles(jnp.asarray(x), bridges))
    d = rng.normal(size=(t, 4))
    d[30, 1] = np.nan
    close(pkin._windowed_mean_nan(t64(d), 3), jkin._windowed_mean_nan(jnp.asarray(d), 3))
    close(
        pkin.rolling_speed(t64(x), frame_rate=25.0, deriv=1),
        jkin.rolling_speed(jnp.asarray(x), frame_rate=25.0, deriv=1),
    )
    # deriv >= 2 differentiates values already rounded to 3 decimals, so
    # exact ties reach the next rounding: XLA sums the 3-frame window with
    # FMAs, the port with separate products, and a tie can then round one
    # unit (0.001 * frame_rate) apart. The serving path uses deriv=1 only.
    got = pkin.rolling_speed(t64(x), frame_rate=25.0, deriv=2).numpy()
    want = np.asarray(jkin.rolling_speed(jnp.asarray(x), frame_rate=25.0, deriv=2))
    close(got, want, 0.025 + TOL)
    assert np.mean(np.abs(got - want) > TOL) < 0.02


def _frame(rng, t=300, f=9):
    x = rng.normal(size=(t, f)) * 5 + 20
    x[rng.random((t, f)) < 0.1] = np.nan
    x[:, 4] = 3.0  # constant column
    x[:, 5] = np.nan  # all-NaN column
    return x


def test_interp_nan_columns():
    x = _frame(np.random.default_rng(5))
    close(pscale.interp_nan_columns(t64(x)), jscale.interp_nan_columns(jnp.asarray(x)))


def test_scale_stage12_col_ssd_finish():
    rng = np.random.default_rng(6)
    x = _frame(rng, t=5000)
    f = x.shape[1]
    divisor = rng.random(f) + 0.5
    log_mask = np.arange(f) % 3 == 0
    local_mask = np.arange(f) % 2 == 0
    got = pscale.scale_stage12(t64(x), t64(divisor), torch.as_tensor(log_mask), torch.as_tensor(local_mask))
    want = jscale.scale_stage12(jnp.asarray(x), jnp.asarray(divisor), jnp.asarray(log_mask), jnp.asarray(local_mask))
    for g, w in zip(got, want):
        close(g, w)
    mean = rng.normal(size=f)
    close(pscale.col_ssd(got[0], t64(mean)), jscale.col_ssd(want[0], jnp.asarray(mean)))
    gmean, gscale = rng.normal(size=f), rng.random(f) + 0.5
    gmask, cmask = np.arange(f) < 6, np.arange(f) > 1
    close(
        pscale.finish_scaled(got[0], t64(gmean), t64(gscale), torch.as_tensor(gmask), torch.as_tensor(cmask), 1.5),
        jscale.finish_scaled(want[0], jnp.asarray(gmean), jnp.asarray(gscale), jnp.asarray(gmask), jnp.asarray(cmask), 1.5),
    )


def test_size_divisors_even_count_nanmedian():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(40, 10)) * 3 + 10
    x[rng.random((40, 10)) < 0.25] = np.nan
    w = rng.random((10, 4))
    c = (np.arange(10) % 4 == 0).astype(float)
    # Three animals, one without reference bodyparts.
    quads = ((0, 1, 2, 3), (4, 5, 6, 7), None)
    close(
        pscale.size_divisors(t64(x), t64(w), t64(c), quads),
        jscale.size_divisors(jnp.asarray(x), jnp.asarray(w), jnp.asarray(c), quads),
    )
    even = t64([[1.0, 4.0, np.nan, 2.0, 10.0], [np.nan] * 5]).T
    close(pscale._nanmedian(even), [3.0, np.nan], 0)


@pytest.mark.parametrize("ids", [["B", "W"], [""]])
def test_scale_plan_matches_table_dict_bookkeeping(ids):
    from deepof_tpu.core.table_dict import _build_scale_meta, _divisor_encoding

    from deepof_tpu_torch.data import merged_feature_layout

    bps = _bodyparts(ids, "deepof_14")
    graph = pgraph.build_body_graph(bps, ids)
    cols, _, _, _ = merged_feature_layout(graph, include_angles=True)
    frame = pd.DataFrame(
        np.empty((0, len(cols))),
        columns=pd.Index(cols, dtype=object, tupleize_cols=False),
    )
    meta = _build_scale_meta(frame, True, "per_column", "per_column", "per_column", 10.0)
    w, c, quads = _divisor_encoding(meta, ids)
    plan = pscale.scale_plan(cols, ids)
    np.testing.assert_array_equal(plan["w"], w)
    np.testing.assert_array_equal(plan["c"], c)
    assert plan["quads"] == quads
    np.testing.assert_array_equal(plan["log"], np.asarray(meta["log_mask"]))
    np.testing.assert_array_equal(plan["local"], np.asarray(meta["local_mask"]))
    np.testing.assert_array_equal(plan["clip"], np.asarray(meta["clip_mask"]))
    assert pscale.INTERP_THRESH == meta["interp_thresh"]
