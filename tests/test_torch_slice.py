"""The port's serving slice end to end against the same composition in the
JAX package, on the CPU: raw keypoints -> fused preprocess -> mm scaling ->
merged frame (through the JAX package's own fused lane,
``Coordinates.merged_graph_features_device``) -> device scaling ->
``scanned_windowed_forward`` on carried-over VQ-VAE weights.

Bars: preprocess and the merged frame in float64 at 1e-8 with equal NaN
patterns; the scaled frame (float32, as the device scaling runs) at 1e-5;
embeddings and soft counts at 1e-5.

Also: the port imports nothing of JAX, flax or deepof_tpu, and its entry
points raise without a GPU unless asked for the CPU.
"""

import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepof_tpu import data as jdata
from deepof_tpu.core import graph as jgraph
from deepof_tpu.core.table_dict import (
    _StandardScalerLite,
    _build_scale_meta,
    _divisor_encoding,
    _global_scaler_vectors,
)
from deepof_tpu.models import zoo as jzoo
from deepof_tpu.ops import scaling as jscale
from deepof_tpu.ops.smoothing import savgol_edges_host
from deepof_tpu.train.harness import ModelBundle as JaxBundle
from deepof_tpu.train.inference import scanned_windowed_forward as jax_forward

import deepof_tpu_torch.data as pdata
from deepof_tpu_torch.core.graph import build_body_graph
from deepof_tpu_torch.models.zoo import build_model
from deepof_tpu_torch.ops.scaling import scale_merged_frame, scale_plan
from deepof_tpu_torch.train.inference import ModelBundle, scanned_windowed_forward
from deepof_tpu_torch.weights import from_flax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IDS = ["B", "W"]
T, WINDOW, LATENT, K = 200, 8, 4, 5
RATIO, FPS = 380.0 / 420.0, 25.0


def _close(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol, equal_nan=True)


def _recording(nodes, seed=0):
    """Random-walk keypoints for two animals; W is lost for 12 frames and
    some keypoints jump or drop in likelihood."""
    rng = np.random.default_rng(seed)
    n = len(nodes)
    base = rng.normal(size=(T, 2)).cumsum(axis=0) * 0.5 + 300.0
    pos = base[:, None, :] + rng.normal(scale=15.0, size=(1, n, 2)) + rng.normal(size=(T, n, 2))
    pos[rng.random((T, n, 2)) < 0.01] += 60.0
    lik = np.clip(rng.beta(20, 1, size=(T, n)), 0, 1)
    lik[rng.random((T, n)) < 0.03] = 0.1
    w_cols = [i for i, bp in enumerate(nodes) if bp.startswith("W_")]
    lik[90:102, w_cols] = 0.2
    return pos, lik


def _jax_scaled(frame, columns):
    """The JAX package's device scaling of one table, composed as
    TableDict._preprocess_scale_device composes it (no pretrained scaler)."""
    import pandas as pd

    meta = _build_scale_meta(
        pd.DataFrame(np.empty((0, len(columns))), columns=columns),
        True, "per_column", "per_column", "per_column", 10.0,
    )
    w, c, quads = _divisor_encoding(meta, IDS)
    x = jnp.asarray(frame, jnp.float32)
    divisor = jscale.size_divisors(x, jnp.asarray(w), jnp.asarray(c), quads)
    xs, cnt, sm = jscale.scale_stage12(x, divisor, meta["log_mask"], meta["local_mask"])
    cnt_h = np.asarray(cnt, np.float64).sum(0)
    mean_h = np.asarray(sm, np.float64).sum(0) / np.maximum(cnt_h, 1.0)
    ssd = np.asarray(jscale.col_ssd(xs, jnp.asarray(mean_h, jnp.float32)), np.float64).sum(0)
    var_h = ssd / np.maximum(cnt_h, 1.0)
    scaler = {"kind": "standard", "dist_inner": None, "dist_intra": None}
    for name, cols in (("speed", meta["ct"]["speeds"]), ("dist", meta["ct"]["dists"]), ("coord", meta["coord_cols"])):
        ii = [meta["pos"][col] for col in cols]
        scaler[name] = _StandardScalerLite(mean_h[ii], var_h[ii])
    gmean, gscale, gmask = _global_scaler_vectors(scaler, meta, len(columns), ("per_column",) * 3)
    return jscale.finish_scaled(
        xs, jnp.asarray(gmean), jnp.asarray(gscale), jnp.asarray(gmask),
        meta["clip_mask"], meta["interp_thresh"],
    )


def test_slice_matches_jax_composition():
    bodyparts = sorted(f"{a}_{bp}" for a in IDS for bp in jgraph.connect_mouse().nodes)
    jgraph_ = jgraph.build_body_graph(bodyparts, IDS)
    graph = build_body_graph(bodyparts, IDS)
    nodes = list(graph.nodes)
    slices = []
    for aid in IDS:
        cols = [i for i, bp in enumerate(nodes) if bp.startswith(f"{aid}_")]
        slices.append((min(cols), max(cols) + 1))
    slices = tuple(slices)
    pos, lik = _recording(nodes)
    edges = savgol_edges_host(pos.reshape(T, -1), 15, 14)
    steps = (True, 15, 14, True, 0.75, 3.0, 3, slices)

    # 1. Fused preprocess, float64.
    j_clean, j_pres = jdata._preprocess_positions(
        jnp.asarray(pos), jnp.asarray(lik), tuple(map(jnp.asarray, edges)), *steps
    )
    p_clean, p_pres = pdata._preprocess_positions(pos, lik, edges, *steps, device="cpu")
    assert p_clean.dtype == torch.float64
    _close(p_clean, j_clean, 1e-8)
    np.testing.assert_array_equal(p_pres.numpy(), np.asarray(j_pres))
    assert not np.asarray(j_pres).all()  # an absent stretch is exercised

    # 2. mm scaling + the merged frame through the JAX package's fused lane.
    mm = np.asarray(j_clean) * RATIO
    center = np.array([300.0, 300.0]) * RATIO
    pair_names = [tuple(sorted((nodes[i], nodes[j]))) for i, j in jdata.all_pair_indices(len(nodes))]
    coords = SimpleNamespace(
        _nodes=nodes, _pair_names=pair_names, _body_graph=jgraph_, _ego=False,
        _bridge_names=list(jgraph_.bridge_names), _animal_ids=IDS,
        _tables={"v": mm}, _presence={"v": np.asarray(j_pres)},
        _scales={"v": np.concatenate([center, [420.0, 380.0]])}, _frame_rate=FPS,
    )
    coords._distance_keep_idx = lambda *a, **k: jdata.Coordinates._distance_keep_idx(coords, *a, **k)
    j_frames, j_columns = jdata.Coordinates.merged_graph_features_device(coords, include_angles=False)
    columns, pairs, bridges, owner = pdata.merged_feature_layout(graph, IDS, include_angles=False)
    assert columns == list(j_columns)
    p_frame = pdata._merged_features_program(
        p_clean * RATIO, p_pres.to(torch.float32), center, owner, pairs, bridges,
        FPS, False, device="cpu",
    )
    assert p_frame.shape == (T, 3 * 28 + 32)
    _close(p_frame, j_frames["v"], 1e-8)

    # 3. Device scaling (float32, as the device pass runs).
    j_scaled = _jax_scaled(j_frames["v"], j_columns)
    p_scaled = scale_merged_frame(p_frame.to(torch.float32), scale_plan(columns, IDS))
    _close(p_scaled, j_scaled, 1e-5)

    # 4. Windows -> VQ-VAE encoder -> embeddings and soft counts.
    n, e = graph.n_nodes, graph.n_edges
    node_cols = [(bp, "x") for bp in nodes] + [(bp, "y") for bp in nodes] + nodes
    edge_cols = sorted(tuple(sorted(ed)) for ed in graph.edge_names)
    layout = {
        "node": [columns.index(col) for col in node_cols],
        "edge": [columns.index(col) for col in edge_cols],
        "angle": None,
    }
    jm = jzoo.build_model("VQVAE", (WINDOW, n, 3), (WINDOW, e, 1), graph.adjacency, latent_dim=LATENT, n_components=K)
    shapes = jax.eval_shape(
        lambda x, a: jm.init(jax.random.PRNGKey(0), x, a), jnp.zeros((1, WINDOW, n, 3)), jnp.zeros((1, WINDOW, e, 1))
    )["params"]
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(lambda v: rng.normal(scale=0.3, size=v.shape).astype(np.float32), shapes)
    spec = {"model": "VQVAE", "input_shape": [WINDOW, n, 3], "edge_feature_shape": [WINDOW, e, 1], "use_angles": False}
    j_emb, j_sc = jax_forward(
        JaxBundle(model=jm, variables={"params": jax.tree_util.tree_map(jnp.asarray, params)}, rebuild_spec=spec),
        np.asarray(j_scaled), layout, WINDOW, "VQVAE", block=64,
    )
    pm = build_model("VQVAE", (WINDOW, n, 3), (WINDOW, e, 1), graph.adjacency, LATENT, K, device="cpu")
    pm.load_state_dict(from_flax_params(params))
    p_emb, p_sc = scanned_windowed_forward(
        ModelBundle(pm, spec), p_scaled, layout, WINDOW, "VQVAE", block=64, device="cpu"
    )
    assert p_emb.shape == (T - WINDOW + 1, LATENT) and p_sc.shape == (T - WINDOW + 1, K)
    _close(p_emb, j_emb, 1e-5)
    _close(p_sc, j_sc, 1e-5)
    np.testing.assert_allclose(p_sc.sum(1), 1.0, atol=1e-5)


def test_scanned_forward_without_gnn_matches_jax():
    """The encoder without the GNN reads one flat (N*3) stream, which the
    window kernel writes from a single (1, 3N) column table."""
    bodyparts = sorted(f"{a}_{bp}" for a in IDS for bp in jgraph.connect_mouse().nodes)
    graph = build_body_graph(bodyparts, IDS)
    columns = pdata.merged_feature_layout(graph, IDS, include_angles=False)[0]
    nodes = list(graph.nodes)
    node_cols = [(bp, "x") for bp in nodes] + [(bp, "y") for bp in nodes] + nodes
    layout = {
        "node": [columns.index(col) for col in node_cols],
        "edge": [columns.index(col) for col in sorted(graph.edge_names)],
        "angle": None,
    }
    n, e = graph.n_nodes, graph.n_edges
    rng = np.random.default_rng(2)
    scaled = rng.normal(size=(90, len(columns))).astype(np.float32)
    jm = jzoo.build_model("VQVAE", (WINDOW, n, 3), (WINDOW, e, 1), graph.adjacency,
                          latent_dim=LATENT, n_components=K, use_gnn=False)
    shapes = jax.eval_shape(
        lambda x, a: jm.init(jax.random.PRNGKey(0), x, a), jnp.zeros((1, WINDOW, n, 3)), jnp.zeros((1, WINDOW, e, 1))
    )["params"]
    params = jax.tree_util.tree_map(lambda v: rng.normal(scale=0.3, size=v.shape).astype(np.float32), shapes)
    spec = {"model": "VQVAE", "input_shape": [WINDOW, n, 3], "edge_feature_shape": [WINDOW, e, 1], "use_angles": False}
    j_emb, j_sc = jax_forward(
        JaxBundle(model=jm, variables={"params": jax.tree_util.tree_map(jnp.asarray, params)}, rebuild_spec=spec),
        scaled, layout, WINDOW, "VQVAE", block=32,
    )
    pm = build_model("VQVAE", (WINDOW, n, 3), (WINDOW, e, 1), graph.adjacency, LATENT, K, use_gnn=False, device="cpu")
    pm.load_state_dict(from_flax_params(params))
    p_emb, p_sc = scanned_windowed_forward(ModelBundle(pm, spec), scaled, layout, WINDOW, "VQVAE", block=32, device="cpu")
    assert p_emb.shape == (90 - WINDOW + 1, LATENT)
    _close(p_emb, j_emb, 1e-5)
    _close(p_sc, j_sc, 1e-5)


def test_port_imports_nothing_of_jax():
    """Every module of the port, and chip_smoke.py, in a fresh interpreter:
    nothing of JAX, flax or deepof_tpu, and none of the host libraries the
    machine with the card lacks (pandas, sklearn, h5py, cv2, networkx),
    the cluster detectors' modules (the tree fit, its kernels' wrappers,
    SMOTE and the pipeline) among them."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import deepof_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(deepof_tpu_torch.__path__, 'deepof_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'deepof_tpu',\n"
        "                                                        'pandas', 'sklearn', 'h5py', 'cv2',\n"
        "                                                        'networkx'))\n"
        "new = ('deepof_tpu_torch.gbm', 'deepof_tpu_torch.legacy_compat', 'deepof_tpu_torch.ops.gbm_kernels')\n"
        "bad += [m for m in new if m not in sys.modules]\n"
        "print(len([m for m in sys.modules if m.startswith('deepof_tpu_torch')]), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert int(res.stdout.split()[0]) >= 34


def test_entry_points_default_to_cuda_and_raise_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    graph = build_body_graph(sorted(f"B_{bp}" for bp in jgraph.connect_mouse().nodes), ["B"])
    n = graph.n_nodes
    pos = np.zeros((30, n, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pdata._preprocess_positions(pos, np.ones((30, n)), None, False, 15, 14, False, 0.5, 3.0, 3, ((0, n),))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pdata._merged_features_program(pos, np.ones((30, 1)), np.zeros(2), np.zeros((1, 3 * n), bool), (), (), 25.0, False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model("VQVAE", (8, n, 3), (8, graph.n_edges, 1), graph.adjacency, 4)
    pm = build_model("VQVAE", (8, n, 3), (8, graph.n_edges, 1), graph.adjacency, 4, device="cpu")
    layout = {"node": list(range(3 * n)), "edge": list(range(3 * n, 3 * n + graph.n_edges)), "angle": None}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scanned_windowed_forward(ModelBundle(pm), np.zeros((30, 3 * n + graph.n_edges)), layout, 8, "VQVAE")
