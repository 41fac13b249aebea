"""The port's public serving path against the JAX package's, on the CPU,
through the entry points a user calls: ``Project(...).create(test=True)``
-> ``Coordinates.get_graph_dataset`` -> ``embedding_per_video``, over one
synthesized DeepLabCut project written as csv and as h5.

The fixture writer below makes two recordings, "test" and "test2" (the
keys of the fixed test arenas), of two deepof_14 animals, T = 300 frames
each: seeded random walks with jumps, low-likelihood frames and stretches,
empty (NaN) cells, and animal W absent for 12 frames of "test". Bodyparts
jitter by 3 px about their animal's walk: the scaling divides each log
distance by its local standard deviation in float32, so a last-bit
difference grows by 1 / that deviation; at 1 px jitter the JAX package's
and the port's float32 scaled frames drift from the float64 result by
more than the scaled frames' bar. The JAX side
runs its device scaling lane on the CPU (``DEEPOF_TPU_DEVICE_SCALE=1``); the
port's is its only lane.

Bars: raw tables <= 1 ulp (rtol 1e-15, equal NaN patterns); preprocessed
positions float64 at 1e-8 with equal NaN patterns; presence exact; the
metainfo's node / edge / angle columns, inner_link_mask and the adjacency
exact; scaled frames (float32 on both sides) at 1e-5; embeddings and soft
counts at 1e-5.
"""

import os
import pickle
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bench import _write_dlc_fixed_h5
from deepof_tpu.core.storage import get_dt as jget_dt
from deepof_tpu.data import Project as JaxProject
from deepof_tpu.io import readers as jreaders
from deepof_tpu.models import zoo as jzoo
from deepof_tpu.train.harness import ModelBundle as JaxBundle
from deepof_tpu.train.inference import embedding_per_video as jax_embed

from deepof_tpu_torch.core.graph import connect_mouse
from deepof_tpu_torch.core.storage import LazyFrame, LazyWindows, get_dt
from deepof_tpu_torch.data import Project, load_project
from deepof_tpu_torch.io import readers as preaders
from deepof_tpu_torch.models.zoo import build_model
from deepof_tpu_torch.train.inference import ModelBundle, embedding_per_video
from deepof_tpu_torch.weights import from_flax_params

IDS = ["B", "W"]
BODYPARTS = sorted(connect_mouse(graph_preset="deepof_14").nodes)
T, WINDOW, LATENT, K, FPS = 300, 8, 4, 5, 25


# --------------------------------------------------------------------------- #
# Fixture writer
# --------------------------------------------------------------------------- #


def _recording(rng, t, key):
    """(values (t, C), DLC column tuples) of one two-animal recording."""
    cols, data = [], []
    for aid in IDS:
        base = rng.normal(size=(t, 2)).cumsum(axis=0) * 0.5 + 300.0
        for bp in BODYPARTS:
            xy = base + rng.normal(scale=15.0, size=(1, 2)) + rng.normal(scale=3.0, size=(t, 2))
            xy[rng.random(t) < 0.01] += 60.0  # jumps
            lik = np.clip(rng.beta(20, 1, size=t), 0, 1)
            lik[rng.random(t) < 0.03] = 0.1  # low-likelihood frames
            if bp == "Nose":
                lik[200:210] = 0.5  # a low-likelihood stretch
            if aid == "W" and key == "test":
                lik[90:102] = 0.2  # W absent for 12 frames
            for ci, coord in enumerate(("x", "y")):
                cols.append(("fixture", aid, bp, coord))
                data.append(xy[:, ci])
            cols.append(("fixture", aid, bp, "likelihood"))
            data.append(lik)
    values = np.round(np.stack(data, axis=1), 4)
    if key == "test2":  # empty cells
        values[150, 3] = np.nan
        values[10, 2] = np.nan
    return values, cols


def _write_csv(path, values, cols):
    """A DLC csv as pandas writes one: the column levels as rows led by
    their names, then rows led by the frame index; NaN as an empty cell."""
    names = ["scorer", "individuals", "bodyparts", "coords"]
    lines = [",".join([names[lvl]] + [c[lvl] for c in cols]) for lvl in range(4)]
    for i, row in enumerate(values):
        lines.append(",".join([str(i)] + ["" if np.isnan(v) else repr(float(v)) for v in row]))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def write_project(root, fmt, lengths=(T, T), seed=0, keys=("test", "test2")):
    """Tables/ and Videos/ of a project under ``root``: one recording of
    each length, keyed by ``keys`` in order."""
    os.makedirs(f"{root}/Tables")
    os.makedirs(f"{root}/Videos")
    rng = np.random.default_rng(seed)
    for key, t in zip(keys, lengths):
        values, cols = _recording(rng, t, key)
        if fmt == "csv":
            _write_csv(f"{root}/Tables/{key}DLC_fixture.csv", values, cols)
        else:
            _write_dlc_fixed_h5(f"{root}/Tables/{key}DLC_fixture.h5", values, cols)
        open(f"{root}/Videos/{key}DLC_video.mp4", "wb").close()
    return root


def _project_args(root, fmt):
    return dict(
        project_path=str(root), project_name="p", video_path=f"{root}/Videos",
        table_path=f"{root}/Tables", arena="circular-autodetect", video_scale="380 mm",
        table_format=fmt, frame_rate=FPS, animal_ids=IDS,
    )


# --------------------------------------------------------------------------- #
# Both sides, built once per table format
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module", params=["csv", "h5"])
def sides(request, tmp_path_factory):
    fmt = request.param
    root = write_project(tmp_path_factory.mktemp(f"project_{fmt}"), fmt)
    mp = pytest.MonkeyPatch()
    mp.setenv("DEEPOF_TPU_DEVICE_SCALE", "1")
    try:
        j_coords = JaxProject(**_project_args(root, fmt)).create(force=True, test=True, verbose=False)
        j_ggd = j_coords.get_graph_dataset(window_size=WINDOW)
    finally:
        mp.undo()
    p_coords = Project(**_project_args(root, fmt), device="cpu").create(force=True, test=True, verbose=False)
    p_ggd = p_coords.get_graph_dataset(window_size=WINDOW)
    return {"fmt": fmt, "root": root, "jax": (j_coords, j_ggd), "port": (p_coords, p_ggd)}


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, equal_nan=True)


def test_raw_tables_match_jax(sides):
    fmt, root = sides["fmt"], sides["root"]
    for tab in sorted(os.listdir(f"{root}/Tables")):
        got = preaders.load_table(tab, f"{root}/Tables", fmt)
        want = jreaders.load_table(tab, f"{root}/Tables", fmt)
        assert got.bodyparts == want.bodyparts
        assert got.animal_ids == want.animal_ids == IDS
        assert got.has_individuals and want.has_individuals
        for a, b in ((got.positions, want.positions), (got.likelihood, want.likelihood)):
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
            np.testing.assert_allclose(a, b, rtol=1e-15, atol=0, equal_nan=True)
        assert np.isnan(got.positions).any() == (tab.startswith("test2"))


def test_create_matches_jax(sides):
    (j, _), (p, _) = sides["jax"], sides["port"]
    assert list(p._tables) == list(j._tables) and set(p._tables) == {"test", "test2"}
    assert p._nodes == j._nodes
    assert p._pair_names == [tuple(x) for x in j._pair_names]
    assert [tuple(b) for b in p._bridge_names] == [tuple(b) for b in j._bridge_names]
    assert p._area_names == j._area_names
    assert p._animal_ids == j._animal_ids
    for key in j._tables:
        assert p._tables[key].dtype == np.float64
        _close(p._tables[key], j._tables[key], 1e-8)
        np.testing.assert_array_equal(p._presence[key], np.asarray(j._presence[key]))
        np.testing.assert_array_equal(p._quality[key], j._quality[key])
        assert list(p._scales[key]) == list(j._scales[key])
    assert not np.asarray(j._presence["test"]).all()  # the absent stretch is exercised
    assert np.isnan(p._tables["test2"]).any()  # and NaNs left after imputation


def test_graph_dataset_matches_jax(sides):
    (_, (j_ds, j_meta, j_adj, j_tab, j_sc)), (_, (p_ds, p_meta, p_adj, p_tab, p_sc)) = (
        sides["jax"], sides["port"],
    )
    for name in ("node_columns", "edge_columns", "angle_columns"):
        assert p_meta[name] == list(j_meta[name])
    assert len(p_meta["angle_columns"]) == 42
    np.testing.assert_array_equal(p_meta["inner_link_mask"], j_meta["inner_link_mask"])
    assert p_meta["inner_link_mask"].dtype == bool
    np.testing.assert_array_equal(p_adj, np.asarray(j_adj))
    for key in ("shape_train", "shape_test", "dist_standardize", "speed_standardize", "coord_standardize"):
        assert p_meta[key] == j_meta[key]

    # The merged frames, then the scaled frames the lane stashed.
    assert all(isinstance(p_tab[k], LazyFrame) for k in p_tab)
    for key in j_tab:
        assert get_dt(p_tab, key, only_metainfo=True)["columns"] == list(
            jget_dt(j_tab, key, only_metainfo=True)["columns"]
        )
        _close(get_dt(p_tab, key), jget_dt(j_tab, key).to_numpy(), 1e-8)
        _close(get_dt(p_tab._scaled_frames, key), jget_dt(j_tab._scaled_frames, key).to_numpy(), 1e-5)
    # The global scaler, fitted on float32 frames (the locally standardised
    # sections' means are roundoff around 0): at the scaled frames' bar.
    for name in ("speed", "dist", "coord"):
        np.testing.assert_allclose(p_sc[name].mean_, j_sc[name].mean_, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(p_sc[name].scale_, j_sc[name].scale_, rtol=1e-5, atol=1e-5)
    assert p_sc["dist_inner"] is None and p_sc["kind"] == "standard"

    # The training windows, realised on access.
    for j_part, p_part in zip(j_ds, p_ds):
        assert list(p_part) == list(j_part)
        for key in j_part:
            assert isinstance(p_part[key], LazyWindows)
            meta = get_dt(p_part, key, only_metainfo=True)
            for got, want, shape in zip(get_dt(p_part, key), jget_dt(j_part, key), meta["shape"]):
                assert got.shape == shape
                _close(got, want, 1e-5)


def _bundles(p_adj, p_meta, use_angles, seed=1):
    """A JAX VQ-VAE bundle with seeded flax params, and the port's model on
    the same weights."""
    n = len(p_meta["node_columns"]) // 3
    e = len(p_meta["edge_columns"])
    a = len(p_meta["angle_columns"])
    jm = jzoo.build_model("VQVAE", (WINDOW, n, 3), (WINDOW, e, 1), np.asarray(p_adj),
                          latent_dim=LATENT, n_components=K)
    args = [jnp.zeros((1, WINDOW, n, 3)), jnp.zeros((1, WINDOW, e, 1))]
    if use_angles:
        args.append(jnp.zeros((1, WINDOW, a)))
    shapes = jax.eval_shape(lambda *x: jm.init(jax.random.PRNGKey(0), *x), *args)["params"]
    if use_angles:
        assert "RecurrentBlock_2" in shapes["encoder"]
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(lambda v: rng.normal(scale=0.3, size=v.shape).astype(np.float32), shapes)
    spec = {"model": "VQVAE", "input_shape": [WINDOW, n, 3], "edge_feature_shape": [WINDOW, e, 1],
            "n_components": K, "use_angles": use_angles,
            "angle_feature_shape": [WINDOW, a] if use_angles else None}
    j_bundle = JaxBundle(model=jm, variables={"params": jax.tree_util.tree_map(jnp.asarray, params)},
                         rebuild_spec=spec)
    pm = build_model("VQVAE", (WINDOW, n, 3), (WINDOW, e, 1), p_adj, LATENT, K, device="cpu",
                     angle_feature_shape=spec["angle_feature_shape"])
    pm.load_state_dict(from_flax_params(params))
    return j_bundle, ModelBundle(pm, spec)


@pytest.fixture(scope="module")
def bundle_cache():
    """(use_angles) -> both sides' bundles, built once: the JAX bundle keeps
    its compiled scanned forward, which every table format and branch
    shares (the same layout and lengths)."""
    return {}


@pytest.mark.parametrize("use_angles", [False, True], ids=["no_angles", "angles"])
@pytest.mark.parametrize("reuse", [True, False], ids=["reuse_scaled", "pretrained_scaler"])
def test_embedding_per_video_matches_jax(sides, bundle_cache, use_angles, reuse, monkeypatch):
    """Both branches: the scaled frames reused (the very scaler object), and
    a preprocess with a pretrained scaler (a new scaler object)."""
    monkeypatch.setenv("DEEPOF_TPU_DEVICE_SCALE", "1")
    (j_coords, (_, j_meta, _, j_tab, j_sc)), (p_coords, (_, p_meta, p_adj, p_tab, p_sc)) = (
        sides["jax"], sides["port"],
    )
    if not reuse:
        j_sc, p_sc = dict(j_sc), dict(p_sc)
    if use_angles not in bundle_cache:
        bundle_cache[use_angles] = _bundles(p_adj, p_meta, use_angles)
    j_bundle, p_bundle = bundle_cache[use_angles]
    j_emb, j_counts = jax_embed(j_coords, j_tab, j_bundle, j_meta, global_scaler=j_sc, batch_size=64)
    p_emb, p_counts = embedding_per_video(p_coords, p_tab, p_bundle, p_meta, global_scaler=p_sc,
                                          batch_size=64)
    assert list(p_emb) == list(j_emb) and set(p_emb) == {"test", "test2"}
    for key in j_emb:
        assert p_emb[key].shape == (T - WINDOW + 1, LATENT) and p_counts[key].shape == (T - WINDOW + 1, K)
        _close(p_emb[key], j_emb[key].to_numpy(), 1e-5)
        _close(p_counts[key], j_counts[key].to_numpy(), 1e-5)
        np.testing.assert_allclose(p_counts[key].sum(axis=1), 1.0, atol=1e-5)
    assert p_emb._type == "unsupervised_embedding" and p_counts._type == "unsupervised_counts"


# --------------------------------------------------------------------------- #
# Readers, persistence and the errors of what is not ported
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("individuals", [True, False], ids=["multi", "single"])
@pytest.mark.parametrize("named_index", [True, False], ids=["named_index", "unnamed_index"])
def test_csv_reader_matches_pandas(tmp_path, individuals, named_index):
    """A csv that pandas writes itself, full-precision values and NaN
    cells, read by the port and by the JAX package's pandas reader."""
    import pandas as pd

    rng = np.random.default_rng(3)
    ids = IDS if individuals else [None]
    tuples = [
        ("dlc",) + ((aid,) if aid else ()) + (bp, c)
        for aid in ids for bp in BODYPARTS[:4] for c in ("x", "y", "likelihood")
    ]
    names = ["scorer"] + (["individuals"] if individuals else []) + ["bodyparts", "coords"]
    values = rng.normal(size=(57, len(tuples))) * 100
    values[rng.random(values.shape) < 0.05] = np.nan
    df = pd.DataFrame(values, columns=pd.MultiIndex.from_tuples(tuples, names=names))
    df.index.name = "frame" if named_index else None
    df.to_csv(tmp_path / "tDLC.csv")
    got = preaders._read_dlc_csv(str(tmp_path / "tDLC.csv"))
    want = jreaders._read_dlc_csv(str(tmp_path / "tDLC.csv"))
    assert got.bodyparts == want.bodyparts and got.animal_ids == want.animal_ids
    assert got.has_individuals == want.has_individuals == individuals
    for a, b in ((got.positions, want.positions), (got.likelihood, want.likelihood)):
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a, b, rtol=1e-15, atol=0, equal_nan=True)


def test_coordinates_pickle_and_load_project(sides):
    p_coords = sides["port"][0]
    loaded = load_project(os.path.join(p_coords._project_path, p_coords._project_name))
    assert loaded._nodes == p_coords._nodes and loaded._device == "cpu"
    for key in p_coords._tables:
        np.testing.assert_array_equal(loaded._tables[key], p_coords._tables[key])
    assert pickle.loads(pickle.dumps(p_coords))._animal_ids == IDS


def test_unequal_lengths_raise(tmp_path, monkeypatch):
    """Recordings of unequal length no longer raise: both are cut to the
    shorter, and the fused lane's frames, no longer their full range, are
    scaled on the float64 general route, as the JAX package scales them on
    its host passes (1e-8)."""
    monkeypatch.setenv("DEEPOF_TPU_DEVICE_SCALE", "1")
    root = write_project(tmp_path, "csv", lengths=(T, T - 20))
    j_coords = JaxProject(**_project_args(root, "csv")).create(force=True, test=True, verbose=False)
    coords = Project(**_project_args(root, "csv"), device="cpu").create(force=True, test=True, verbose=False)
    (_, j_meta, _, j_tab, _), (_, meta, _, tab, _) = (
        j_coords.get_graph_dataset(window_size=WINDOW), coords.get_graph_dataset(window_size=WINDOW))
    assert meta["shape_train"] == j_meta["shape_train"] == [(2 * (T - 20 - WINDOW + 1), WINDOW, n)
                                                           for n in (84, 32, 42)]
    for key in ("test", "test2"):
        assert tab._scaled_device[key].shape == (T - 20, 158)
        _close(get_dt(tab._scaled_frames, key), jget_dt(j_tab._scaled_frames, key).to_numpy(), 1e-8)


def test_full_imputation_and_arena_detection_raise(tmp_path):
    """Arena detection is not ported (full imputation is since; its tests
    are in tests/test_torch_imputation.py)."""
    root = write_project(tmp_path, "csv")
    with pytest.raises(NotImplementedError, match="item 7"):
        Project(**_project_args(root, "csv"), device="cpu").create(verbose=False)


def test_h5_without_h5py_raises(tmp_path, monkeypatch):
    root = write_project(tmp_path, "csv")
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        preaders.load_table("testDLC_fixture.h5", f"{root}/Tables", "h5")
    # csv tables need no h5py.
    assert preaders.load_table("testDLC_fixture.csv", f"{root}/Tables", "csv").positions.shape == (T, 28, 2)


def test_project_defaults_to_cuda_and_raises_without_gpu(tmp_path, monkeypatch):
    root = write_project(tmp_path, "csv")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Project(**_project_args(root, "csv"))


# --------------------------------------------------------------------------- #
# The encoder's angle stream
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("use_gnn", [True, False], ids=["gnn", "no_gnn"])
def test_angle_stream_weights_and_scanned_forward_match_jax(use_gnn):
    """flax names the angle block RecurrentBlock_2 after CensNetConv_0 with
    the GNN and RecurrentBlock_1 without it; ``from_flax_params`` carries
    it over, and the window kernel's third table (1, A) feeds it."""
    from deepof_tpu.train.inference import scanned_windowed_forward as jax_forward

    from deepof_tpu_torch.train.inference import scanned_windowed_forward, stream_tables

    n, e, a, f = 5, 4, 6, 3 * 5 + 4 + 6
    adj = np.zeros((n, n), np.float32)
    for i, j in [(0, 1), (1, 2), (2, 3), (1, 4)]:
        adj[i, j] = adj[j, i] = 1.0
    rng = np.random.default_rng(4)
    perm = rng.permutation(f)
    layout = {"node": perm[:3 * n].tolist(), "edge": perm[3 * n:3 * n + e].tolist(),
              "angle": perm[3 * n + e:].tolist()}
    assert [t.shape for t in stream_tables(layout, use_gnn)] == (
        [(n, 3), (e, 1), (1, a)] if use_gnn else [(1, 3 * n), (1, a)]
    )
    jm = jzoo.build_model("VQVAE", (WINDOW, n, 3), (WINDOW, e, 1), adj, latent_dim=LATENT,
                          n_components=K, use_gnn=use_gnn)
    shapes = jax.eval_shape(
        lambda *x: jm.init(jax.random.PRNGKey(0), *x),
        jnp.zeros((1, WINDOW, n, 3)), jnp.zeros((1, WINDOW, e, 1)), jnp.zeros((1, WINDOW, a)),
    )["params"]
    assert sorted(shapes["encoder"]) == (
        ["CensNetConv_0", "Dense_0", "RecurrentBlock_0", "RecurrentBlock_1", "RecurrentBlock_2"]
        if use_gnn else ["Dense_0", "RecurrentBlock_0", "RecurrentBlock_1"]
    )
    params = jax.tree_util.tree_map(lambda v: rng.normal(scale=0.3, size=v.shape).astype(np.float32), shapes)
    spec = {"model": "VQVAE", "input_shape": [WINDOW, n, 3], "edge_feature_shape": [WINDOW, e, 1],
            "use_angles": True, "angle_feature_shape": [WINDOW, a]}
    feats = rng.normal(size=(70, f)).astype(np.float32)
    j_emb, j_sc = jax_forward(
        JaxBundle(model=jm, variables={"params": jax.tree_util.tree_map(jnp.asarray, params)}, rebuild_spec=spec),
        feats, layout, WINDOW, "VQVAE", block=32,
    )
    pm = build_model("VQVAE", (WINDOW, n, 3), (WINDOW, e, 1), adj, LATENT, K, use_gnn=use_gnn,
                     device="cpu", angle_feature_shape=(WINDOW, a))
    pm.load_state_dict(from_flax_params(params))
    p_emb, p_sc = scanned_windowed_forward(ModelBundle(pm, spec), feats, layout, WINDOW, "VQVAE",
                                           block=32, device="cpu")
    _close(p_emb, j_emb, 1e-5)
    _close(p_sc, j_sc, 1e-5)
    with pytest.raises(ValueError, match="angle block"):
        scanned_windowed_forward(ModelBundle(pm, spec), feats, {**layout, "angle": None}, WINDOW,
                                 "VQVAE", block=32, device="cpu")


def test_arena_path_matches_test_arenas(sides, tmp_path):
    """Arena data saved from test mode and read back through ``arena_path``
    gives the same project as ``test=True``."""
    root, p_coords = sides["root"], sides["port"][0]
    proj = Project(**{**_project_args(root, sides["fmt"]), "project_name": "from_arena_file"}, device="cpu")
    scales, params, rois, res = proj.get_arena(test=True)
    proj.save_arena_data(str(tmp_path / "arena.pkl"), params, rois, scales, res)
    coords = proj.create(arena_path=str(tmp_path / "arena.pkl"), verbose=False)
    assert coords._scales == p_coords._scales
    for key in p_coords._tables:
        np.testing.assert_array_equal(coords._tables[key], p_coords._tables[key])
