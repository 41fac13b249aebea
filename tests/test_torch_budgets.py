"""Past the device residency budgets, the projections, precomputed graph
datasets and ``Project.scale_tables``, against the JAX package on the CPU.

The budgets (``core/table_dict.py`` ``DEVICE_SCALE_BUDGET_BYTES``,
``DEVICE_FRAMES_BYTES``) are lowered below one recording's bytes through
monkeypatch, the JAX package's through its environment variables
(``DEEPOF_TPU_DEVICE_SCALE_BUDGET_BYTES``, ``DEEPOF_TPU_DEVICE_FRAMES_BYTES``;
``DEEPOF_TPU_DEVICE_SCALE=1`` so that it takes its device lane on the
CPU), on ``tests/test_torch_public.py``'s two-recording project (T = 300).

Bars: past the frames budget alone, the scaled frames, windows and
embeddings equal the in-budget run's bit for bit (the same frames, kept on
the host and uploaded); past the scaling budget, the general route against
the JAX package's host passes at 1e-8 and against the in-budget device route
at its 1e-5; embeddings and soft counts 1e-5 (the north star). The
projections against sklearn and the JAX package at 1e-10 (float64; other
eigensolvers and summation orders), with numpy's global state seeded alike;
``precomputed_tab_dict`` and ``scale_tables`` at the bars of their routes.
"""

import sys
import warnings

import numpy as np
import pandas as pd
import pytest
import torch

from sklearn.decomposition import KernelPCA
from sklearn.random_projection import GaussianRandomProjection

from deepof_tpu.core import table_dict as jtd
from deepof_tpu.core.storage import get_dt as jget_dt
from deepof_tpu.data import Project as JaxProject
from deepof_tpu.train.inference import embedding_per_video as jax_embed

from deepof_tpu_torch.core import table_dict as ptd
from deepof_tpu_torch.core.storage import LazyFrame, get_dt
from deepof_tpu_torch.data import Project
from deepof_tpu_torch.io import readers as preaders
from deepof_tpu_torch.train.inference import embedding_per_video

from test_torch_encoders import one_torch_thread  # noqa: F401 (an autouse fixture of this module too)
from test_torch_public import T, WINDOW, _bundles, _project_args, write_project

KEYS = ("test", "test2")
MODES = {  # which budgets are lowered below one recording's bytes
    "scale": ("DEVICE_SCALE_BUDGET_BYTES",),
    "frames": ("DEVICE_FRAMES_BYTES",),
    "both": ("DEVICE_SCALE_BUDGET_BYTES", "DEVICE_FRAMES_BYTES"),
}
JAX_ENV = {"DEVICE_SCALE_BUDGET_BYTES": "DEEPOF_TPU_DEVICE_SCALE_BUDGET_BYTES",
           "DEVICE_FRAMES_BYTES": "DEEPOF_TPU_DEVICE_FRAMES_BYTES"}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    if not ok.any():
        return 0.0
    return float(np.abs(got[ok] - want[ok]).max(initial=0.0)) / max(1.0, float(np.abs(want[ok]).max()))


def _lowered(mode):
    """A MonkeyPatch with ``mode``'s budgets lowered in both packages."""
    mp = pytest.MonkeyPatch()
    mp.setenv("DEEPOF_TPU_DEVICE_SCALE", "1")
    for name in MODES.get(mode, ()):
        mp.setattr(ptd, name, 1)
        mp.setenv(JAX_ENV[name], "1")
    return mp


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    root = write_project(tmp_path_factory.mktemp("budgets"), "csv")
    mp = _lowered("in")
    try:
        j_proj = JaxProject(**_project_args(root, "csv"))
        j_coords = j_proj.create(force=True, test=True, verbose=False)
    finally:
        mp.undo()
    p_proj = Project(**_project_args(root, "csv"), device="cpu")
    p_coords = p_proj.create(force=True, test=True, verbose=False)
    return {"root": root, "jax": (j_proj, j_coords), "port": (p_proj, p_coords), "runs": {}}


def _run(project, side, mode, reuse=True):
    """get_graph_dataset -> embedding_per_video under ``mode``'s budgets
    (the embedding's preprocess under them too), cached by its arguments."""
    key = (side, mode, reuse)
    if key in project["runs"]:
        return project["runs"][key]
    coords = project[side][1]
    if ("bundles", 0) not in project["runs"]:
        ggd = project["port"][1].get_graph_dataset(window_size=WINDOW)
        project["runs"][("bundles", 0)] = _bundles(ggd[2], ggd[1], use_angles=False)
    bundle = project["runs"][("bundles", 0)][0 if side == "jax" else 1]
    embed = jax_embed if side == "jax" else embedding_per_video
    mp = _lowered(mode)
    try:
        ggd = coords.get_graph_dataset(window_size=WINDOW)
        (train, _), meta, _, tab, scaler = ggd
        emb, counts = embed(coords, tab, bundle, meta, global_scaler=scaler if reuse else dict(scaler),
                            batch_size=64)
    finally:
        mp.undo()
    project["runs"][key] = (ggd, emb, counts)
    return project["runs"][key]


def _frame(side, tab, key):
    return get_dt(tab._scaled_frames, key) if side == "port" else jget_dt(tab._scaled_frames, key).to_numpy()


def _windows(side, part, key):
    return get_dt(part, key) if side == "port" else jget_dt(part, key)


@pytest.mark.parametrize("reuse", [True, False], ids=["reuse_scaled", "pretrained_scaler"])
@pytest.mark.parametrize("mode", list(MODES))
def test_past_the_budgets_matches(project, mode, reuse):
    (p_ggd, p_emb, p_counts) = _run(project, "port", mode, reuse)
    (i_ggd, i_emb, i_counts) = _run(project, "port", "in", reuse)
    (j_ggd, j_emb, j_counts) = _run(project, "jax", mode, reuse)
    tab = p_ggd[3]
    frames_kept_on_host = "DEVICE_FRAMES_BYTES" in MODES[mode]
    assert sorted(tab._scaled_host) == (list(KEYS) if frames_kept_on_host else [])
    assert sorted(tab._scaled_device) == ([] if frames_kept_on_host else list(KEYS))
    for key in KEYS:
        if frames_kept_on_host:
            assert tab._scaled_host[key].dtype == np.float32
            assert tab._scaled_host[key].shape == (T, 158)
        got = _frame("port", tab, key)
        # Against the JAX package past the same budgets: the general route's
        # bar where the scaling pass gave way to it, the device route's else.
        general = "DEVICE_SCALE_BUDGET_BYTES" in MODES[mode]
        assert _rel(got, _frame("jax", j_ggd[3], key)) <= (1e-8 if general else 1e-5)
        want = _frame("port", i_ggd[3], key)
        if general:
            assert _rel(got, want) <= 1e-5
        else:
            np.testing.assert_array_equal(got, want)
            for g, w in zip(_windows("port", p_ggd[0][0], key), _windows("port", i_ggd[0][0], key)):
                np.testing.assert_array_equal(g, w)
        for g, w in zip(_windows("port", p_ggd[0][0], key), _windows("jax", j_ggd[0][0], key)):
            assert _rel(g, w) <= (1e-8 if general else 1e-5)
        assert _rel(p_emb[key], j_emb[key].to_numpy()) <= 1e-5
        assert _rel(p_counts[key], j_counts[key].to_numpy()) <= 1e-5
        if general:
            assert _rel(p_emb[key], i_emb[key]) <= 1e-5
        else:
            np.testing.assert_array_equal(p_emb[key], i_emb[key])
            np.testing.assert_array_equal(p_counts[key], i_counts[key])


def test_general_route_streams_past_the_scaling_budget(project, monkeypatch):
    """Robust scaling takes the general route; within the scaling budget it
    keeps each recording's pass-1 scaling for pass 3, past it it scales each
    recording again there: the same frames, one more local scaling each."""
    coords = project["port"][1]
    calls = []
    real = ptd.scale_table
    monkeypatch.setattr(ptd, "scale_table", lambda *a, **k: calls.append(1) or real(*a, **k))
    kept = coords.get_graph_dataset(window_size=WINDOW, scale="robust")[3]
    n_kept = len(calls)
    monkeypatch.setattr(ptd, "DEVICE_SCALE_BUDGET_BYTES", 1)
    streamed = coords.get_graph_dataset(window_size=WINDOW, scale="robust")[3]
    assert n_kept == len(KEYS) and len(calls) - n_kept == 2 * len(KEYS)
    for key in KEYS:
        np.testing.assert_array_equal(get_dt(streamed._scaled_frames, key), get_dt(kept._scaled_frames, key))


# --------------------------------------------------------------------------- #
# Projections
# --------------------------------------------------------------------------- #


def _tables(seed, n=5, f=12):
    rng = np.random.default_rng(seed)
    arrays = {f"rec{i}": rng.normal(size=(40 + i, f)) * rng.uniform(0.5, 3.0, size=f) + rng.normal(size=f)
              for i in range(n)}
    columns = [f"c{j}" for j in range(f)]
    port = ptd.TableDict({k: LazyFrame(lambda a=a: a, columns, len(a)) for k, a in arrays.items()}, typ="coords")
    jax_td = jtd.TableDict({k: pd.DataFrame(a, columns=columns) for k, a in arrays.items()}, typ="coords")
    means = np.stack([a.mean(axis=0) for a in arrays.values()])
    return port, jax_td, means


@pytest.mark.parametrize("kernel", ptd.KERNELS)
@pytest.mark.parametrize("n_components", [2, 3])
def test_pca_matches_sklearn_and_jax(kernel, n_components):
    port, jax_td, means = _tables(1)
    got, proj = port.pca(n_components=n_components, kernel=kernel, device="cpu")
    sk = KernelPCA(n_components=n_components, kernel=kernel)
    want = sk.fit_transform(means)
    j_x, j_proj = jax_td.pca(n_components=n_components, kernel=kernel)
    assert got.shape == want.shape == (5, n_components) and proj.kind == "pca"
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * max(1.0, np.abs(want).max()))
    np.testing.assert_allclose(got, j_x, rtol=0, atol=1e-10 * max(1.0, np.abs(want).max()))
    np.testing.assert_allclose(proj.eigenvalues.numpy(), sk.eigenvalues_, rtol=1e-10, atol=1e-12)
    new = np.random.default_rng(2).normal(size=(3, means.shape[1]))
    np.testing.assert_allclose(proj.transform(new), sk.transform(new), rtol=0, atol=1e-9)


def test_pca_on_device_frames_and_nan():
    port, _, means = _tables(3)
    frames = {k: torch.as_tensor(get_dt(port, k)) for k in port}
    port._device_frames = frames  # read where they lie (the CPU here)
    got, _ = port.pca()
    np.testing.assert_allclose(got, KernelPCA(n_components=2).fit_transform(means), rtol=0, atol=1e-10)
    frames["rec0"][3, 1] = np.nan
    with pytest.raises(ValueError, match="NaN"):
        port.pca()
    with pytest.raises(ValueError, match="Unknown kernel"):
        ptd.TableDict(dict(port), typ="coords").pca(kernel="laplacian", device="cpu")


@pytest.mark.parametrize("n_components", [2, 4])
def test_random_projection_matches_sklearn_and_jax(n_components):
    port, jax_td, means = _tables(4)
    outs = []
    for fn in (lambda: port.random_projection(n_components=n_components, device="cpu"),
               lambda: (GaussianRandomProjection(n_components=n_components).fit_transform(means), None),
               lambda: jax_td.random_projection(n_components=n_components)):
        np.random.seed(7)
        outs.append(fn())
    (got, proj), (want, _), (j_x, _) = outs
    assert got.shape == (5, n_components) and proj.kind == "random"
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got, j_x, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(proj.transform(means), want, rtol=1e-12, atol=1e-12)
    # More components than features: sklearn's warning, the same draw.
    np.random.seed(7)
    with pytest.warns(UserWarning, match="higher than the number of features"):
        port.random_projection(n_components=20, device="cpu")


def test_projections_default_to_cuda_and_umap_needs_its_package(monkeypatch):
    port, _, _ = _tables(5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.pca()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.random_projection()
    monkeypatch.setitem(sys.modules, "umap", None)
    with pytest.raises(ImportError, match="umap-learn"):
        port.umap()


# --------------------------------------------------------------------------- #
# precomputed_tab_dict and scale_tables
# --------------------------------------------------------------------------- #


def test_precomputed_tab_dict_matches_jax(project, monkeypatch):
    """The tables a user merged (arena-centred coordinates, speeds,
    distances) as ``precomputed_tab_dict``: the graph dataset's columns,
    scaled frames (the device route, 1e-5) and windows."""
    monkeypatch.setenv("DEEPOF_TPU_DEVICE_SCALE", "1")
    (_, j_coords), (_, p_coords) = project["jax"], project["port"]
    j_tab = j_coords.get_coords(center="arena").merge(j_coords.get_coords(speed=1), j_coords.get_distances())
    p_tab = p_coords.get_coords(center="arena").merge(p_coords.get_coords(speed=1), p_coords.get_distances())
    (j_ds, j_meta, j_adj, j_out, _) = j_coords.get_graph_dataset(window_size=WINDOW, precomputed_tab_dict=j_tab)
    (p_ds, p_meta, p_adj, p_out, _) = p_coords.get_graph_dataset(window_size=WINDOW, precomputed_tab_dict=p_tab)
    assert p_out is p_tab
    np.testing.assert_array_equal(p_adj, np.asarray(j_adj))
    for name in ("node_columns", "edge_columns", "angle_columns"):
        assert p_meta[name] == list(j_meta[name])
    assert len(p_meta["node_columns"]) == 84 and p_meta["angle_columns"] == []
    assert p_meta["shape_train"] == j_meta["shape_train"]
    for key in KEYS:
        assert _rel(_frame("port", p_out, key), _frame("jax", j_out, key)) <= 1e-5
        for g, w in zip(_windows("port", p_ds[0], key), _windows("jax", j_ds[0], key)):
            assert _rel(g, w) <= 1e-5


def test_scale_tables_matches_jax(project):
    (j_proj, _), (p_proj, _) = project["jax"], project["port"]
    root = project["root"]
    raw = {key: preaders.load_table(f"{key}DLC_fixture.csv", f"{root}/Tables", "csv").positions for key in KEYS}
    want = j_proj.scale_tables(raw)
    got = p_proj.scale_tables(raw)
    for key in KEYS:
        assert got[key].dtype == raw[key].dtype
        np.testing.assert_array_equal(got[key], want[key])
        on_tensor = p_proj.scale_tables({key: torch.as_tensor(raw[key])})[key]
        assert isinstance(on_tensor, torch.Tensor)
        np.testing.assert_array_equal(on_tensor.numpy(), want[key])
    fresh = Project(**_project_args(root, "csv"), device="cpu")
    with pytest.raises(ValueError, match="before scale_tables"):
        fresh.scale_tables(raw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(AssertionError, match="before scale_tables"):
            JaxProject(**_project_args(root, "csv")).scale_tables(raw)
