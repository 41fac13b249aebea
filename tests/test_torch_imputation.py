"""Full imputation (``iterative_imputation="full"``) against the JAX package,
on the CPU: ``deepof_tpu_torch/ops/imputation.py`` and
``ops/kalman_kernels.py`` (the Kalman/RTS kernel's plain version) against
``deepof_tpu/ops/imputation.py``, then ``Project(iterative_imputation=
"full").create(test=True)`` and the slice through ``get_graph_dataset`` and
``embedding_per_video`` against the JAX package's, with transplanted
weights.

Inputs are made from seeds with numpy and handed to both packages. The JAX
imputation programs run at fixed shapes (T = 2,000, B = 14), each compiled
once a module. The port runs on one torch thread.

Bars (float32 unless said), each the smallest the case meets:
- Kalman/RTS: equal to the JAX scan (its FMAs written out) at T = 2,000
  and 3; at T = 2, 1 float32 unit (2e-7 of max(1, |x|)); T = 1 exactly;
- the ridge sweep: 1.5e-5 of max |x| after one round, 4e-5 after ten
  (1.0e-5 and 3.0e-5 seen: float32 Gram matrices summed in another order
  than XLA's, and solved by another LAPACK path, on near-collinear
  columns), observed entries exactly;
- the constraints: 2e-7 of max |x|; rest lengths exactly (float64, numpy
  on both sides);
- the created project (float64 tables holding float32 imputations): 5e-7
  of max(1, |x|) (3.4e-7 seen, the ridge's), NaN patterns and presence
  equal;
- scaled frames 2e-4 of max(1, |x|) (1.3e-4 seen: the imputed positions'
  last float32 bits, divided by the local deviations of the speeds and
  distances; the partial path's frames meet 1e-5 from equal tables,
  ``tests/test_torch_public.py``), embeddings and soft counts 1e-5 (the
  north star; 1.2e-6 seen).
"""

import os
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepof_tpu.core.storage import get_dt as jget_dt
from deepof_tpu.data import Project as JaxProject
from deepof_tpu.ops import imputation as jimp
from deepof_tpu.train.inference import embedding_per_video as jax_embed

from deepof_tpu_torch.core.graph import build_body_graph
from deepof_tpu_torch.core.storage import get_dt
from deepof_tpu_torch.data import Project
from deepof_tpu_torch.ops import imputation as pimp
from deepof_tpu_torch.ops import kalman_kernels
from deepof_tpu_torch.train.inference import embedding_per_video

from test_torch_encoders import one_torch_thread  # noqa: F401 (an autouse fixture of this module too)
from test_torch_public import BODYPARTS, LATENT, WINDOW, _bundles, _project_args, _recording, _write_csv

T_IMP, B_IMP = 2_000, 14
EDGES = [tuple(int(v) for v in e) for e in build_body_graph(BODYPARTS).edges]
T_PROJ = 300


def _rel(got, want, scale=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    scale = max(1.0, float(np.abs(want[ok]).max())) if scale is None else scale
    return float(np.abs(got[ok] - want[ok]).max(initial=0.0)) / scale


def _walk(rng, t, b=B_IMP):
    """A seeded (t, b, 2) skeleton walk: one walk an animal, each bodypart
    at its offset with 1 px jitter."""
    base = rng.normal(size=(t, 1, 2)).cumsum(axis=0) * 2.0 + 300.0
    return (base + rng.normal(scale=15.0, size=(1, b, 2)) + rng.normal(size=(t, b, 2))).astype(np.float32)


# --------------------------------------------------------------------------- #
# Kalman / RTS
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def jax_kalman():
    return jax.jit(jimp.kalman_rts_smooth)


@pytest.mark.parametrize("t, tol", [(T_IMP, 0.0), (3, 0.0), (2, 2e-7), (1, 0.0)])
def test_kalman_rts_matches_jax(jax_kalman, t, tol):
    z = _walk(np.random.default_rng(t), t)
    want = np.asarray(jax_kalman(jnp.asarray(z)))
    got = pimp.kalman_rts_smooth(torch.from_numpy(z))
    assert got.dtype == torch.float32 and got.shape == z.shape
    assert _rel(got.numpy(), want) <= tol
    # The plain version is the function on the CPU: same bits.
    flat = torch.from_numpy(z.reshape(t, -1))
    np.testing.assert_array_equal(kalman_kernels.kalman_rts_plain(flat).numpy(), got.numpy().reshape(t, -1))


def test_kalman_gains_workspace():
    """The kernel's workspace rows: the filter gain at steps 1..T-1, the
    smoother gain at 0..T-2, both decaying from the first step's P0."""
    g = kalman_kernels.kalman_gains(50)
    assert g.dtype == np.float32 and g.shape == (50, 8)
    assert (g[0, 4:] == 0).all() and (g[-1, :4] == 0).all() and (g[:, 6:] == 0).all()
    assert 0.99 < g[1, 4] < 1.0 and g[-1, 4] < g[1, 4]
    assert kalman_kernels.kalman_gains(1).shape == (1, 8)


def test_kalman_rts_checks_its_input():
    z = torch.zeros((5, 3))
    with pytest.raises(ValueError, match=r"\(T, C\)"):
        kalman_kernels.kalman_rts(z[None])
    with pytest.raises(TypeError, match="float32"):
        kalman_kernels.kalman_rts(z.double())
    with pytest.raises(ValueError, match="contiguous"):
        kalman_kernels.kalman_rts(torch.zeros((3, 5)).T)
    with pytest.raises(ValueError, match="one frame"):
        kalman_kernels.kalman_rts(torch.zeros((0, 3)))
    before = kalman_kernels.kalman_rts.launches
    kalman_kernels.kalman_rts(z)
    assert kalman_kernels.kalman_rts.launches == before  # the CPU runs the plain version


# --------------------------------------------------------------------------- #
# Iterative ridge
# --------------------------------------------------------------------------- #


def _gappy(seed):
    """(T_IMP, 28) float32 positions with NaN runs of 4-60 frames in several
    columns, and a constant column."""
    rng = np.random.default_rng(seed)
    x = _walk(rng, T_IMP).reshape(T_IMP, -1)
    x[:, 5] = 7.0
    for c in (0, 3, 9, 20, 21, 27):
        for _ in range(3):
            start, length = rng.integers(0, T_IMP - 60), rng.integers(4, 61)
            x[start:start + length, c] = np.nan
    return x


@pytest.fixture(scope="module")
def jax_ridge():
    return {n: jax.jit(lambda x, n=n: jimp.iterative_ridge_impute(x, n_rounds=n)) for n in (1, 10)}


@pytest.mark.parametrize("n_rounds, tol", [(1, 1.5e-5), (10, 4e-5)])
def test_iterative_ridge_matches_jax(jax_ridge, n_rounds, tol):
    x = _gappy(n_rounds)
    want = np.asarray(jax_ridge[n_rounds](jnp.asarray(x)))
    got = pimp.iterative_ridge_impute(torch.from_numpy(x), n_rounds=n_rounds).numpy()
    obs = np.isfinite(x)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[obs], x[obs])
    assert _rel(got, want, float(np.abs(want).max())) <= tol


# --------------------------------------------------------------------------- #
# Skeleton constraints
# --------------------------------------------------------------------------- #


def test_estimate_skeleton_constraints_exact():
    rng = np.random.default_rng(5)
    data = _walk(rng, 450).astype(np.float64)
    data[rng.random(450) < 0.3, 4] = np.nan
    want = jimp.estimate_skeleton_constraints(data, EDGES)
    assert pimp.estimate_skeleton_constraints(data, EDGES) == want
    # From a tensor: the complete frames found where it lies, the same rest lengths.
    assert pimp.estimate_skeleton_constraints(torch.from_numpy(data), EDGES) == want
    assert pimp.estimate_skeleton_constraints(data, EDGES, n_samples=7) == jimp.estimate_skeleton_constraints(
        data, EDGES, n_samples=7)
    data[:, 2, 1] = np.nan
    for est in (jimp.estimate_skeleton_constraints, pimp.estimate_skeleton_constraints):
        with pytest.raises(ValueError, match="No complete frames"):
            est(data, EDGES)
    with pytest.raises(ValueError, match="No complete frames"):
        pimp.estimate_skeleton_constraints(torch.from_numpy(data), EDGES)


def test_enforce_skeleton_constraints_matches_jax():
    """Frames whose bodypart 0 is original are skipped; elsewhere the three
    endpoint rules (a original, b original, neither), read from the x flag
    only, move the imputed parts toward rest lengths 20% off the data's."""
    rng = np.random.default_rng(6)
    data = _walk(rng, T_IMP)
    constraints = [(i, j, r * 1.2) for i, j, r in jimp.estimate_skeleton_constraints(data, EDGES)]
    original = rng.random((T_IMP, B_IMP, 2)) < 0.5
    original[: T_IMP // 4, 0] = True  # a quarter of the frames skipped
    want = np.asarray(jimp.enforce_skeleton_constraints(jnp.asarray(data), constraints, jnp.asarray(original)))
    got = pimp.enforce_skeleton_constraints(torch.from_numpy(data), constraints, torch.from_numpy(original))
    assert got.dtype == torch.float32
    got = got.numpy()
    skipped = original[:, 0].all(axis=-1)
    np.testing.assert_array_equal(got[skipped], data[skipped])
    assert not np.allclose(got[~skipped], data[~skipped])  # the rules moved something
    assert _rel(got, want, float(np.abs(want).max())) <= 2e-7


# --------------------------------------------------------------------------- #
# The project and the slice
# --------------------------------------------------------------------------- #


def _write_occluded_project(root):
    """Two recordings of two deepof_14 animals (``test_torch_public``'s
    synthesizer: jumps, low-likelihood frames, W absent for 12 frames of
    "test") with occlusion runs of 4-60 frames over a third of B's and W's
    bodyparts; in "test2" W's Nose is lost throughout, so W has no complete
    frame there."""
    os.makedirs(f"{root}/Tables")
    os.makedirs(f"{root}/Videos")
    rng = np.random.default_rng(11)
    for key in ("test", "test2"):
        values, cols = _recording(rng, T_PROJ, key)
        lik_cols = [i for i, c in enumerate(cols) if c[3] == "likelihood"]
        for i in rng.choice(lik_cols, len(lik_cols) // 3, replace=False):
            for _ in range(2):
                start, length = rng.integers(0, T_PROJ - 60), rng.integers(4, 61)
                values[start:start + length, i] = 0.05
        if key == "test2":
            values[:, cols.index(("fixture", "W", "Nose", "likelihood"))] = 0.05
        _write_csv(f"{root}/Tables/{key}DLC_fixture.csv", values, cols)
        open(f"{root}/Videos/{key}DLC_video.mp4", "wb").close()
    return root


@pytest.fixture(scope="module")
def full(tmp_path_factory):
    """Both packages' full-imputation projects, and the port's partial one."""
    root = _write_occluded_project(tmp_path_factory.mktemp("occluded"))
    mp = pytest.MonkeyPatch()
    mp.setenv("DEEPOF_TPU_DEVICE_SCALE", "1")
    try:
        with warnings.catch_warnings(record=True) as j_warn:
            warnings.simplefilter("always")
            j_coords = JaxProject(**_project_args(root, "csv"), iterative_imputation="full").create(
                force=True, test=True, verbose=False)
        j_ggd = j_coords.get_graph_dataset(window_size=WINDOW)
    finally:
        mp.undo()
    with warnings.catch_warnings(record=True) as p_warn:
        warnings.simplefilter("always")
        p_coords = Project(**_project_args(root, "csv"), iterative_imputation="full", device="cpu").create(
            force=True, test=True, verbose=False)
    partial = Project(**_project_args(root, "csv"), device="cpu").create(force=True, test=True, verbose=False)
    return {"jax": (j_coords, j_ggd), "port": (p_coords, p_coords.get_graph_dataset(window_size=WINDOW)),
            "partial": partial, "warnings": ([str(w.message) for w in j_warn], [str(w.message) for w in p_warn])}


def test_full_create_matches_jax(full):
    (j, _), (p, _) = full["jax"], full["port"]
    partial = full["partial"]
    assert list(p._tables) == list(j._tables) and set(p._tables) == {"test", "test2"}
    for key in j._tables:
        got, want = p._tables[key], np.asarray(j._tables[key], np.float64)
        assert got.dtype == np.float64
        assert _rel(got, want) <= 5e-7
        np.testing.assert_array_equal(p._presence[key], np.asarray(j._presence[key]))
        # Imputation filled gaps that linear interpolation left.
        assert np.isnan(partial._tables[key]).sum() > np.isnan(got).sum()
        # Every observed sample of a frame the constraints skip (bodypart 0
        # original) is the partial table's, stored in float32.
        for lo, hi in ((0, 14), (14, 28)):
            block = partial._tables[key][:, lo:hi]
            skipped = np.isfinite(block[:, 0]).all(axis=-1)
            obs = np.isfinite(block) & skipped[:, None, None]
            assert obs.sum() > 1_000
            np.testing.assert_allclose(got[:, lo:hi][obs], block[obs], rtol=2.0**-23, atol=0)
    # W of "test2" has no complete frame: left as it is, with the JAX package's warning.
    msg = "Animal W has not enough data. Skipping full imputation."
    assert msg in full["warnings"][0] and msg in full["warnings"][1]
    np.testing.assert_array_equal(p._tables["test2"][:, 14:], partial._tables["test2"][:, 14:])


def test_full_slice_matches_jax(full, monkeypatch):
    """get_graph_dataset -> embedding_per_video on the imputed projects, a
    VQ-VAE on the same weights in both packages."""
    monkeypatch.setenv("DEEPOF_TPU_DEVICE_SCALE", "1")
    (j_coords, (_, j_meta, _, j_tab, j_sc)), (p_coords, (_, p_meta, p_adj, p_tab, p_sc)) = (
        full["jax"], full["port"])
    for key in j_tab:
        assert _rel(get_dt(p_tab._scaled_frames, key), jget_dt(j_tab._scaled_frames, key).to_numpy()) <= 2e-4
    j_bundle, p_bundle = _bundles(p_adj, p_meta, use_angles=False)
    j_emb, j_counts = jax_embed(j_coords, j_tab, j_bundle, j_meta, global_scaler=j_sc, batch_size=64)
    p_emb, p_counts = embedding_per_video(p_coords, p_tab, p_bundle, p_meta, global_scaler=p_sc, batch_size=64)
    assert list(p_emb) == list(j_emb) and set(p_emb) == {"test", "test2"}
    for key in j_emb:
        assert p_emb[key].shape == (T_PROJ - WINDOW + 1, LATENT)
        assert _rel(p_emb[key], j_emb[key].to_numpy()) <= 1e-5
        assert _rel(p_counts[key], j_counts[key].to_numpy()) <= 1e-5
