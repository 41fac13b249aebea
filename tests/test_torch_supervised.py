"""The port's supervised annotation against the JAX package's, on the CPU:
``Coordinates.supervised_annotation`` with the built-in behavior battery,
the immobility classifier, custom behaviors and ``max_behaviour``, and the
ops under them (run-length filters, the paired smoothing cascade, polygon
geometry, pandas-style interpolation, the classifier's standardisation
and its numpy reductions).

Both packages create one project (device="cpu", float64 in the port) from
a seeded two-recording DeepLabCut csv: keys "test"/"test2" (the test
arenas: an ellipse and a polygon), 600 frames, two deepof_14 animals that
walk with 2 px bodypart jitter and rest, still but for 0.15 px jitter, on
frames 100-260 and 380-470 (B) and 150-300 (W); W drifts 120 px towards
the ellipse's wall over the last 120 frames and is absent on frames 90-101
of "test". Enough backbone rows are valid that each animal's length comes
from the seeded draw of 400+ rows (``np.random.seed(s)`` before the JAX
call, ``rng=np.random.RandomState(s)`` to the port).

Bars: binary tag columns equal on every frame, except ``immobility`` on at
most 1% of them (its speeds come from aligned coordinates held at 1e-8,
and it thresholds a float32 MLP); continuous columns at 1e-8; equal
labels in the JAX package's order. The conflict rule of the smoothing
cascade is held to the JAX cascade with ties resolved exactly: the JAX
package compares ``np.convolve`` averages, whose BLAS dot sums equal
counts in different orders, so ~0.1% of frames of random series break
ties on an ulp (counted in ``test_paired_smoothing_ties``); here
``deepof_tpu.ops.bouts``'s ``np.convolve`` is replaced, for the duration
of a call, by an exact count over the same window.
"""

import os
import types
import warnings

import numpy as np
import pandas as pd
import pytest
import torch

from deepof_tpu import annotate as jann
from deepof_tpu.core.storage import get_dt as jget_dt
from deepof_tpu.data import Project as JaxProject
from deepof_tpu.ops import bouts as jbouts
from deepof_tpu.ops import geometry as jgeom
from deepof_tpu.posthoc import _kinematics_table_views as jviews

from deepof_tpu_torch import annotate as pann
from deepof_tpu_torch.core.storage import DeviceTable
from deepof_tpu_torch.data import Project
from deepof_tpu_torch.ops import bouts as pbouts
from deepof_tpu_torch.ops import geometry as pgeom
from deepof_tpu_torch.ops.interp import interpolate_linear
from deepof_tpu_torch.posthoc import _kinematics_table_views as pviews

from test_torch_public import BODYPARTS, FPS, IDS, _project_args, _write_csv

T = 600
TOL = 1e-8
SEED = 7
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REST = {"B": [(100, 260), (380, 470)], "W": [(150, 300)]}
# Tolerances that let the arena, stationary and immobility rules fire on
# the fixture, beside the defaults.
LOOSE = {"climb_tol": -0.6, "sniff_arena_tol": 60, "stationary_threshold": 60, "min_immobility": 10,
         "close_contact_tol": 40}


# --------------------------------------------------------------------------- #
# Fixture
# --------------------------------------------------------------------------- #


def _recording(rng, key):
    """(values (T, C), DLC column tuples) of one two-animal recording."""
    cols, data = [], []
    for aid, start in zip(IDS, ((230.0, 200.0), (250.0, 205.0))):
        still = np.zeros(T, bool)
        for lo, hi in REST[aid]:
            still[lo:hi] = True
        steps = rng.normal(scale=1.5, size=(T, 2))
        steps[still] = 0.0
        if aid == "W":
            steps[T - 120:, 0] += 1.0
        base = steps.cumsum(axis=0) + np.array(start)
        jitter = np.where(still, 0.15, 2.0)[:, None]
        for bp in BODYPARTS:
            xy = base + rng.normal(scale=15.0, size=(1, 2)) + rng.normal(size=(T, 2)) * jitter
            lik = np.clip(rng.beta(20, 1, size=T), 0, 1)
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


def _exact_np():
    """numpy, with ``convolve`` by a constant kernel summed exactly: the
    window count times the kernel value (one rounding, monotone in the
    count), so equal counts compare equal."""
    def convolve(a, v, mode="full"):
        v = np.asarray(v, np.float64)
        if v.size and np.all(v == v[0]):
            counts = np.convolve(np.asarray(a, np.int64), np.ones(v.size, np.int64), mode)
            return counts * v[0]
        return np.convolve(a, v, mode)

    ns = types.SimpleNamespace(**{k: getattr(np, k) for k in dir(np) if not k.startswith("__")})
    ns.convolve = convolve
    return ns


@pytest.fixture
def exact_ties(monkeypatch):
    monkeypatch.setattr(jbouts, "np", _exact_np())


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    root = tmp_path_factory.mktemp("supervised_project")
    os.makedirs(root / "Tables")
    os.makedirs(root / "Videos")
    rng = np.random.default_rng(SEED)
    for key in ("test", "test2"):
        _write_csv(root / "Tables" / f"{key}DLC_fixture.csv", *_recording(rng, key))
        open(root / "Videos" / f"{key}DLC_video.mp4", "wb").close()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j_coords = JaxProject(**_project_args(root, "csv")).create(force=True, test=True, verbose=False)
    p_coords = Project(**{**_project_args(root, "csv"), "project_name": "port"}, device="cpu").create(
        force=True, test=True, verbose=False)
    return {"jax": j_coords, "port": p_coords, "cache": {}}


def _annotate(sides, params=None, seed=SEED, **kw):
    """Both packages' supervised tables (the JAX package's with exact
    conflict ties, and as it is), cached per arguments."""
    name = (repr(params), seed, repr(sorted(kw)))
    if name not in sides["cache"]:
        pann.supervised_annotation.host_reads.clear()
        got = sides["port"].supervised_annotation(params=params, verbose=False, rng=np.random.RandomState(seed),
                                                  **kw.get("port", {}))
        reads = dict(pann.supervised_annotation.host_reads)
        want = {}
        for exact in (True, False):
            mp = pytest.MonkeyPatch()
            if exact:
                mp.setattr(jbouts, "np", _exact_np())
            try:
                np.random.seed(seed)
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    want[exact] = sides["jax"].supervised_annotation(params=params, verbose=False,
                                                                     **kw.get("jax", {}))
            finally:
                mp.undo()
        sides["cache"][name] = (got, want[True], want[False], reads)
    return sides["cache"][name]


def _binary_columns(columns):
    continuous = ("distance", "cum-distance", "speed", "full-nose-tail")
    return [c for c in columns if not c.endswith(continuous)]


def _check_tables(got, want, immobility_share=0.01):
    """Labels, binary columns frame for frame (immobility on at most
    ``immobility_share`` of its frames) and continuous columns at 1e-8.
    Returns {column: differing frames} of the binary columns."""
    assert sorted(got) == sorted(want)
    counts = {}
    for key in want:
        a, b = got[key].realize(), want[key].to_numpy(np.float64)
        assert got[key].columns == list(want[key].columns)
        assert a.dtype == np.float64 and a.shape == b.shape and np.isfinite(a).all()
        binary = _binary_columns(got[key].columns)
        for j, col in enumerate(got[key].columns):
            if col in binary:
                assert set(np.unique(a[:, j])) <= {0.0, 1.0}
                counts[(key, col)] = int((a[:, j] != b[:, j]).sum())
            else:
                np.testing.assert_allclose(a[:, j], b[:, j], rtol=0, atol=TOL, err_msg=f"{key} {col}")
    for (key, col), n in counts.items():
        limit = immobility_share * T if col.endswith("immobility") else 0
        assert n <= limit, (key, col, n)
    return counts


# --------------------------------------------------------------------------- #
# Ops
# --------------------------------------------------------------------------- #


def _series_cases(rng, n=400):
    cases = [np.ones(n, bool), np.zeros(n, bool)]
    for p in (0.1, 0.5, 0.9):
        cases.append(rng.random(n) < p)
        cases.append(np.repeat(rng.random(n // 8 + 1) < p, 8)[:n])
    return cases


@pytest.mark.parametrize("lag", [6, 11, 12, 24, 25])
def test_run_length_ops_match_jax(lag, exact_ties):
    """filter_short, the binary median, np.convolve's "same" windows and
    the paired smoothing cascade (exact ties on the JAX side), frame for
    frame, on random and blocky series and all-True / all-False ones."""
    rng = np.random.default_rng(lag)
    for a in _series_cases(rng):
        t = torch.as_tensor(a)
        np.testing.assert_array_equal(pbouts.filter_short_true_segments(t, lag).numpy(),
                                      jbouts._filter_short_host(a, lag))
        np.testing.assert_array_equal(pbouts.binary_moving_median(t, lag).numpy(), jbouts._binary_median_host(a, lag))
        np.testing.assert_array_equal(pbouts.same_counts(t, lag).numpy(),
                                      np.convolve(a.astype(np.int64), np.ones(lag, np.int64), mode="same"))
        b = rng.random(len(a)) < 0.5
        ex = rng.random(len(a)) < 0.8
        for args in ((a,), (a, b, ex), (a, None, ex)):
            want = jbouts.multi_step_paired_smoothing_host(*args, min_length=lag, get_both=True)
            got = pbouts.multi_step_paired_smoothing(*[None if x is None else torch.as_tensor(x) for x in args],
                                                     min_length=lag, get_both=True)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), w)


def test_paired_smoothing_ties():
    """Against the JAX cascade as it is, the port differs only where a
    conflict frame's two window counts tie (the JAX side then breaks the
    tie on the order its BLAS dot sums): on no frame of a series without
    such a tie, and on under 1% of frames overall."""
    rng = np.random.default_rng(0)
    differ = total = tied_series = 0
    for i in range(60):
        lag = (6, 24)[i % 2]
        imm = np.repeat(rng.random(300) < 0.6, 10)
        act = np.repeat(rng.random(1000) < 0.5, 3)
        want = jbouts.multi_step_paired_smoothing_host(imm & act, imm & ~act, imm, lag, get_both=True)
        got = pbouts.multi_step_paired_smoothing(*(torch.as_tensor(x) for x in (imm & act, imm & ~act, imm)),
                                                 min_length=lag, get_both=True)
        n = sum(int((g.numpy() != w).sum()) for g, w in zip(got, want))
        b = pbouts.same_counts(torch.as_tensor(imm & act), lag) > 0
        nb = pbouts.same_counts(torch.as_tensor(imm & ~act), lag) > 0
        tie = (b & nb & (pbouts.same_counts(b, 4 * lag) == pbouts.same_counts(nb, 4 * lag))).any()
        tied_series += int(tie)
        if not tie:
            assert n == 0
        differ += n
        total += 2 * len(imm)
    assert tied_series > 0 and differ <= 0.01 * total, (tied_series, differ, total)


def test_point_polygon_matches_jax():
    """Distances at 1e-12 and inside flags against the JAX package's fused
    host op, on the polygonal test arena, a rotated ellipse and NaN
    points; the ellipse's rasterisation at 1e-12."""
    rng = np.random.default_rng(1)
    poly = np.array([(108, 30), (539, 29), (533, 438), (104, 431), (108, 30)], float)
    ell = ((200.0, 195.0), (166.0, 169.0), 33.5)
    got_ell = pgeom.ellipse_to_polygon(np.asarray(ell[0]), np.asarray(ell[1]), ell[2])
    want_ell = jgeom.ellipse_to_polygon(np.asarray(ell[0]), np.asarray(ell[1]), ell[2])
    np.testing.assert_allclose(got_ell, want_ell, rtol=0, atol=1e-12)
    pts = rng.uniform(0, 600, size=(2000, 2))
    pts[::50, 0] = np.nan
    pts[7::50] = np.inf
    pts[11] = poly[1]  # a vertex
    for polygon in (poly, want_ell, np.array(poly[::-1])):
        dist, inside = pgeom.point_polygon(torch.as_tensor(pts), polygon)
        want_d, want_in = jgeom.point_polygon_host(pts, polygon)
        np.testing.assert_array_equal(np.isnan(dist.numpy()), np.isnan(want_d))
        np.testing.assert_allclose(dist.numpy(), want_d, rtol=0, atol=1e-12, equal_nan=True)
        np.testing.assert_array_equal(inside.numpy(), np.asarray(want_in, bool))
        assert 0 < inside.numpy().mean() < 1


@pytest.mark.parametrize("direction", ["forward", "both"])
def test_interpolate_linear_matches_pandas(direction):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(50, 4))
    x[:3, 0] = np.nan          # leading
    x[10:14, 0] = np.nan       # inner
    x[-5:, 0] = np.nan         # trailing
    x[:, 1] = np.nan           # all NaN
    x[rng.random(50) < 0.3, 2] = np.nan
    x[np.arange(50) != 20, 3] = np.nan  # one value
    got = interpolate_linear(torch.as_tensor(x), limit_direction=direction).numpy()
    kw = {"limit_direction": "both"} if direction == "both" else {}
    want = pd.DataFrame(x).interpolate(**kw).to_numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12, equal_nan=True)


def test_numpy_reductions():
    """nanmedian and nanpercentile (linear) against numpy in float64 and
    float32, even and odd counts, NaNs and all-NaN columns."""
    rng = np.random.default_rng(3)
    for dtype in (np.float64, np.float32):
        x = rng.normal(size=(101, 6)).astype(dtype)
        x[rng.random(x.shape) < 0.2] = np.nan
        x[:, 5] = np.nan
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            np.testing.assert_array_equal(pann.nanmedian(torch.as_tensor(x), 0).numpy(), np.nanmedian(x, axis=0))
            np.testing.assert_array_equal(pann.nanmedian(torch.as_tensor(x[:10]), 1).numpy(),
                                          np.nanmedian(x[:10], axis=1))
            for q in (1, 50, 80, 99):
                got = pann.nanpercentile(torch.as_tensor(x), q, 0).numpy()
                want = np.nanpercentile(x, q, axis=0)
                assert got.dtype == want.dtype
                np.testing.assert_allclose(got, want, rtol=1e-6 if dtype == np.float32 else 1e-15, equal_nan=True)


@pytest.mark.parametrize("shape", [(5, 1, 11), (3, 2, 5)], ids=["default", "wide_windows"])
def test_augment_and_standardize(shape):
    """augment_with_neighbors against the JAX function (labels, values,
    NaNs), the standardisation against sklearn's StandardScaler with a
    constant and a near-constant column."""
    from sklearn.preprocessing import StandardScaler

    window, step, window_out = shape
    rng = np.random.default_rng(4)
    cols = ["('B_Center', 'B_Spine_2')_raw", "B_head_area_raw", "B_Center_speed", "B_Nose_speed", "B_Tail_base_speed"]
    x = rng.gamma(2.0, 20.0, size=(120, len(cols)))
    x[30:33, 2] = np.nan
    x[:, 4] = 3.0
    want = jann.augment_with_neighbors(pd.DataFrame(x, columns=cols), window, step, window_out)
    got = pann.augment_with_neighbors(DeviceTable(torch.as_tensor(x), cols), window, step, window_out)
    assert got.columns == list(want.columns)
    np.testing.assert_allclose(got.values.numpy(), want.to_numpy(), rtol=1e-15, atol=0, equal_nan=True)
    z = np.nan_to_num(want.to_numpy())
    z[:, 0] = 5.0 + 1e-14 * np.arange(len(z))
    np.testing.assert_allclose(pann.standard_scale(torch.as_tensor(z)).numpy(), StandardScaler().fit_transform(z),
                               rtol=0, atol=1e-12)


def test_classifier_logits_match_jax():
    """The packaged MLP's logits against the JAX package's weights and
    forward at 1e-5 of their largest, and its predictions equal to
    ``PretrainedImmobilityClassifier.predict`` wherever |logit| > 1e-4."""
    rng = np.random.default_rng(5)
    speeds = rng.gamma(2.0, 20.0, size=(800, 11))
    speeds[200:420] *= 0.05  # resting frames
    x = np.repeat(speeds, 11, axis=1) * rng.uniform(0.9, 1.1, size=(800, 121))
    x = (x - x.mean(axis=0)) / x.std(axis=0)
    z = np.asarray(x, np.float32)
    w = jann.PretrainedImmobilityClassifier()._load()
    z = z - np.nanpercentile(z, 1, axis=0)
    want = (np.maximum(z @ w["w0"] + w["b0"], 0.0) @ w["w1"] + w["b1"]).ravel()
    est = pann.PretrainedImmobilityClassifier()
    got = est.logits(torch.as_tensor(x)).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    clear = np.abs(got) > 1e-4
    pred = jann.PretrainedImmobilityClassifier().predict(x)
    assert 0 < pred.mean() < 1
    np.testing.assert_array_equal(est.predict(torch.as_tensor(x)).numpy()[clear], pred[clear])


def test_classifier_asset_is_the_jax_packages():
    ours = os.path.join(REPO, "deepof_tpu_torch", "assets", "immobility_classifier.npz")
    with open(ours, "rb") as a, open(os.path.join(REPO, "deepof_tpu", "assets", "immobility_classifier.npz"), "rb") as b:
        assert a.read() == b.read()


# --------------------------------------------------------------------------- #
# Detectors on the fixture project
# --------------------------------------------------------------------------- #


def _tables(sides, key):
    """{name: (JAX DataFrame, port DeviceTable)} of one recording."""
    jc, pc = sides["jax"], sides["port"]
    pairs = [(f"{aid}_{a}", f"{aid}_{b}") for aid in IDS for a, b in jann.IMMOBILITY_FEATURES_DISTS]
    j_views = jviews(jc, views=IDS, include_angles=False, file_name=None, distance_pairs=pairs)
    p_views = pviews(pc, IDS, key, distance_pairs=pairs)
    return {
        "raw": (jc.get_coords_at_key(key).reset_index(drop=True), DeviceTable(*pc.get_coords_at_key(key, _device=True))),
        "dists": (jc.get_distances_at_key(key).reset_index(drop=True),
                  DeviceTable(*pc.get_distances_at_key(key, _device=True))),
        "speeds": (jc.get_coords_at_key(key, speed=1).reset_index(drop=True),
                   DeviceTable(*pc.get_coords_at_key(key, speed=1, _device=True))),
        "lik": (jget_dt(jc.get_quality(), key).reset_index(drop=True),
                DeviceTable(torch.as_tensor(pc._quality[key], dtype=torch.float64), pc._nodes)),
        "features": (jget_dt(j_views["B"], key), p_views["B"]),
    }


def _close_range(mod, tabs, aid):
    return mod.calculate_close_range(tabs["dists"], f"{aid}_", "Nose", 50)


DETECTORS = {
    "nose2nose": lambda m, t, s, k: m.close_single_contact(t["raw"], "B_Nose", "W_Nose", 40),
    "nose2body": lambda m, t, s, k: m.close_single_contact(t["raw"], "W_Nose", ["B_Center", "B_Spine_1", "B_Left_ear"],
                                                           40),
    "sidebyside": lambda m, t, s, k: m.close_double_contact(t["raw"], "B_Nose", "B_Tail_base", "W_Nose",
                                                            "W_Tail_base", 50),
    "sidereside": lambda m, t, s, k: m.close_double_contact(t["raw"], "B_Nose", "B_Tail_base", "W_Nose",
                                                            "W_Tail_base", 50, rev=True),
    "climb_arena": lambda m, t, s, k: m.climb_arena("circular-autodetect", s["port"]._arena_params[k], t["raw"], -0.6,
                                                    "W_", mouse_len=45.5),
    "sniff_object": lambda m, t, s, k: m.sniff_object(t["speeds"], s["port"]._arena_params[k], t["raw"], 60, 60,
                                                      "W_Nose", animal_id="W"),
    "following_path": lambda m, t, s, k: m.following_path(t["dists"], t["raw"], t["speeds"], "B", "W", 12, 25, 40),
    "following_path_reverse": lambda m, t, s, k: m.following_path(t["dists"], t["raw"], t["speeds"], "W", "B", 12, 25,
                                                                  40),
    "calculate_close_range": lambda m, t, s, k: _close_range(m, t, "W"),
    "smoothed_immobility": lambda m, t, s, k: m._smoothed_immobility(t["speeds"]["B_Center"], 40, 6),
    "stationary_lookaround": lambda m, t, s, k: m.stationary_lookaround(
        t["speeds"], t["dists"], t["lik"], "B_", _close_range(m, t, "B"), 60, 0.85, 6, animal_id="B"),
    "detect_activity": lambda m, t, s, k: m.detect_activity(t["speeds"], t["lik"], 40, 0.85, 6, animal_id="B"),
    "digging": lambda m, t, s, k: m.digging(t["speeds"], t["dists"], t["lik"], "W_", _close_range(m, t, "W"), 60,
                                            0.85, 6, animal_id="W"),
    "sniff_around": lambda m, t, s, k: m.sniff_around(t["speeds"], t["lik"], 40, 0.85, animal_id="W"),
    "rearing": lambda m, t, s, k: m.rearing(t["raw"], t["speeds"], rearing_tol=30, tol_speed=40, animal_id="B"),
    "immobility": lambda m, t, s, k: m.immobility(t["features"], m.PretrainedImmobilityClassifier(), "B_", 12, 10)[0],
}


@pytest.mark.parametrize("key", ["test", "test2"])
@pytest.mark.parametrize("name", sorted(DETECTORS))
def test_detector_matches_jax(sides, name, key, exact_ties):
    """Each detector on both packages' tables of one recording, frame for
    frame (the cascade's ties exact on the JAX side)."""
    if key not in sides["cache"]:
        sides["cache"][key] = _tables(sides, key)
    tabs = sides["cache"][key]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = DETECTORS[name](jann, {k: v[0] for k, v in tabs.items()}, sides, key)
    got = DETECTORS[name](pann, {k: v[1] for k, v in tabs.items()}, sides, key)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(bool), np.asarray(w).astype(bool))


def test_detectors_fire_on_the_fixture(sides):
    """Every detector but the experimental digging rule (head down while
    nosing about, which the fixture's random bodyparts never hold for six
    frames) is True on some frames of the recordings, so that the
    comparisons above are not of all-False series."""
    fired = dict.fromkeys(DETECTORS, 0)
    for key in ("test", "test2"):
        if key not in sides["cache"]:
            sides["cache"][key] = _tables(sides, key)
        tabs = {k: v[1] for k, v in sides["cache"][key].items()}
        for name, detector in DETECTORS.items():
            got = detector(pann, tabs, sides, key)
            fired[name] += sum(int(g.to(torch.bool).sum()) for g in (got if isinstance(got, tuple) else (got,)))
    assert all(n > 0 for name, n in fired.items() if name != "digging"), fired


def test_kinematics_views_match_jax(sides):
    """The per-animal kinematics tables (restricted and unrestricted
    distances, areas, centred and aligned speeds): labels, values at 1e-8
    and NaNs, against the JAX package's views."""
    jc, pc = sides["jax"], sides["port"]
    pairs = [(f"{aid}_{a}", f"{aid}_{b}") for aid in IDS for a, b in jann.IMMOBILITY_FEATURES_DISTS]
    for restrict in (pairs, None):
        want = jviews(jc, views=IDS, include_angles=False, file_name=None, distance_pairs=restrict)
        for key in ("test", "test2"):
            got = pviews(pc, IDS, key, distance_pairs=restrict)
            for aid in IDS:
                w = jget_dt(want[aid], key)
                assert got[aid].columns == list(w.columns)
                np.testing.assert_allclose(got[aid].values.numpy(), w.to_numpy(np.float64), rtol=0, atol=TOL,
                                           equal_nan=True)
            assert len(got["B"].columns) == (11 if restrict else 91) + 4 + 14


def test_device_getters_match_host_getters(sides):
    """The getters' device route gives the values and labels of the
    public getters, the missing-animal NaN included."""
    pc = sides["port"]
    for method, kw in (("get_coords", {}), ("get_coords", {"speed": 1, "center": "Center", "align": "Spine_1"}),
                       ("get_distances", {}), ("get_angles", {"degrees": True}), ("get_areas", {})):
        want = getattr(pc, method)(**kw)["test"]
        arr, cols = getattr(pc, f"{method}_at_key")("test", _device=True, **kw)
        assert isinstance(arr, torch.Tensor) and cols == want.columns
        np.testing.assert_array_equal(arr.numpy().astype(np.float64), want.realize())
        assert np.isnan(want.realize()[90:102]).any()


# --------------------------------------------------------------------------- #
# The entry point
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("params", [None, LOOSE], ids=["defaults", "loose"])
def test_supervised_annotation_matches_jax(sides, params):
    """The whole supervised table of both recordings: 33 labels in the JAX
    package's order, binary columns frame for frame against the JAX
    package with exact conflict ties (immobility within 1%), continuous at
    1e-8; against the JAX package as it is, the cascade columns differ on
    under 1% of frames. The port reads the host twice a recording (the
    length draw's rows, once an animal) besides the table's one copy."""
    got, want, as_is, reads = _annotate(sides, params)
    counts = _check_tables(got, want)
    print({k: v for k, v in counts.items() if v})
    assert len(got["test"].columns) == 33
    assert got._type == "supervised" and got._animal_ids == IDS
    assert reads == {"mouse_lens_rows": 4, "tag_table": 2}
    cascade = ("stat-lookaround", "stat-active", "stat-passive", "moving")
    for key in got:
        a, b = got[key].realize(), as_is[key].to_numpy(np.float64)
        for j, col in enumerate(_binary_columns(got[key].columns)):
            j = got[key].columns.index(col)
            n = int((a[:, j] != b[:, j]).sum())
            assert n <= (0.01 * T if col.endswith(cascade) else counts[(key, col)]), (key, col, n)
    missing = got["test"].realize()[:, got["test"].columns.index("W_missing")]
    assert missing[90:102].all() and missing.sum() == 12
    if params:
        fired = {c for key in got for c, v in zip(got[key].columns, got[key].realize().any(axis=0)) if v}
        for behavior in ("climb-arena", "sniff-arena", "immobility", "stat-lookaround", "stat-passive"):
            assert any(c.endswith(behavior) for c in fired), behavior


def test_mouse_lens_draw_follows_the_seed():
    """An animal's length: the 80th percentile of its summed backbone
    segments over up to 5,000 rows drawn without replacement from those
    where the backbone is tracked (the JAX package's lines,
    deepof_tpu/annotate.py:985-1007, restated on a 6,000-row table so
    that the draw is a proper subset). The same seed draws the same rows
    in both; another seed draws others; under 400 tracked rows it is 50."""
    rng = np.random.default_rng(6)
    backbone = [f"B_{bp}" for bp in ("Nose", "Spine_1", "Center", "Spine_2", "Tail_base")]
    values = rng.normal(scale=20.0, size=(6000, 2 * len(backbone)))
    values[rng.random(6000) < 0.1, 3] = np.nan
    cols = [(bp, ax) for bp in backbone for ax in ("x", "y")]
    raw = pd.DataFrame(values, columns=pd.MultiIndex.from_tuples(cols))

    def jax_lines(seed):
        np.random.seed(seed)
        valid = raw.dropna(subset=cols)
        idx = np.random.choice(valid.index, size=min(5000, len(valid)), replace=False)
        total = np.zeros(len(idx))
        for i in range(len(backbone) - 1):
            total += np.linalg.norm(raw[backbone[i + 1]].loc[idx].to_numpy(float)
                                    - raw[backbone[i]].loc[idx].to_numpy(float), axis=1)
        return np.nanpercentile(total, 80)

    table = DeviceTable(torch.as_tensor(values), cols)
    lens = [float(pann._mouse_length(table, backbone, np.random.RandomState(s))) for s in (SEED, SEED + 1)]
    assert lens == [jax_lines(SEED), jax_lines(SEED + 1)] and lens[0] != lens[1]
    assert pann._mouse_length(DeviceTable(torch.as_tensor(values[:420]), cols), backbone, np.random) == 50


def _custom_pair(port):
    """One custom behavior of each scope, for one package."""
    if port:
        def speed(ctx, aid):
            return ctx.speeds[ctx.bp(aid, "Nose")] > 80

        def full(ctx, aid):
            return ctx.full_features[aid][f"('{aid}_Nose', '{aid}_Tail_base')_raw"]

        def centres(ctx, pair):
            return np.asarray(pann._norm(ctx.raw_coords[f"{pair[0]}_Center"], ctx.raw_coords[f"{pair[1]}_Center"]) < 60)

        def nose_tail(ctx, pair):
            return pann._norm(ctx.raw_coords[f"{pair[0]}_Nose"], ctx.raw_coords[f"{pair[1]}_Tail_base"]) < 45
        mod = pann
    else:
        def speed(ctx, aid):
            return ctx.speeds[ctx.bp(aid, "Nose")].to_numpy() > 80

        def full(ctx, aid):
            return jget_dt(ctx.full_features[aid], ctx.key)[f"('{aid}_Nose', '{aid}_Tail_base')_raw"].to_numpy()

        def centres(ctx, pair):
            d = ctx.raw_coords[f"{pair[0]}_Center"].to_numpy() - ctx.raw_coords[f"{pair[1]}_Center"].to_numpy()
            return np.linalg.norm(d, axis=1) < 60

        def nose_tail(ctx, pair):
            d = ctx.raw_coords[f"{pair[0]}_Nose"].to_numpy() - ctx.raw_coords[f"{pair[1]}_Tail_base"].to_numpy()
            return np.linalg.norm(d, axis=1) < 45
        mod = jann
    s, o = mod.Behavior_scope, mod.Behavior_output
    return [
        mod.DeepOF_behavior("nose-fast", s.INDIVIDUAL, o.BINARY, speed),
        mod.DeepOF_behavior("full-nose-tail", s.INDIVIDUAL, o.CONTINUOUS, full, postprocess=mod.postprocess_identity),
        mod.DeepOF_behavior("centres-close", s.PAIR_NONDIRECTIONAL, o.BINARY, centres),
        mod.DeepOF_behavior("nose-to-tail", s.PAIR_DIRECTIONAL, o.BINARY, nose_tail, color="#abcdef"),
    ]


def test_custom_behaviors_match_jax(sides):
    """One custom behavior of each scope, one of them reading an
    unrestricted full_features column: the tables (44 columns) match the
    JAX package's, colours are assigned in its order."""
    got, want, _, _ = _annotate(sides, None, port={"custom_behaviors": _custom_pair(True)},
                                jax={"custom_behaviors": _custom_pair(False)})
    _check_tables(got, want)
    cols = got["test"].columns
    assert len(cols) == 33 + 2 * 2 + 1 + 2
    assert cols.index("B_W_centres-close") == 0 and "W_B_nose-to-tail" in cols
    colors = [cb.color for cb in sides["port"]._custom_behaviors]
    assert colors == [cb.color for cb in sides["jax"]._custom_behaviors] and colors[3] == "#abcdef"


def _bad(mod, case):
    s, o = mod.Behavior_scope, mod.Behavior_output

    def b(name, scope=s.INDIVIDUAL, out=o.BINARY):
        return mod.DeepOF_behavior(name, scope, out, lambda ctx, a: None)
    return {
        "underscore": ([b("nose_fast")], None),
        "continuous_pair": ([b("pair-speed", s.PAIR_DIRECTIONAL, o.CONTINUOUS)], None),
        "in_use": ([b("sniffing")], None),
        "duplicate": ([b("x-y"), b("x-y")], None),
        "not_a_list": ((b("x-y"),), None),
        "inputs_not_dict": ([b("x-y")], [1]),
    }[case]


@pytest.mark.parametrize("case", ["underscore", "continuous_pair", "in_use", "duplicate", "not_a_list",
                                  "inputs_not_dict"])
def test_validate_custom_behaviors_raises_as_jax(case):
    with pytest.raises((ValueError, NotImplementedError)) as want:
        jann.validate_custom_behaviors(*_bad(jann, case))
    with pytest.raises(want.type) as got:
        pann.validate_custom_behaviors(*_bad(pann, case))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("stepped", [False, True])
def test_max_behaviour_matches_jax(sides, stepped):
    got, want, _, _ = _annotate(sides, LOOSE)
    for key in want:
        np.testing.assert_array_equal(pann.max_behaviour(got[key], 10, stepped),
                                      jann.max_behaviour(want[key], 10, stepped))


def test_supervised_annotation_needs_a_gpu_unless_cpu(sides, monkeypatch):
    """A project on the default device raises without a GPU."""
    import copy

    coords = copy.copy(sides["port"])
    coords._device = "cuda"
    coords.__dict__.pop("_derived_store", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        coords.supervised_annotation(verbose=False)
