"""The worst differences between the port and the JAX package on the inputs
of tests/test_torch_evaluation.py and tests/test_torch_chunks.py, one JSON
line (the numbers beside the tests' bars in PERF.md).

    JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 PYTHONPATH=.:tests python scripts/torch_eval_parity.py

Runs on the CPU (both packages import here; ~1 min).
"""

import json
import os
import sys
import tempfile
import warnings

import numpy as np
import pandas as pd
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))

from deepof_tpu import evaluation as jev  # noqa: E402
from deepof_tpu import posthoc as jph  # noqa: E402
from deepof_tpu import shap_kernel as jshap  # noqa: E402
from deepof_tpu import visuals as jvis  # noqa: E402
from deepof_tpu.core.table_dict import TableDict as JaxTableDict  # noqa: E402
from deepof_tpu.ops import bursts as jbursts  # noqa: E402

from deepof_tpu_torch import evaluation as pev  # noqa: E402
from deepof_tpu_torch import posthoc as pph  # noqa: E402
from deepof_tpu_torch import shap_kernel as pshap  # noqa: E402
from deepof_tpu_torch import visuals as pvis  # noqa: E402
from deepof_tpu_torch.core.table_dict import TableDict  # noqa: E402
from deepof_tpu_torch.ops import bursts as pbursts  # noqa: E402

import test_torch_chunks as tc  # noqa: E402
import test_torch_evaluation as te  # noqa: E402


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    d = np.abs(np.nan_to_num(got - want)) / np.maximum(np.abs(np.nan_to_num(want)), 1e-300)
    return float(d.max(initial=0.0))


def absdiff(got, want):
    return float(np.abs(np.nan_to_num(np.asarray(got, float) - np.asarray(want, float))).max(initial=0.0))


def main():
    torch.set_num_threads(1)
    warnings.simplefilter("ignore")
    out = {}
    x, y = te._embedding(0, 500, 6)
    w, g = jev.compute_compactness(x[y], x), pev.compute_compactness(x[y], x, device="cpu")
    out["compactness_rel"] = max(rel(g[k], w[k]) for k in w)
    ap = []
    for max_train, c in ((100_000, 1.0), (300, 0.3)):
        x, y = te._embedding(1, 600, 5)
        w = jev.compute_separability_logreg(x, y, seed=3, c=c, max_train=max_train)
        g = pev.compute_separability_logreg(x, y, seed=3, c=c, max_train=max_train, device="cpu")
        ap += [abs(g["ap_mean"] - w["ap_mean"]), abs(g["ap_std"] - w["ap_std"])]
    out["separability_ap_abs"] = max(ap)
    knn = []
    for metric, max_points, max_pos in (("cosine", 50_000, 10_000), ("euclidean", 50_000, 10_000),
                                        ("cosine", 350, 40)):
        x, y = te._embedding(3, 700, 8)
        kw = dict(k=10, seed=2, max_points=max_points, max_pos_queries=max_pos, metric=metric)
        w, g = jev.compute_knn_agreement(x, y, **kw), pev.compute_knn_agreement(x, y, device="cpu", **kw)
        knn += [abs(g["pos_knn_agree_mean"] - w["pos_knn_agree_mean"]),
                abs(g["pos_knn_agree_std"] - w["pos_knn_agree_std"])]
    out["knn_abs"] = max(knn)
    bics = []
    for cov in te.COV_TYPES:
        x = te._blobs(4, 300, 3, 4)
        (wm, wb), (gm, gb) = jev.gmm_compute(x, 3, cov), pev.gmm_compute(x, 3, cov, device="cpu")
        bics.append(rel(gb, wb))
        assert gm.n_iter_ == wm.n_iter_
    x = te._blobs(5, 400, 3, 3)
    kw = dict(n_components_range=[2, 3], part_size=150, n_runs=3, cv_types=te.COV_TYPES)
    np.random.seed(11)
    wb = jev.gmm_model_selection(pd.DataFrame(x), n_cores=1, **kw)[0]
    np.random.seed(11)
    gb = pev.gmm_model_selection(x, device="cpu", **kw)[0]
    out["gmm_bic_rel"] = max(bics + [rel(gb, wb)])

    inputs = te.make_evaluation_inputs()
    (j_emb, j_sup), (p_emb, p_sup) = inputs["jax"], inputs["port"]
    table = {"float64_rel": 0.0, "ap_abs": 0.0, "knn_abs": 0.0}
    for mode in ("any", "center"):
        kw = dict(window_size=9, alignment_mode=mode, minimum_number_of_positives=20)
        w = jvis.return_embedding_evaluation(None, j_emb, j_sup, **kw)
        g = pvis.return_embedding_evaluation(None, p_emb, p_sup, device="cpu", **kw)
        wv = w.to_numpy(np.float64)
        for j, name in enumerate(g.columns):
            key = "float64_rel" if name.startswith("trace") else "knn_abs" if "knn" in name else "ap_abs"
            d = rel(g.values[:, j], wv[:, j]) if key == "float64_rel" else absdiff(g.values[:, j], wv[:, j])
            table[key] = max(table[key], d)
    out["embedding_evaluation"] = table

    rng = np.random.default_rng(5)
    x = rng.normal(size=(30, 12, 3)) * rng.uniform(0.1, 100, size=(1, 1, 3))
    x[rng.random(x.shape) < 0.1] = np.nan
    x[0, :, 0] = np.nan
    x[1, :, 1] = 7.25
    x[2, :, 2] = -3.0e6
    x[3, :, 0] = np.nan
    x[3, 4, 0] = 2.0
    names = ["B_Nose", "B_Center", "W_Tail_base"]
    out["chunk_statistics_rel"] = rel(pph.chunk_summary_statistics(x, names, device="cpu").values,
                                      jph.chunk_summary_statistics(x, names).to_numpy(np.float64))

    with tempfile.TemporaryDirectory() as tmp:
        sides = tc.make_sides(os.path.join(tmp, "project"))
        (j_counts, p_counts), (j_tags, p_tags) = sides["counts"], sides["tags"]
        worst, units = 0.0, 0
        for kw in tc.CHUNK_CASES.values():
            kw = dict(kw)
            tags = kw.pop("tags")
            np.random.seed(21)
            ws, wy, wbins = jph.annotate_time_chunks(sides["jax"], j_counts, j_tags if tags else None, **kw)
            np.random.seed(21)
            gs, gy, gbins = pph.annotate_time_chunks(sides["port"], p_counts, p_tags if tags else None,
                                                     device="cpu", **kw)
            assert np.array_equal(gy, wy.to_numpy()) and all(np.array_equal(gbins[k], wbins[k]) for k in wbins)
            worst = max(worst, absdiff(gs.values, ws.to_numpy(np.float64)))
        views = pph._kinematics_table_views(sides["port"], [None], "test", kin_derivative=2,
                                            include_feature_derivatives=True, include_angles=True)[None]
        want = jph._kinematics_table_views(sides["jax"], views=[None], kin_derivative=2,
                                           include_feature_derivatives=True, include_angles=True, file_name=None)
        d = np.abs(np.nan_to_num(views.values.numpy() - want[None]["test"].to_numpy(np.float64)))
        units = int((d > tc.TOL).sum())
        out["annotate_statistics_abs"] = worst
        out["kinematics_views"] = {"abs_within_tol": float(d[d <= tc.TOL].max(initial=0.0)),
                                   "entries_one_unit_off": units, "entries": int(d.size)}

    emb = {f"e{i:02d}": np.random.default_rng(9 + i).normal(size=(50, 4)) + (3.0 if i >= 12 else 0.0)
           for i in range(14)}
    w_agg = jph.get_aggregated_embedding(JaxTableDict(emb, typ="unsupervised_embedding"))
    g_agg = pph.get_aggregated_embedding(TableDict(emb, typ="unsupervised_embedding"), device="cpu")
    controls = [k for k in g_agg.index if int(k[1:]) < 12]
    wm = jph.fit_normative_global_model(w_agg.loc[controls])
    gm = pph.fit_normative_global_model(g_agg.values[[g_agg.index.index(k) for k in controls]], device="cpu")
    far = np.array([[40.0, -35.0, 60.0, 10.0], [1e3, 0.0, 0.0, 0.0]])
    out["normative"] = {"bandwidth_equal": bool(gm.bandwidth == wm.bandwidth),
                        "log_density_rel": max(rel(gm.score_samples(g_agg.values), wm.score_samples(w_agg.values)),
                                               rel(gm.score_samples(far), wm.score_samples(far)))}

    shap_abs = 0.0
    for m, nsamples in ((6, "auto"), (10, 300)):
        rng = np.random.default_rng(m)
        x = rng.normal(size=(120, m)) * rng.uniform(0.5, 3, size=m)
        wbg, gbg = jshap.kmeans_background(x, 6), pshap.kmeans_background(x, 6, device="cpu")
        np_model, torch_model = tc._softmax_linear(rng.normal(size=(m, 3)), rng.normal(size=3))
        wv = jshap.KernelExplainer(np_model, wbg).shap_values(x[:7], nsamples=nsamples, random_state=4)
        gv = pshap.KernelExplainer(torch_model, gbg, device="cpu").shap_values(x[:7], nsamples=nsamples,
                                                                                random_state=4)
        shap_abs = max([shap_abs, absdiff(gbg.data, wbg.data)] + [absdiff(a, b) for a, b in zip(gv, wv)])
    out["shap_abs"] = shap_abs

    rng = np.random.default_rng(4)
    a = rng.random(3000) < 0.03
    a[800:900] |= rng.random(100) < 0.6
    out["bursts_equal"] = bool(np.array_equal(pbursts.smooth_boolean_array(a, batch_size=700),
                                              jbursts.smooth_boolean_array(a, batch_size=700)))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
