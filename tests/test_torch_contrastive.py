"""The port's Contrastive model against the JAX package's, float32 on the
CPU: the augmentations with the JAX package's draws passed in, the four
contrastive losses under the three similarities (values and gradients),
one contrastive train step at the default TCN encoder (loss, gradients,
running statistics), and ``embedding_per_video`` with its default "msm"
soft counts. Each encoder's forwards and the transformer's step:
``test_torch_contrastive_encoders``;
``deep_unsupervised_embedding(embedding_model="Contrastive")``:
``test_torch_encoder_fits``.

The JAX package draws its augmentations inside its step from split keys;
the tests split the same keys and draw the same arrays, and give them to
the port's augmentations as tensors. Every JAX program compiles once, all
of them together (``test_torch_encoders.run_jax_all``). Bars:
augmentations 1e-6 (the same float32 operations), losses and
similarities 1e-6 and their gradients 1e-5 of max(1, max |g|), the step's
gradients ``STEP_GRAD_RTOL``, embeddings 1e-5, running statistics 1e-6,
soft counts at the MSM decoders' 1e-4 (``test_torch_softcounts``'s).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepof_tpu.train import augment as jaug
from deepof_tpu.train import config as jconfig
from deepof_tpu.train import losses as jlosses

from deepof_tpu_torch.data import Project
from deepof_tpu_torch.models.zoo import build_model
from deepof_tpu_torch.train import augment as paug
from deepof_tpu_torch.train import config as pconfig
from deepof_tpu_torch.train import harness as pharness
from deepof_tpu_torch.train import losses as plosses
from deepof_tpu_torch.train.inference import ModelBundle, embedding_per_video
from deepof_tpu_torch.weights import from_flax_params

from test_torch_encoders import (  # noqa: F401 (fast_jax_compiles, one_torch_thread: autouse fixtures)
    fast_jax_compiles,
    one_torch_thread,
    param_grads_close,
    run_jax_all,
    running_stats_close,
    to_numpy,
)
import torch_encoder_cases
from test_torch_public import _project_args, write_project
from test_torch_train import ADJ, E, N, _close, _grad_close

B, LATENT, T_FULL = 8, 4, 16
# The contrastive TCN step's gradients: the loss divides cosine similarities
# of normalised embeddings by the temperature 0.1, which scales the float32
# rounding of the 16 TemporalBlocks under it. Against the port's float64
# gradient (the same draws) the JAX package's float32 gradient is 8.95e-5 of
# max(1, max |g|) off and the port's 3.45e-5; they differ by up to 7.33e-5
# (on this box). Held at 1e-4: GRAD_RTOL (1e-5) is out of reach of the JAX
# package's own float32 gradient here.
STEP_GRAD_RTOL = 1e-4
EDGES = np.stack(np.nonzero(np.triu(ADJ)), axis=1)
PRECOMP = jaug.build_rotation_precomp(EDGES, N)
# Every augmentation on, rotations and noise included.
ALL_ON = dict(aug_p_rot=1.0, aug_p_noise=0.7, aug_p_interp=0.9, aug_p_shift=0.9)


def _coords(seed, b=B, t=T_FULL):
    """(B, T, N, 3) windows of coordinates and speeds."""
    return np.random.default_rng(seed).normal(size=(b, t, N, 3)).astype(np.float32)


# The JAX package's draws, from its keys in its order (augment.py), each set
# drawn in one compiled program.
def _shift_draws(key, b, cfg):
    k1, k2, k3 = jax.random.split(key, 3)
    return {"u": jax.random.uniform(k1, (b,)),
            "mag": jax.random.randint(k2, (b,), cfg.aug_min_shift, cfg.aug_max_shift + 1),
            "sign": jax.random.randint(k3, (b,), 0, 2)}


def _rotate_draws(key, b, n_rot, m):
    keys = jax.random.split(key, n_rot + 2)
    thetas, sides = [], []
    for r in range(n_rot):
        k_theta, k_side = jax.random.split(keys[r + 2])
        sides.append(jax.random.bernoulli(k_side))
        thetas.append(jax.random.uniform(k_theta, (b,), jnp.float32))
    return {"u": jax.random.uniform(keys[0], (b,)), "which": jax.random.randint(keys[1], (n_rot,), 0, m),
            "side": jnp.stack(sides), "theta": jnp.stack(thetas)}


def _interp_draws(key, b, t, cfg):
    k1, k2, k3 = jax.random.split(key, 3)
    return {"u": jax.random.uniform(k1, (b,)),
            "length": jax.random.randint(k2, (b,), cfg.aug_min_interp, cfg.aug_max_interp + 1),
            "t0": jax.random.randint(k3, (b,), 1, t - 1)}


def _noise_draws(key, b, n):
    k1, k2, k3, k4 = jax.random.split(key, 4)
    return {"u": jax.random.uniform(k1, (b,)), "axis": jax.random.randint(k2, (b, n), 0, 2),
            "offset": jax.random.normal(k3, (b, n), jnp.float32), "speed": jax.random.normal(k4, (b, n), jnp.float32)}


def _view_draws_jax(key, shape, cfg):
    """make_augmented_view's draws: its keys k1..k4 split once."""
    b, t, n = shape[:3]
    k1, k2, k3, k4 = jax.random.split(key, 4)
    draws = {"shift": _shift_draws(k1, b, cfg), "interp": _interp_draws(k3, b, t // 2, cfg)}
    if cfg.aug_p_rot > 0:
        draws["rotate"] = _rotate_draws(k2, b, cfg.aug_n_rot, PRECOMP.centers.shape[0])
    if cfg.aug_p_noise > 0:
        draws["noise"] = _noise_draws(k4, b, n)
    return draws


def _tensors(tree):
    return jax.tree_util.tree_map(lambda v: torch.as_tensor(np.asarray(v)), tree)


LOSSES = [(loss_fn, sim) for loss_fn in ("nce", "dcl", "fc", "hard_dcl") for sim in ("cosine", "dot", "euclidean")]


def _carried(encoder, params, stats, t=T_FULL):
    pm = build_model("Contrastive", (t, N, 3), (t, E, 1), ADJ, LATENT, encoder_type=encoder, device="cpu")
    pm.load_state_dict(from_flax_params(to_numpy(params), kind="Contrastive", batch_stats=to_numpy(stats)))
    return pm


def _unit_rows(seed):
    rng = np.random.default_rng(seed)
    h, f = (rng.normal(size=(12, 6)).astype(np.float32) for _ in range(2))
    return h / np.linalg.norm(h, axis=1, keepdims=True), f / np.linalg.norm(f, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def jax_results():
    """Every JAX program of this module's numerics, compiled together
    (``run_jax_all``): the augmentations on one key with the draws they
    make; the losses' values and gradients. -> (inputs, {name: (outputs,
    masks)})."""
    on, default = jconfig.ContrastiveCfg(**ALL_ON), jconfig.ContrastiveCfg()
    x1, x3 = _coords(1), _coords(3)
    m = PRECOMP.centers.shape[0]

    def augment(k, xx):
        return {
            "shift": (jaug.augment_time_shift(k, xx, on.aug_min_shift, on.aug_max_shift, 0.6),
                      _shift_draws(k, B, on)),
            "rotate": (jaug.augment_angle_rotations(k, xx, PRECOMP, 4, 30.0, 0.6), _rotate_draws(k, B, 4, m)),
            "interp": (jaug.augment_linear_interpolate_segments(k, xx, 3, 8, 0.6), _interp_draws(k, B, T_FULL, on)),
            "noise": (jaug.augment_noise_xys(k, xx, 0.03, 0.6), _noise_draws(k, B, N)),
        }

    def views(k, xx):
        return {name: (jaug.make_augmented_view(k, xx, EDGES, PRECOMP, cfg), _view_draws_jax(k, xx.shape, cfg))
                for name, cfg in (("defaults", default), ("all_on", on))}

    def losses(h, f):
        out = {}
        for loss_fn, sim in LOSSES:
            def jloss(a, b, loss_fn=loss_fn, sim=sim):
                loss, pos, neg = jlosses.select_contrastive_loss(a, b, similarity=sim, loss_fn=loss_fn,
                                                                 temperature=0.1, tau=0.1, beta=0.1)
                return loss, (pos, neg)
            out[f"{loss_fn}-{sim}"] = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(h, f)
        return out

    inputs = {"x1": x1, "x3": x3, "rows": _unit_rows(5)}
    calls = {"augment": (augment, (jax.random.PRNGKey(2), jnp.asarray(x1))),
             "views": (views, (jax.random.PRNGKey(4), jnp.asarray(x3))),
             "losses": (losses, tuple(jnp.asarray(v) for v in inputs["rows"]))}
    return inputs, run_jax_all(calls)


# --------------------------------------------------------------------------- #
# (a) Augmentations
# --------------------------------------------------------------------------- #


def test_edges_slices_and_rotation_branches_match_jax():
    x = _coords(0)
    _close(paug.recompute_edges(torch.as_tensor(x), EDGES), jaug.recompute_edges(jnp.asarray(x), EDGES), 1e-6)
    starts = np.array([0, 3, 8, 9, 2, 5, 1, 7])  # 9 past the end: clamped as lax.dynamic_slice clamps
    _close(paug.slice_time_per_sample(torch.as_tensor(x), torch.as_tensor(starts), 8),
           jaug.slice_time_per_sample(jnp.asarray(x), jnp.asarray(starts), 8), 0.0)
    got = paug.build_rotation_precomp(EDGES, N)
    for name in ("centers", "branch_a_masks", "branch_c_masks"):
        np.testing.assert_array_equal(getattr(got, name), getattr(PRECOMP, name))
    assert got.centers.shape[0] > 0


@pytest.mark.parametrize("which", ["shift", "rotate", "interp", "noise"])
def test_augmentations_match_jax_with_its_draws(jax_results, which):
    """Each augmentation on the JAX package's draws from one key, p high
    enough that some samples are left alone and some are not."""
    inputs, results = jax_results
    (want, draws), _ = results["augment"][0][which], None
    xt = torch.as_tensor(inputs["x1"])
    on = pconfig.ContrastiveCfg(**ALL_ON)
    draws = _tensors(draws)
    if which == "shift":
        got = paug.augment_time_shift(xt, draws, on.aug_min_shift, on.aug_max_shift, 0.6)
    elif which == "rotate":
        got = paug.augment_angle_rotations(xt, draws, PRECOMP, 4, 30.0, 0.6)
    elif which == "interp":
        got = paug.augment_linear_interpolate_segments(xt, draws, 3, 8, 0.6)
    else:
        got = paug.augment_noise_xys(xt, draws, 0.03, 0.6)
    assert got.shape == want.shape
    if which != "shift":
        # A sample left alone is unchanged (a rotation by 0 up to rounding).
        changed = (got - xt).abs().amax(dim=(1, 2, 3)) > 1e-5
        assert 0 < int(changed.sum()) < B
    _close(got, want, 1e-6)


@pytest.mark.parametrize("cfg_kw", [{}, ALL_ON], ids=["defaults", "all_on"])
def test_augmented_view_matches_jax(jax_results, cfg_kw):
    """make_augmented_view at the defaults (shift and interpolation only)
    and with every augmentation on; ``draw_augmentations`` draws what is
    on, in range, from a generator."""
    inputs, results = jax_results
    want, draws = results["views"][0]["all_on" if cfg_kw else "defaults"]
    pcfg = pconfig.ContrastiveCfg(**cfg_kw)
    x = inputs["x3"]
    got = paug.make_augmented_view(torch.as_tensor(x), EDGES, PRECOMP, pcfg, _tensors(draws))
    for g, w in zip(got, want):
        _close(g, w, 1e-6)
    drawn = paug.draw_augmentations(torch.Generator().manual_seed(0), x.shape, PRECOMP, pcfg)
    assert set(drawn) == {"shift", "interp"} | ({"rotate", "noise"} if cfg_kw else set())
    assert drawn["shift"]["mag"].min() >= 1 and drawn["shift"]["mag"].max() <= 6
    assert drawn["interp"]["t0"].min() >= 1 and drawn["interp"]["t0"].max() <= T_FULL // 2 - 2
    view, edges = paug.make_augmented_view(torch.as_tensor(x), EDGES, PRECOMP, pcfg, drawn)
    assert view.shape == (B, T_FULL // 2, N, 3) and edges.shape == (B, T_FULL // 2, E, 1)


# --------------------------------------------------------------------------- #
# (b) Losses
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("loss_fn,similarity", LOSSES)
def test_contrastive_losses_match_jax(jax_results, loss_fn, similarity):
    """The loss and both mean similarities, and the loss's gradients with
    respect to both views, on normalised embeddings as the step feeds them
    (hard_dcl at beta 0.1, the default, so that its reweighting runs)."""
    inputs, results = jax_results
    (want, (wpos, wneg)), wgrads = results["losses"][0][f"{loss_fn}-{similarity}"]
    h, f = inputs["rows"]
    ht, ft = torch.tensor(h, requires_grad=True), torch.tensor(f, requires_grad=True)
    loss, pos, neg = plosses.select_contrastive_loss(ht, ft, similarity=similarity, loss_fn=loss_fn,
                                                     temperature=0.1, tau=0.1, beta=0.1)
    loss.backward()
    for got_v, want_v in ((loss, want), (pos, wpos), (neg, wneg)):
        _close(got_v, want_v, 1e-6)
    _grad_close(ht.grad, wgrads[0], "history")
    _grad_close(ft.grad, wgrads[1], "future")
    with pytest.raises(ValueError, match="Unknown loss_fn"):
        plosses.select_contrastive_loss(ht, ft, loss_fn="x")


# --------------------------------------------------------------------------- #
# (c) One contrastive step
# --------------------------------------------------------------------------- #


def test_contrastive_step_matches_jax():
    """One step at the TCN encoder, its default: the loss and both
    similarities, every parameter gradient and the running statistics
    after the two train-mode forwards (the second normalising by its own
    batch and moving the statistics the first moved), from the
    augmentation draws the JAX step made. The JAX package's step (its
    gradients read from optax.trace at decay 0, moved by scale 0) was run
    once by ``scripts/make_torch_reference.py`` (``torch_encoder_cases``)."""
    case = torch_encoder_cases.load()["step-Contrastive-TCN"]
    params, stats, logs = case["params"], case["stats"], case["out"]
    x = torch_encoder_cases.contrastive_inputs(case["data_seed"])
    pm = _carried("TCN", params, stats)
    loss, got = pharness.contrastive_step_loss(pm, torch.as_tensor(x), EDGES, PRECOMP, pconfig.ContrastiveCfg(),
                                               draws=_tensors(case["draws"]))
    assert set(got) == set(logs)
    for k, v in logs.items():
        _close(got[k], np.asarray(v))
    loss.backward()
    param_grads_close(pm, case["grads"], "Contrastive", stats, STEP_GRAD_RTOL)
    running_stats_close(pm, case["moved"], "Contrastive", params)


# --------------------------------------------------------------------------- #
# (d) Serving with "msm" soft counts, the entry point
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def port_project(tmp_path_factory):
    """The public fixture in the port, its graph dataset at the full
    window."""
    root = write_project(tmp_path_factory.mktemp("contrastive_project"), "csv")
    coords = Project(**_project_args(root, "csv"), device="cpu").create(force=True, test=True, verbose=False)
    return coords, coords.get_graph_dataset(window_size=T_FULL)


def test_embedding_per_video_serves_contrastive_with_msm_like_jax(port_project):
    """A Contrastive model (TCN) carried from flax variables through
    embedding_per_video on the public fixture against the JAX package's
    (run once by ``scripts/make_torch_reference.py`` on the same fixture,
    its project and graph dataset its own, ``torch_encoder_cases``):
    embeddings of half windows at 1e-5 and the default ("msm") soft counts
    at 1e-4, with equal shapes and hard labels."""
    case = torch_encoder_cases.load()["serve-Contrastive-TCN"]
    coords, ggd = port_project
    n, e = len(ggd[1]["node_columns"]) // 3, len(ggd[1]["edge_columns"])
    adj = np.asarray(ggd[2])
    spec = {"model": "Contrastive", "input_shape": [T_FULL, n, 3], "edge_feature_shape": [T_FULL, e, 1],
            "latent_dim": LATENT, "encoder_type": "TCN", "use_gnn": True}
    pm = build_model("Contrastive", (T_FULL, n, 3), (T_FULL, e, 1), adj, LATENT, encoder_type="TCN", device="cpu")
    pm.load_state_dict(from_flax_params(case["params"], kind="Contrastive", batch_stats=case["stats"]))
    emb, counts = embedding_per_video(coords, ggd[3], ModelBundle(pm.eval(), spec), ggd[1], global_scaler=ggd[4],
                                      **torch_encoder_cases.SERVE_KWARGS)
    want_emb, want_counts = case["out"]["embeddings"], case["out"]["soft_counts"]
    assert sorted(emb) == sorted(want_emb) == ["test", "test2"]
    for key in ("test", "test2"):
        assert emb[key].shape == (300 - T_FULL // 2 + 1, LATENT)
        _close(emb[key], want_emb[key])
        assert counts[key].shape == want_counts[key].shape
        _close(counts[key], want_counts[key], 1e-4)
        assert (counts[key].argmax(1) == want_counts[key].argmax(1)).all()
