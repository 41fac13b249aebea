"""The port's VaDE against the JAX package's, float32 on the CPU (float64 for
the GMM init): the Gaussian-mixture head and the model's forwards, the
truncated xavier init, the VaDE loss in both phases, one train step's loss
and gradients, the optimisers with freezes, the KL schedules, the GMM init
against sklearn, the served embeddings and soft counts, and the default
``deep_unsupervised_embedding`` (a VaDE: pretrain, GMM init, main) whose
saved bundle ``embedding_per_video`` serves.

Inputs are numpy draws from fixed seeds fed to both packages; JAX weights
cross over with ``from_flax_params(kind="VaDE")``, and the JAX step's two
noise draws (z's and the Monte-Carlo KL's, from its split key) are drawn
with JAX and passed to the port. Bars:
- forwards, losses, embeddings and soft counts: 1e-5 (1e-4 for the
  reconstruction and the total, sums over T*N*F terms);
- gradients: 1e-5 * max(1, max |g|) per tensor (``test_torch_train``'s);
- Adam with its piecewise rates: 1e-6 over every step;
- schedules: exact;
- EM from shared k-means labels against sklearn: 1e-8 (float64), the same
  number of iterations.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from sklearn.cluster import KMeans
from sklearn.mixture import GaussianMixture

from deepof_tpu.models import heads as jheads
from deepof_tpu.models import zoo as jzoo
from deepof_tpu.train import config as jconfig
from deepof_tpu.train import harness as jharness
from deepof_tpu.train import losses as jlosses
from deepof_tpu.train import schedules as jschedules
from deepof_tpu.train.harness import ModelBundle as JaxBundle
from deepof_tpu.train.inference import scanned_windowed_forward as jax_forward

from deepof_tpu_torch.data import Project
from deepof_tpu_torch.models import blocks as pblocks
from deepof_tpu_torch.models import heads as pheads
from deepof_tpu_torch.models.zoo import build_model
from deepof_tpu_torch.train import config as pconfig
from deepof_tpu_torch.train import gmm as pgmm
from deepof_tpu_torch.train import harness as pharness
from deepof_tpu_torch.train import losses as plosses
from deepof_tpu_torch.train import schedules as pschedules
from deepof_tpu_torch.train.inference import ModelBundle, embedding_per_video, scanned_windowed_forward
from deepof_tpu_torch.weights import from_flax_params

from test_torch_public import _project_args, write_project
from test_torch_train import ADJ, E, N, T, _close, _init, _param_grads_close, _windows

B, LATENT, K = 16, 4, 4


def _jax_vade(seed, kmeans=0.5):
    """A JAX VaDE on seeded flax params, the port's on the same weights, and
    a batch of windows."""
    rng = np.random.default_rng(seed)
    x, a = _windows(rng, B)
    jm = jzoo.build_model("VaDE", (T, N, 3), (T, E, 1), ADJ, latent_dim=LATENT, n_components=K,
                          kmeans_loss=kmeans)
    params = _init(jm, seed + 1, jnp.asarray(x), jnp.asarray(a))
    assert set(params) == {"encoder", "latent_space", "decoder"}
    pm = build_model("VaDE", (T, N, 3), (T, E, 1), ADJ, LATENT, K, device="cpu", kmeans_loss=kmeans)
    pm.load_state_dict(from_flax_params(params, kind="VaDE"))
    return jm, params, pm, x, a


def _step_noise(key, b=B, d=LATENT, samples=32):
    """The JAX step's two draws: z's from rng_model, the KL's from rng_loss."""
    rng_model, rng_loss = jax.random.split(key)
    return (np.asarray(jax.random.normal(rng_model, (b, d), jnp.float32)),
            np.asarray(jax.random.normal(rng_loss, (samples, b, d), jnp.float32)))


# --------------------------------------------------------------------------- #
# (a) The head and the model
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kmeans", [0.0, 0.7])
def test_gaussian_mixture_latent_matches_jax(train, kmeans):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, 6)).astype(np.float32)
    jm = jheads.GaussianMixtureLatent(input_dim=6, n_components=K, latent_dim=LATENT, kmeans=kmeans)
    params = _init(jm, 4, jnp.asarray(x))
    key = jax.random.PRNGKey(5)
    want = jm.apply({"params": params}, jnp.asarray(x), train=train, rng=key)
    eps = np.array(jax.random.normal(key, (B, LATENT), jnp.float32))
    pm = pheads.GaussianMixtureLatent(6, K, LATENT, kmeans)
    pm.load_state_dict(from_flax_params(params, kind="GaussianMixtureLatent"))
    got = pm(torch.as_tensor(x), train=train, eps=torch.as_tensor(eps))
    assert set(got) == set(want) - {"metrics"}
    for key_ in got:
        _close(got[key_], want[key_])
    metrics = pheads.cluster_metrics(got["categorical"])
    assert set(metrics) == set(want["metrics"])
    for key_ in metrics:
        _close(metrics[key_], want["metrics"][key_])
    assert train == (not torch.equal(got["z"], got["z_mean"]))
    np.testing.assert_allclose(got["categorical"].sum(1).detach().numpy(), 1.0, atol=1e-6)


@pytest.fixture(scope="module")
def jax_forwards():
    """A carried VaDE, its batch, the JAX draw of z's noise, and one compile
    of the JAX model's training forward (z sampled), its evaluation forward
    (z = z_mean), ``embed`` and ``group``."""
    jm, params, pm, x, a = _jax_vade(11)
    key = jax.random.PRNGKey(12)

    def run(p, xx, aa):
        return (jm.apply({"params": p}, xx, aa, train=True, rng=key),
                jm.apply({"params": p}, xx, aa, train=False),
                jm.apply({"params": p}, xx, aa, method="embed"),
                jm.apply({"params": p}, xx, aa, method="group"))

    outs = jax.jit(run)(params, jnp.asarray(x), jnp.asarray(a))
    eps = np.asarray(jax.random.normal(key, (B, LATENT), jnp.float32))
    return jm, params, pm, x, a, key, eps, outs


def test_vade_forwards_match_jax(jax_forwards):
    """The training forward (z sampled with the JAX draw, and at z_mean as
    the evaluation step runs it), the serving forward, encode, embed and
    group."""
    jm, params, pm, x, a, key, eps, (train_out, eval_out, embed, group) = jax_forwards
    xt, at = torch.as_tensor(x), torch.as_tensor(a)
    for train, want in ((True, train_out), (False, eval_out)):
        with torch.no_grad():
            got = pm.training_forward(xt, at, eps=torch.as_tensor(eps), train=train)
        assert set(got) == set(want)
        for k in ("latent", "categorical", "kmeans_loss", "z_mean", "z_log_var", "encoder_output"):
            _close(got[k], want[k])
        for k in ("means", "log_vars", "prior"):
            _close(got["gmm_params"][k], want["gmm_params"][k])
        _close(got["reconstruction"].loc, want["reconstruction"].loc)
        np.testing.assert_array_equal(got["reconstruction"].mask.numpy(), np.asarray(want["reconstruction"].mask))
        assert train == (not torch.equal(got["latent"], got["z_mean"]))
    assert float(got["kmeans_loss"]) > 0
    with torch.no_grad():
        serving = pm(xt, at)
        assert set(serving) == {"latent", "categorical", "encoder_output"}
        for got_m, want_m in ((pm.encode(xt, at), eval_out["encoder_output"]), (pm.embed(xt, at), embed),
                              (pm.group(xt, at), group), (serving["encoder_output"], eval_out["encoder_output"]),
                              (serving["latent"], embed), (serving["categorical"], group)):
            _close(got_m, want_m)
    with pytest.raises(KeyError, match="missing"):
        from_flax_params({"encoder": params["encoder"], "decoder": params["decoder"]}, kind="VaDE")
    with pytest.raises(KeyError, match="unknown"):
        from_flax_params({**params, "latent_space": {**params["latent_space"], "x": {}}}, kind="VaDE")


# --------------------------------------------------------------------------- #
# (b) The prior's init
# --------------------------------------------------------------------------- #


def test_xavier_normal_is_flax_truncated_normal():
    """1M draws on a (100, 10000) parameter: none beyond flax's bound
    2 fan_avg^-0.5 / 0.87962566, mean and standard deviation within 1% of
    ``jax.nn.initializers.xavier_normal()``'s draws."""
    shape = (100, 10_000)
    got = pblocks.xavier_normal(shape, torch.Generator().manual_seed(0)).double().numpy()
    want = np.asarray(jax.nn.initializers.xavier_normal()(jax.random.PRNGKey(0), shape, jnp.float32), np.float64)
    scale = (2.0 / sum(shape)) ** 0.5
    bound = 2.0 * scale / 0.87962566
    assert np.abs(got).max() <= bound * (1 + 1e-6) and np.abs(want).max() <= bound * (1 + 1e-6)
    assert abs(got.mean() - want.mean()) <= 0.01 * scale
    assert abs(got.std() / want.std() - 1.0) <= 0.01
    head = pheads.GaussianMixtureLatent(LATENT, K, LATENT, generator=torch.Generator().manual_seed(1))
    assert head.gmm_means.abs().max() <= 2.0 * (2.0 / (K + LATENT)) ** 0.5 / 0.87962566 * (1 + 1e-6)


# --------------------------------------------------------------------------- #
# (c) The loss, (d) one step
# --------------------------------------------------------------------------- #

ALL_ON = dict(tf_cluster_weight=0.3, reg_cat_clusters_weight=0.2, temporal_cohesion_weight=0.15,
              reg_scatter_weight=0.25, reg_scatter_beta=0.7, kmeans_loss_weight=0.6, repel_weight=0.4,
              repel_length_scale=0.8, nonempty_weight=0.5, nonempty_floor=0.4, nonempty_p=2)


def _loss_params(mode, weights):
    pretrain = mode == "pretrain"
    if weights == "cfg":
        common = jconfig.CommonFitCfg(n_components=K, kmeans_loss=0.3)
        j_params = jlosses.vade_params_from_cfg(common, jconfig.VaDECfg(), jconfig.TurtleTeacherCfg(), pretrain)
        p_params = plosses.vade_params_from_cfg(pconfig.CommonFitCfg(n_components=K, kmeans_loss=0.3),
                                                pconfig.VaDECfg(), pconfig.TurtleTeacherCfg(), pretrain)
        assert vars(p_params) == vars(j_params)
        return j_params, p_params
    kw = dict(n_components=K, pretrain_mode=pretrain, **ALL_ON)
    return jlosses.VadeLossParams(**kw), plosses.VadeLossParams(**kw)


@pytest.mark.parametrize("weights", ["cfg", "all_on"])
@pytest.mark.parametrize("mode", ["pretrain", "main"])
def test_vade_loss_matches_jax(jax_forwards, mode, weights):
    """Every term of both phases on the sampled training forward, the
    Monte-Carlo KL's draw made with JAX."""
    jm, params, pm, x, a, key, eps_z, (out, *_) = jax_forwards
    j_params, p_params = _loss_params(mode, weights)
    want = jlosses.vade_loss(out, jnp.asarray(x), j_params, 0.7, key)
    eps_kl = np.asarray(jax.random.normal(key, (32, B, LATENT), jnp.float32))
    with torch.no_grad():
        p_out = pm.training_forward(torch.as_tensor(x), torch.as_tensor(a), eps=torch.as_tensor(eps_z))
        got = plosses.vade_loss(p_out, torch.as_tensor(x), p_params, 0.7, eps=torch.as_tensor(eps_kl))
    assert set(got) == set(want)
    for k, v in want.items():
        _close(got[k], v, 1e-4 if k in ("total_loss", "reconstruct_loss") else 1e-5)
    live = {k for k, v in got.items() if float(v) != 0.0}
    if weights == "all_on":
        assert {"kl_div", "kmeans_loss", "activity_l1", "repel_loss", "nonempty_loss"} <= live
        if mode == "main":
            assert {"tf_clust_loss", "prior_loss", "cat_clust_loss", "temporal_loss", "scatter_loss"} <= live


@pytest.fixture(scope="module")
def jax_steps():
    """One compile of the JAX package's make_vade_step per phase, every
    optional weight on: its logs and the gradients it applied (read from
    optax.trace at decay 0, moved by scale 0)."""
    jm, params, pm, x, a = _jax_vade(31)
    out = {}
    for mode in ("pretrain", "main"):
        j_params, p_params = _loss_params(mode, "all_on")
        opt = optax.chain(optax.trace(decay=0.0), optax.scale(0.0))
        step = jharness.make_vade_step(jm, opt, j_params)
        copy = jax.tree_util.tree_map(jnp.array, params)
        key = jax.random.PRNGKey(32)
        _, state, _, logs = step(copy, opt.init(copy), {}, jnp.asarray(x), jnp.asarray(a), key,
                                 jnp.float32(0.6), jnp.float32(0.0), jnp.zeros((B, K), jnp.float32), None)
        out[mode] = (p_params, logs, state[0].trace, _step_noise(key))
    return params, x, a, out


@pytest.mark.parametrize("mode", ["pretrain", "main"])
def test_vade_step_loss_and_gradients_match_jax(jax_steps, mode):
    params, x, a, out = jax_steps
    p_params, logs, grads, (eps_z, eps_kl) = out[mode]
    pm = build_model("VaDE", (T, N, 3), (T, E, 1), ADJ, LATENT, K, device="cpu", kmeans_loss=0.5)
    pm.load_state_dict(from_flax_params(params, kind="VaDE"))
    total, got = pharness.vade_step_loss(pm, torch.as_tensor(x), torch.as_tensor(a), None, p_params, 0.6,
                                         torch.as_tensor(eps_z), torch.as_tensor(eps_kl))
    assert set(got) == set(logs)
    for k, v in logs.items():
        _close(got[k], v, 1e-4 if k in ("total_loss", "reconstruct_loss") else 1e-5)
    assert float(logs["distill_loss"]) == 0.0
    total.backward()
    # Pretrain reaches the GMM prior through the non-empty term's posterior.
    assert pm.latent_space.gmm_means.grad.abs().max() > 0
    _param_grads_close(pm, grads, "VaDE")


def test_vade_steps_update_and_evaluate():
    """make_vade_step moves every parameter and draws its noise from the
    generator (two generators of one seed take the same step);
    make_vade_eval_step runs at z = z_mean without gradients."""
    _, params, pm, x, a = _jax_vade(41)
    xt, at = torch.as_tensor(x), torch.as_tensor(a)
    p_params = plosses.VadeLossParams(n_components=K, pretrain_mode=False, **ALL_ON)
    ev = pharness.make_vade_eval_step(pm, p_params, torch.Generator().manual_seed(0))(xt, at, kl_weight=0.5)
    assert ev["total_loss"].grad_fn is None
    with torch.no_grad():
        z_mean = pm.embed(xt, at)
        eps_kl = plosses.kl_noise(z_mean, p_params, torch.Generator().manual_seed(0))
        _, want = pharness.vade_step_loss(pm, xt, at, None, p_params, 0.5, eps_kl=eps_kl, train=False)
    _close(ev["total_loss"], want["total_loss"])
    states = []
    for _ in range(2):
        model = build_model("VaDE", (T, N, 3), (T, E, 1), ADJ, LATENT, K, device="cpu")
        model.load_state_dict(from_flax_params(params, kind="VaDE"))
        before = {k: v.clone() for k, v in model.state_dict().items()}
        opt = pharness._make_optimizer(model.named_parameters(), 1e-3, gmm_lr=1e-3)
        pharness.make_vade_step(model, opt, p_params, torch.Generator().manual_seed(7))(xt, at, kl_weight=0.5)
        assert all(not torch.equal(before[k], v) for k, v in model.state_dict().items())
        states.append(model.state_dict())
    assert all(torch.equal(states[0][k], states[1][k]) for k in states[0])


# --------------------------------------------------------------------------- #
# (e) Optimisers, (f) schedules
# --------------------------------------------------------------------------- #

OPT_SHAPES = {"encoder": {"w": (3, 2)}, "decoder": {"w": (2, 3), "b": (3,)},
              "latent_space": {"gmm_means": (3, 2), "gmm_log_vars": (3, 2), "encoder_mean": {"kernel": (2, 2)}}}


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("freeze_gmm,freeze_decoder", [(0, 0), (2, 1), (1, 3), (0, 2), (2, 0)])
def test_optimisers_match_optax(freeze_gmm, freeze_decoder):
    """Seven clipped updates at 2 batches an epoch, so each freeze ends
    inside the run, against the JAX package's optimisers; (0, 0) is
    ``_make_optimizer`` with a GMM rate."""
    rng = np.random.default_rng(51)
    params = jax.tree_util.tree_map(lambda s: rng.normal(size=s).astype(np.float32), OPT_SHAPES,
                                    is_leaf=lambda s: isinstance(s, tuple))
    grads = [jax.tree_util.tree_map(lambda v: (rng.normal(size=v.shape) * 2).astype(np.float32), params)
             for _ in range(7)]
    if freeze_gmm or freeze_decoder:
        j_opt = jharness._make_vade_main_optimizer(1e-2, 3e-2, 2, freeze_gmm, freeze_decoder)
    else:
        j_opt = jharness._make_optimizer(1e-2, gmm_lr=3e-2)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = j_opt.init(jp)
    tp = {name: torch.nn.Parameter(torch.tensor(v)) for name, v in _flat(params)}
    if freeze_gmm or freeze_decoder:
        p_opt = pharness._make_vade_main_optimizer(tp.items(), 1e-2, 3e-2, 2, freeze_gmm, freeze_decoder)
    else:
        p_opt = pharness._make_optimizer(tp.items(), 1e-2, gmm_lr=3e-2)
    moved = {name: [] for name in tp}
    for g in grads:
        updates, state = j_opt.update(jax.tree_util.tree_map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
        for name, v in _flat(g):
            tp[name].grad = torch.as_tensor(v).clone()
        before = {name: p.detach().clone() for name, p in tp.items()}
        p_opt.step()
        for name, want in _flat(jp):
            _close(tp[name], want, 1e-6)
            moved[name].append(not torch.equal(before[name], tp[name]))
    # A frozen group stands still for its window, then moves; the GMM's
    # unfreeze sets the decoder's rate too (5e-4), as the JAX schedules do.
    fg, fd = 2 * freeze_gmm, 2 * freeze_decoder
    assert moved["latent_space.gmm_means"] == [t >= fg for t in range(7)]
    assert moved["decoder.w"] == [t >= fd or (fg and t >= fg) for t in range(7)]
    assert all(moved["encoder.w"])


def test_weight_schedules_match_jax():
    for mode in ("linear", "sigmoid", "tf_sigmoid", "other"):
        for kw in (dict(warmup_epochs=3, cooldown_epochs=2, max_weight=0.8, end_weight=0.2),
                   dict(warmup_epochs=0, at_max_epochs=2, cooldown_epochs=3, max_weight=4.0, end_weight=0.2),
                   dict(warmup_epochs=2, cooldown_epochs=0, max_weight=1.0, end_weight=0.5)):
            want = jschedules.WeightSchedule(n_batches_per_epoch=5, mode=mode, **kw)
            got = pschedules.WeightSchedule(n_batches_per_epoch=5, mode=mode, **kw)
            assert [got.weight_at(t) for t in range(40)] == [want.weight_at(t) for t in range(40)]


# --------------------------------------------------------------------------- #
# (g) The GMM init
# --------------------------------------------------------------------------- #


def _blobs(seed, n, k, d, spread):
    rng = np.random.default_rng(seed)
    centres = rng.normal(scale=spread, size=(k, d))
    truth = rng.integers(0, k, size=n)
    return centres[truth] + rng.normal(size=(n, d)), truth


@pytest.mark.parametrize("seed", [0, 1])
def test_em_matches_sklearn_from_shared_labels(seed):
    """Overlapping blobs, so that EM takes several iterations: the port's EM
    from sklearn's own k-means labels against GaussianMixture's fit."""
    x, _ = _blobs(seed, 600, 4, 4, 2.0)
    labels = KMeans(n_clusters=4, n_init=1, random_state=seed).fit(x).labels_
    gm = GaussianMixture(n_components=4, covariance_type="diag", reg_covar=1e-4, random_state=seed).fit(x)
    weights, means, cov, n_iter, converged = pgmm.gaussian_mixture_diag(
        torch.as_tensor(x), torch.as_tensor(labels, dtype=torch.long), 4)
    assert gm.n_iter_ > 2 and n_iter == gm.n_iter_ and converged == gm.converged_
    np.testing.assert_allclose(means.numpy(), gm.means_, rtol=0, atol=1e-8)
    np.testing.assert_allclose(torch.log(cov).numpy(), np.log(gm.covariances_), rtol=0, atol=1e-8)
    np.testing.assert_allclose(weights.numpy(), gm.weights_, rtol=0, atol=1e-8)


def _match(got, want):
    """The permutation of got's rows nearest to want's."""
    return got[[int(np.argmin(((got - w) ** 2).sum(1))) for w in want]]


def test_kmeans_and_gmm_init_on_separated_blobs():
    """k-means++ and Lloyd recover well-separated blobs up to a permutation,
    so the port's GMM init then equals sklearn's fit."""
    x, truth = _blobs(2, 500, 5, 3, 30.0)
    labels, centres = pgmm.kmeans(torch.as_tensor(x), 5, torch.Generator().manual_seed(3))
    pairs = set(zip(labels.tolist(), truth.tolist()))
    assert len(pairs) == len({p for p, _ in pairs}) == len({t for _, t in pairs}) == 5
    means, log_vars = pgmm.fit_gmm_init(torch.as_tensor(x, dtype=torch.float32), 5, seed=0)
    gm = GaussianMixture(n_components=5, covariance_type="diag", reg_covar=1e-4, random_state=0).fit(
        x.astype(np.float32).astype(np.float64))
    order = [int(np.argmin(((means.numpy() - w) ** 2).sum(1))) for w in gm.means_]
    assert sorted(order) == list(range(5))
    np.testing.assert_allclose(means.numpy()[order], gm.means_, rtol=0, atol=1e-8)
    np.testing.assert_allclose(log_vars.numpy()[order], np.log(gm.covariances_), rtol=0, atol=1e-8)


# --------------------------------------------------------------------------- #
# (h) Serving, (i) the default entry point
# --------------------------------------------------------------------------- #


def test_scanned_forward_serves_vade_like_jax():
    """A carried VaDE through the window kernel's plain version and the
    encoder's streams: embeddings are z_mean, soft counts the categorical
    posterior."""
    jm, params, pm, _, _ = _jax_vade(61)
    rng = np.random.default_rng(62)
    f = 3 * N + E + 2
    perm = rng.permutation(f)
    layout = {"node": perm[:3 * N].tolist(), "edge": perm[3 * N:3 * N + E].tolist(), "angle": None}
    feats = rng.normal(size=(70, f)).astype(np.float32)
    spec = {"model": "VaDE", "input_shape": [T, N, 3], "edge_feature_shape": [T, E, 1], "use_angles": False}
    j_emb, j_sc = jax_forward(
        JaxBundle(model=jm, variables={"params": jax.tree_util.tree_map(jnp.asarray, params)}, rebuild_spec=spec),
        feats, layout, T, "VaDE", block=32,
    )
    p_emb, p_sc = scanned_windowed_forward(ModelBundle(pm.eval(), spec), feats, layout, T, "VaDE", block=32,
                                           device="cpu")
    assert p_emb.shape == (70 - T + 1, LATENT) and p_sc.shape == (70 - T + 1, K)
    _close(p_emb, j_emb)
    _close(p_sc, j_sc)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The public fixture (2 x 300 frames, two deepof_14 animals), one
    recording held out, through deep_unsupervised_embedding at its default
    model: one pretrain and one main epoch of 2 train and 1 val batches."""
    root = write_project(tmp_path_factory.mktemp("vade_project"), "csv")
    coords = Project(**_project_args(root, "csv"), device="cpu").create(force=True, test=True, verbose=False)
    ggd = coords.get_graph_dataset(window_size=8, test_videos=1)
    result = coords.deep_unsupervised_embedding(
        ggd[:3], adjacency_matrix=ggd[2], batch_size=16, latent_dim=LATENT, epochs=1, pretrain_epochs=1,
        n_clusters=K, save_checkpoints=True, verbose=False, limit_train_batches=2, limit_val_batches=1,
    )
    return coords, ggd, result, root


def test_default_embedding_trains_a_vade_saves_and_serves(trained, jax_forwards):
    coords, (dataset, meta, adj, tab_dict, scaler), (bundle, score, part, summary), root = trained
    assert bundle.rebuild_spec["model"] == "VaDE" and score is None and part is None
    jm, _, _, x, _, key, _, (out, *_) = jax_forwards
    loss_keys = set(jlosses.vade_loss(out, jnp.asarray(x), jlosses.VadeLossParams(n_components=K), 0.5, key))
    want_keys = {f"{phase}{val}{k}" for phase in ("pretrain/", "") for val in ("", "val_") for k in loss_keys}
    assert set(bundle.history) == want_keys == set(summary)
    assert all(np.isfinite(v) for v in summary.values())
    assert bundle.best_state is not None and not bundle.model.training
    models = os.path.join(root, "p", "Trained_models", "models")
    assert sorted(os.listdir(models)) == ["VaDE_recurrent_latent4_k4_run0.ckpt", "VaDE_recurrent_latent4_k4_run0_best.ckpt"]

    emb, counts = embedding_per_video(coords, tab_dict, bundle, meta, global_scaler=scaler, batch_size=64)
    loaded, *_ = coords.deep_unsupervised_embedding(None, pretrained="VaDE_recurrent_latent4_k4_run0.ckpt")
    emb2, counts2 = embedding_per_video(coords, tab_dict, loaded, meta, global_scaler=scaler, batch_size=64)
    for key in ("test", "test2"):
        assert emb[key].shape == (293, LATENT) and counts[key].shape == (293, K)
        np.testing.assert_allclose(counts[key].sum(axis=1), 1.0, atol=1e-5)
        np.testing.assert_array_equal(emb2[key], emb[key])
        np.testing.assert_array_equal(counts2[key], counts[key])
    # The bundle's own methods: embed is z_mean, group the posterior.
    x, a, _, _ = next(pharness._dataset_from_preprocessed(dataset[0]).batches(5, shuffle=False))
    z, q = loaded.embed(x, a), loaded.group(x, a)
    with torch.no_grad():
        head = loaded.model.latent_space(loaded.encode(x, a))
    assert z.shape == (5, LATENT)
    torch.testing.assert_close(z, head["z_mean"], rtol=0, atol=0)
    torch.testing.assert_close(q, head["categorical"], rtol=0, atol=0)


def test_gmm_init_and_what_raises(trained):
    """fit_vade writes the GMM fitted to the pretrained latents into the
    prior before the main phase; mixed precision raises, naming its item,
    and so do an unknown encoder and an unknown model."""
    coords, ggd, _, _ = trained
    common = pconfig.CommonFitCfg(batch_size=16, latent_dim=LATENT, epochs=0, n_components=K, seed=0)
    train_ds = pharness._dataset_from_preprocessed(ggd[0][0])
    pre = pharness.fit_vade(train_ds, None, ggd[2], common, pconfig.VaDECfg(pretrain_epochs=0),
                            pconfig.TurtleTeacherCfg(), device="cpu", verbose=False)
    latents = pharness.extract_latents(pre.model, train_ds, 16)
    assert latents.shape == (len(train_ds), LATENT)
    means, log_vars = pgmm.fit_gmm_init(latents, K, seed=0)
    torch.testing.assert_close(pre.model.latent_space.gmm_means.data, means.float())
    torch.testing.assert_close(pre.model.latent_space.gmm_log_vars.data, log_vars.float())

    kw = dict(adjacency_matrix=ggd[2], batch_size=16, latent_dim=LATENT, n_clusters=K, epochs=1)
    with pytest.raises(NotImplementedError, match="use_amp"):
        coords.deep_unsupervised_embedding(ggd[:3], use_amp=True, **kw)
    with pytest.raises(NotImplementedError, match="invalid encoder type"):
        coords.deep_unsupervised_embedding(ggd[:3], encoder_type="GRU", **kw)
    with pytest.raises(ValueError, match="Unknown model"):
        coords.deep_unsupervised_embedding(ggd[:3], embedding_model="GMVAE", **kw)
