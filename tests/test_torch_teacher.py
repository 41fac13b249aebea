"""The port's TURTLE teacher, training diagnostics, distillation term and
best-score rule against the JAX package's, on the CPU: JAX in float64 (x64)
as the other port tests run it, the port's teacher fit in float64 (float64
latents on the CPU) and its VaDE in float32.

Inputs are numpy draws from fixed seeds fed to both packages. The teacher's
LeCun-normal initialisations (the task encoder's, then every outer step's
heads) are drawn with the JAX package's keys, split as it splits them, and
handed to the port (``TeacherDraws``). The JAX package's views go through
sklearn's PCA, which computes in the input's dtype: the fits here hand it
the windows in float64 (a wrapper around its ``build_views``), so both
packages' PCAs are exact. Bars:
- ``soft_ce`` and its closed-form logit gradient against ``jax.grad``:
  1e-10;
- one outer step's loss and updated task parameters: 1e-6;
- ``fit_turtle_teacher``: tau_star and class weights 1e-5;
- ``build_views`` where sklearn's solver is exact ("full", "covariance_eigh";
  both packages apply sklearn's sign rule): 1e-8;
- ``initialize_gmm_from_teacher``: 1e-10;
- the diagnostics: 1e-12 (the table exactly);
- the distillation term and one VaDE main step with a teacher: losses 1e-5
  (the total 1e-4), gradients 1e-5 of max(1, max |g|), as
  ``test_torch_vade`` holds VaDE's step;
- the best-score rule: the same epochs as the JAX package's ``_run_epochs``.
"""

from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from deepof_tpu.core.table_dict import TableDict
from deepof_tpu.train import config as jconfig
from deepof_tpu.train import dataset as jdataset
from deepof_tpu.train import diagnostics as jdiag
from deepof_tpu.train import harness as jharness
from deepof_tpu.train import losses as jlosses
from deepof_tpu.train import teacher as jteacher

from deepof_tpu_torch.models.zoo import build_model
from deepof_tpu_torch.train import config as pconfig
from deepof_tpu_torch.train import dataset as pdataset
from deepof_tpu_torch.train import diagnostics as pdiag
from deepof_tpu_torch.train import harness as pharness
from deepof_tpu_torch.train import losses as plosses
from deepof_tpu_torch.train import teacher as pteacher
from deepof_tpu_torch.weights import from_flax_params

from test_torch_encoders import (  # noqa: F401 (fast_jax_compiles, one_torch_thread: autouse fixtures)
    fast_jax_compiles,
    one_torch_thread,
)
from test_torch_train import ADJ, E, N, T, _close, _param_grads_close
from test_torch_vade import ALL_ON, B, K, LATENT, _jax_vade, _step_noise

W, NODES = 8, 6  # the windows of tests/test_teacher.py: 8 frames of 6 nodes


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _windows(seed, n, d_latent=4):
    """(nodes (n, W, 6, 3), edges (n, W, 7, 1), no angles) and latents."""
    rng = np.random.default_rng(seed)
    part = (rng.normal(size=(n, W, NODES, 3)).astype(np.float32),
            rng.normal(size=(n, W, 7, 1)).astype(np.float32), np.zeros((n, W, 0, 1), np.float32))
    return part, rng.normal(size=(n, d_latent)).astype(np.float32)


def _datasets(part):
    return jdataset.WindowDataset(TableDict({"v1": part}, typ="merged")), pdataset.WindowDataset({"v1": part})


def _jax_draws(seed, dims, k, outer_steps):
    """The JAX package's initialisations of a fit: init_fn's keys split from
    PRNGKey(seed), then each outer step's head keys (rng, sub = split(rng);
    rng_heads = split(sub)[0]; split(rng_heads, n_views)), drawn with flax's
    lecun_normal (float64 in x64)."""
    init = jax.nn.initializers.lecun_normal()
    rng = jax.random.PRNGKey(seed)
    task = [np.asarray(init(key, (d, k))) for key, d in zip(jax.random.split(rng, len(dims)), dims)]
    heads = []
    for _ in range(outer_steps):
        rng, sub = jax.random.split(rng)
        keys = jax.random.split(jax.random.split(sub)[0], len(dims))
        heads.append([np.asarray(init(key, (d, k))) for key, d in zip(keys, dims)])
    assert task[0].dtype == np.float64
    return pteacher.TeacherDraws(task=task, heads=heads)


def _exact_jax_views():
    """sklearn's PCA on the windows in float64, so that it is exact."""
    original = jteacher.build_views
    return mock.patch.object(jteacher, "build_views",
                             lambda x_all, *a, **kw: original(np.asarray(x_all, np.float64), *a, **kw))


# --------------------------------------------------------------------------- #
# (a) soft_ce, the outer step, the fit
# --------------------------------------------------------------------------- #


def test_soft_ce_and_its_closed_form_gradient_match_jax():
    """Targets below the clip, above it and rows not summing to 1."""
    rng = np.random.default_rng(0)
    logits = rng.normal(scale=3.0, size=(32, 5))
    targets = rng.dirichlet(np.ones(5) * 0.3, size=32) * rng.uniform(0.5, 1.5, size=(32, 1))
    targets[:4, 0] = 1e-12
    targets[4, 1] = 1.7
    want = jteacher.soft_ce(jnp.asarray(logits), jnp.asarray(targets))
    want_grad = jax.grad(jteacher.soft_ce)(jnp.asarray(logits), jnp.asarray(targets))
    lt, tt = torch.as_tensor(logits), torch.as_tensor(targets)
    _close(pteacher.soft_ce(lt, tt), want, 1e-10)
    _close(pteacher.soft_ce_grad(lt, pteacher.ce_grad_terms(tt, 1 / 32)), want_grad, 1e-10)
    # The inner fit's form: logits = u / head_temp, the gradient over u.
    want_u = jax.grad(lambda u: jteacher.soft_ce(u / 0.35, jnp.asarray(targets)))(jnp.asarray(logits))
    _close(pteacher.soft_ce_grad(lt / 0.35, pteacher.ce_grad_terms(tt, 1 / (32 * 0.35))), want_u, 1e-10)
    p = rng.dirichlet(np.ones(5), size=8)
    p[0, 2] = 0.0
    _close(pteacher._entropy(torch.as_tensor(p)), jteacher._entropy(jnp.asarray(p)), 1e-12)
    f = rng.normal(size=(8, 6))
    f[1] = 0.0
    _close(pteacher._normalize(torch.as_tensor(f)), jteacher._normalize(jnp.asarray(f)), 1e-12)


STEP_DIMS, STEP_K, STEP_B = (6, 5, 4), 4, 64


@pytest.fixture(scope="module")
def jax_outer_steps():
    """One compile of the JAX outer step per parity (10 inner steps, the
    teacher's default temperatures and weights): its loss and updated task
    parameters from PRNGKey(1)'s init, the heads drawn from PRNGKey(2)."""
    cfg = jconfig.TurtleTeacherCfg()
    kw = dict(outer_steps=10, inner_steps=10, head_temp=cfg.teacher_head_temp, task_temp=cfg.teacher_task_temp,
              gamma=cfg.teacher_gamma, alpha_sample_entropy=cfg.teacher_alpha_sample_entropy)
    init_fn, step_fn, _ = jteacher.make_turtle_step(STEP_DIMS, STEP_K, **kw)
    rng = np.random.default_rng(3)
    feats = [rng.normal(size=(STEP_B, d)).astype(np.float32) for d in STEP_DIMS]
    out = {}
    for odd in (False, True):
        task, opt_state = init_fn(jax.random.PRNGKey(1))
        new_task, _, loss = step_fn(task, opt_state, [jnp.asarray(f) for f in feats], jax.random.PRNGKey(2),
                                    jnp.float32(0.3), odd)
        out[odd] = (task, new_task, loss)
    return kw, feats, out


@pytest.mark.parametrize("odd", [False, True], ids=["even", "odd"])
def test_outer_step_matches_jax(jax_outer_steps, odd):
    kw, feats, out = jax_outer_steps
    task, new_task, loss = out[odd]
    keys = jax.random.split(jax.random.split(jax.random.PRNGKey(2))[0], len(STEP_DIMS))
    heads = [np.asarray(jax.nn.initializers.lecun_normal()(k, (d, STEP_K))) for k, d in zip(keys, STEP_DIMS)]
    init_fn, step_fn = pteacher.make_turtle_step(STEP_DIMS, STEP_K, **kw)
    p_task, p_opt = init_fn([torch.tensor(np.asarray(t["w"])) for t in task])
    got = step_fn(p_task, p_opt, [torch.as_tensor(f, dtype=torch.float64) for f in feats],
                  [torch.tensor(h) for h in heads], 0.3, odd)
    _close(got, loss, 1e-6)
    want = from_flax_params(jax.tree_util.tree_map(np.asarray, new_task), kind="TaskEncoder")
    before = from_flax_params(jax.tree_util.tree_map(np.asarray, task), kind="TaskEncoder")
    state = p_task.state_dict()
    assert set(state) == set(want) == {f"{p}.{v}" for p in "wb" for v in range(3)}
    for name, value in state.items():
        _close(value, want[name], 1e-6)
        assert (value.float() - before[name]).abs().max() > 1e-4, name


@pytest.mark.parametrize("n,k,outer,inner,batch", [(64, 3, 6, 3, 32), (128, 4, 40, 10, 64)],
                         ids=["test_teacher_size", "40x10"])
def test_fit_turtle_teacher_matches_jax(n, k, outer, inner, batch):
    part, latents = _windows(n, n)
    j_ds, p_ds = _datasets(part)
    common = jconfig.CommonFitCfg(n_components=k, seed=5)
    tcfg = jconfig.TurtleTeacherCfg(use_turtle_teacher=True, teacher_outer_steps=outer,
                                    teacher_inner_steps=inner, teacher_batch_size=batch)
    with _exact_jax_views():
        want_tau, want_w = jteacher.fit_turtle_teacher(latents, j_ds, common, tcfg, verbose=False)
    p_common = pconfig.CommonFitCfg(n_components=k, seed=5)
    p_tcfg = pconfig.TurtleTeacherCfg(use_turtle_teacher=True, teacher_outer_steps=outer,
                                      teacher_inner_steps=inner, teacher_batch_size=batch)
    dims = [32, 32, 4]
    tau, w = pteacher.fit_turtle_teacher(latents.astype(np.float64), p_ds, p_common, p_tcfg, verbose=False,
                                         device="cpu", draws=_jax_draws(5, dims, k, outer))
    assert tau.dtype == w.dtype == torch.float32 and tau.shape == (n, k)
    _close(tau, want_tau, 1e-5)
    _close(w, want_w, 1e-5)
    np.testing.assert_allclose(_np(tau).sum(1), 1.0, atol=1e-6)
    # The port's own draws: a generator of the seed on the fit's device.
    tau2, _ = pteacher.fit_turtle_teacher(torch.as_tensor(latents), p_ds, p_common, p_tcfg, verbose=False)
    assert tau2.device.type == "cpu" and tau2.shape == (n, k) and torch.isfinite(tau2).all()


@pytest.mark.parametrize("n,solver", [(300, "full"), (1000, "covariance_eigh")])
def test_build_views_match_sklearn_where_it_is_exact(n, solver):
    """Positions (96 features), speeds (48), edges (56) and the latents."""
    part, latents = _windows(7, n)
    want = jteacher.build_views(part[0].astype(np.float64), latents, edges_all=part[1].astype(np.float64),
                                include_edges=True)
    got = pteacher.build_views(part[0], latents, edges_all=part[1], include_edges=True, device="cpu")
    from sklearn.decomposition import PCA
    pca = PCA(n_components=32)
    pca.fit(part[0][..., :2].reshape(n, -1).astype(np.float64))
    assert pca._fit_svd_solver == solver
    assert [tuple(v.shape) for v in got] == [w.shape for w in want] == [(n, 32)] * 3 + [(n, 4)]
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w, 1e-8)


def test_initialize_gmm_from_teacher_matches_jax():
    """Two blobs and a third component of mass < 1e-4 (the data's moments)."""
    rng = np.random.default_rng(1)
    z = np.concatenate([rng.normal(-3, 0.2, (60, 4)), rng.normal(3, 0.5, (60, 4))]).astype(np.float32)
    tau = np.zeros((120, 3))
    tau[:60, 0] = 0.9
    tau[60:, 1] = 0.9
    tau[:, 2] = 1e-7
    tau[:60, 1] = tau[60:, 0] = 0.1 - 1e-7
    tau = tau.astype(np.float32)
    want = jteacher.initialize_gmm_from_teacher(z, tau)
    got = pteacher.initialize_gmm_from_teacher(torch.as_tensor(z), torch.as_tensor(tau))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w, 1e-10)
    np.testing.assert_array_equal(_np(got[0])[2], z.astype(np.float64).mean(0).astype(np.float32))


# --------------------------------------------------------------------------- #
# (b) The diagnostics
# --------------------------------------------------------------------------- #


class _Bundle:
    def __init__(self, model, q):
        self.rebuild_spec, self.q = {"model": model}, q

    def group(self, x, a, angles=None):
        return self.q


def test_diagnostics_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    q = rng.dirichlet(np.ones(5) * 0.5, size=40)
    q[0] = [1.0, 0.0, 0.0, 0.0, 0.0]
    tau = rng.dirichlet(np.ones(5), size=40)
    for tau_in in (None, tau, tau[:7]):
        want = jdiag.compute_diagnostics(q, tau_in)
        got = pdiag.compute_diagnostics(torch.as_tensor(q), None if tau_in is None else torch.as_tensor(tau_in))
        assert set(got) == set(want)
        for key in want:
            assert abs(got[key] - want[key]) <= 1e-12
        want = jdiag.alignment_score(q.astype(np.float32), tau_in)
        got = pdiag.alignment_score(torch.as_tensor(q, dtype=torch.float32), tau_in)
        assert set(got) == set(want) and all(abs(got[k] - want[k]) <= 1e-12 for k in want)
        assert 0.0 <= got["alignment_score"] <= 1.0
    want_q = jdiag.get_q(_Bundle("VaDE", jnp.asarray(q)), None, None)
    _close(pdiag.get_q(_Bundle("VaDE", torch.as_tensor(q)), None, None), want_q, 1e-12)
    with pytest.raises(ValueError, match="Contrastive"):
        pdiag.get_q(_Bundle("Contrastive", torch.as_tensor(q)), None, None)

    means, log_vars = rng.normal(size=(4, 3)), rng.normal(size=(4, 3))
    want = jdiag.compute_gmm_diagnostics({"latent_space": {"gmm_means": means, "gmm_log_vars": log_vars}})
    got = pdiag.compute_gmm_diagnostics({"latent_space.gmm_means": torch.as_tensor(means),
                                         "latent_space.gmm_log_vars": torch.as_tensor(log_vars)})
    assert set(got) == set(want) and all(abs(got[k] - want[k]) <= 1e-12 for k in want)
    assert pdiag.compute_gmm_diagnostics({}) == jdiag.compute_gmm_diagnostics({}) == {}

    history = {"total_loss": [3.0, 2.0, 1.5], "val_total_loss": [2.5], "empty": [], "kl_div": [0.25, 0.125]}
    for last_n in (1, 2):
        assert pdiag.format_loss_table(history, last_n) == jdiag.format_loss_table(history, last_n)

    emb = rng.normal(size=(30, 6))
    for labels in (rng.uniform(size=(30, 3)), rng.uniform(size=(30, 1, 3)), np.ones((30, 2))):
        want = jdiag.label_separation_score(emb, labels)
        assert abs(pdiag.label_separation_score(torch.as_tensor(emb), labels) - want) <= 1e-12
    assert pdiag.label_separation_score(emb, labels, normalize_embeddings=False) == 0.0

    # The writer on a stand-in for torch.utils.tensorboard (whose import
    # takes seconds), then without the package.
    board = mock.MagicMock()
    with mock.patch.dict("sys.modules", {"torch.utils.tensorboard": board}):
        writer = pdiag.MetricsWriter(str(tmp_path / "tb"))
    writer.log_scalars({"diag/confidence": 0.5, "diag/balance": 1}, step=3)
    writer.close()
    board.SummaryWriter.assert_called_once_with(str(tmp_path / "tb"))
    assert board.SummaryWriter.return_value.add_scalar.call_args_list == [
        mock.call("diag/confidence", 0.5, 3), mock.call("diag/balance", 1.0, 3)]
    board.SummaryWriter.return_value.close.assert_called_once_with()
    pdiag.MetricsWriter().log_scalars({"x": 1.0}, 0)
    with mock.patch.dict("sys.modules", {"torch.utils.tensorboard": None}):
        with pytest.raises(ImportError, match="tensorboard"):
            pdiag.MetricsWriter(str(tmp_path / "tb2"))


# --------------------------------------------------------------------------- #
# (c) The distillation term and a distilled VaDE step
# --------------------------------------------------------------------------- #


class _JaxRecon:
    def log_prob(self, x):
        return jnp.zeros(x.shape[:2])


class _TorchRecon:
    def log_prob(self, x):
        return x.new_zeros(x.shape[:2])


@pytest.mark.parametrize("sharpen", [0.5, 0.0])
@pytest.mark.parametrize("conf", [False, True])
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "class_weight"])
def test_distillation_term_matches_jax(sharpen, conf, weighted):
    """The term alone (every other weight 0) and its gradient with respect
    to the posterior, the JAX package's through ``jax.grad``."""
    rng = np.random.default_rng(4)
    q = rng.dirichlet(np.ones(K), size=B).astype(np.float32)
    q[0, 1] = 0.0
    tau = rng.dirichlet(np.ones(K) * 0.5, size=B).astype(np.float32)
    cw = rng.uniform(0.5, 3.0, size=K).astype(np.float32) if weighted else None
    x = np.zeros((B, T, N, 3), np.float32)
    kw = dict(n_components=K, l1_activity_weight=0.0, distill_sharpen_T=sharpen, distill_conf_weight=conf,
              distill_conf_thresh=0.3)
    zeros = np.zeros((B, LATENT), np.float32)

    def jax_distill(qq):
        out = {"reconstruction": _JaxRecon(), "latent": zeros, "categorical": qq, "kmeans_loss": 0.0,
               "z_mean": zeros, "z_log_var": zeros, "gmm_params": {}}
        return jlosses.vade_loss(out, jnp.asarray(x), jlosses.VadeLossParams(**kw), 0.0, jax.random.PRNGKey(0),
                                 tau_star_batch=jnp.asarray(tau), lambda_distill=2.5,
                                 class_weight=None if cw is None else jnp.asarray(cw))["distill_loss"]

    qt = torch.tensor(q, requires_grad=True)
    zt = torch.zeros(B, LATENT)
    out = {"reconstruction": _TorchRecon(), "latent": zt, "categorical": qt, "kmeans_loss": zt.sum(),
           "z_mean": zt, "z_log_var": zt, "gmm_params": {}}
    logs = plosses.vade_loss(out, torch.as_tensor(x), plosses.VadeLossParams(**kw), 0.0,
                             tau_star_batch=torch.as_tensor(tau), lambda_distill=2.5,
                             class_weight=None if cw is None else torch.as_tensor(cw))
    _close(logs["distill_loss"], jax_distill(jnp.asarray(q)))
    _close(logs["total_loss"], logs["distill_loss"], 0.0)
    logs["total_loss"].backward()
    want = np.asarray(jax.grad(jax_distill)(jnp.asarray(q)))
    _close(qt.grad, want, 1e-5 * max(1.0, float(np.abs(want).max())))


@pytest.fixture(scope="module")
def jax_distilled_step():
    """One compile of the JAX make_vade_step in the main phase with every
    optional weight on and the teacher's confidence weighting: its logs and
    the gradients it applied (optax.trace at decay 0, moved by scale 0)."""
    jm, params, pm, x, a = _jax_vade(71)
    kw = dict(n_components=K, pretrain_mode=False, distill_conf_weight=True, **ALL_ON)
    rng = np.random.default_rng(72)
    tau = rng.dirichlet(np.ones(K) * 0.5, size=B).astype(np.float32)
    cw = rng.uniform(0.5, 3.0, size=K).astype(np.float32)
    opt = optax.chain(optax.trace(decay=0.0), optax.scale(0.0))
    step = jharness.make_vade_step(jm, opt, jlosses.VadeLossParams(**kw))
    copy = jax.tree_util.tree_map(jnp.array, params)
    key = jax.random.PRNGKey(73)
    _, state, _, logs = step(copy, opt.init(copy), {}, jnp.asarray(x), jnp.asarray(a), key, jnp.float32(0.6),
                             jnp.float32(3.2), jnp.asarray(tau), jnp.asarray(cw))
    return params, x, a, kw, tau, cw, logs, state[0].trace, _step_noise(key)


def test_distilled_vade_step_matches_jax(jax_distilled_step):
    params, x, a, kw, tau, cw, logs, grads, (eps_z, eps_kl) = jax_distilled_step
    pm = build_model("VaDE", (T, N, 3), (T, E, 1), ADJ, LATENT, K, device="cpu", kmeans_loss=0.5)
    pm.load_state_dict(from_flax_params(params, kind="VaDE"))
    total, got = pharness.vade_step_loss(
        pm, torch.as_tensor(x), torch.as_tensor(a), None, plosses.VadeLossParams(**kw), 0.6,
        torch.as_tensor(eps_z), torch.as_tensor(eps_kl), tau_star_batch=torch.as_tensor(tau), lambda_distill=3.2,
        class_weight=torch.as_tensor(cw))
    assert set(got) == set(logs)
    for k, v in logs.items():
        _close(got[k], v, 1e-4 if k in ("total_loss", "reconstruct_loss") else 1e-5)
    assert float(logs["distill_loss"]) > 0.1
    total.backward()
    _param_grads_close(pm, grads, "VaDE")


# --------------------------------------------------------------------------- #
# (d) The best-score rule
# --------------------------------------------------------------------------- #

RULE_CASES = {
    # Improvements before the start epoch, a tie within 0.01 at a lower
    # validation loss, a tie at a higher one, a NaN.
    "ties": (12, 0, [0.1, 0.5, 0.6, 0.55, 0.58, 0.585, 0.59, 0.595, np.nan, 0.7, 0.69, 0.71],
             [5.0, 4.0, 3.0, 3.5, 2.0, 2.5, 1.0, 1.5, 0.5, 0.9, 0.8, 0.95]),
    # 40 epochs: the rule waits for more than ceil(0.1 * 40) = 4.
    "long": (40, 0, list(np.linspace(0.2, 0.6, 20)) + list(np.linspace(0.6, 0.59, 20)),
             list(np.linspace(3.0, 1.0, 40))),
    # A resumed run from epoch 5 keeps the rule's start and starts its
    # running best anew.
    "resumed": (12, 5, [0.9] * 5 + [0.3, 0.305, 0.2, 0.8, 0.79, 0.795, 0.5],
                [1.0] * 5 + [2.0, 1.0, 0.5, 3.0, 2.0, 3.0, 1.0]),
}


@pytest.mark.parametrize("case", list(RULE_CASES))
def test_best_score_rule_picks_the_jax_epochs(case):
    n_epochs, start, scores, vals = RULE_CASES[case]
    part, _ = _windows(9, 8)
    j_ds, p_ds = _datasets(part)
    picked = {}
    for name, run, ds in (("jax", jharness._run_epochs, j_ds), ("port", pharness._run_epochs, p_ds)):
        events, history = [], {}
        kw = dict(mesh=None) if name == "jax" else {}
        run(n_epochs=n_epochs, train_ds=ds, val_ds=ds, batch_size=4, rng_seed=0,
            train_fn=lambda x, a, ang, idx, epoch: {"total_loss": 0.0},
            eval_fn=lambda x, a, ang, idx, epoch: {"total_loss": vals[epoch]}, history=history,
            verbose=False, start_epoch=start, on_best=lambda e, v: events.append(("val", e, v)),
            score_fn=lambda e: scores[e], on_best_score=lambda e, s, v: events.append(("score", e, s, v)), **kw)
        picked[name] = (events, {k: [float(x) for x in v] for k, v in history.items()})
    assert [e for e in picked["port"][0] if e[0] == "score"], case
    np.testing.assert_equal(picked["port"], picked["jax"])
    assert len(picked["port"][1]["val_alignment_score"]) == n_epochs - start
