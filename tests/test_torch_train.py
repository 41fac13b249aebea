"""The port's training path against the JAX package's, float32 on the CPU:
the GRU layer's gradients, the backward kernel's plain version, the
decoder, the VQ head's losses, the VQ-VAE's training forward, one train
step's loss and gradients, the clipped Adam, the batch order, bundle
persistence and a short ``deep_unsupervised_embedding`` that
``embedding_per_video`` then serves.

Inputs are numpy draws from fixed seeds, fed to both packages; JAX weights
cross over with ``from_flax_params``, and JAX gradient trees cross the same
way (they have the parameters' structure). Bars:
- forwards and losses: max |diff| <= 1e-5 (ROADMAP's model bar);
- gradients: max |diff| <= 1e-5 * max(1, max |g|) per tensor, since
  float32 gradients sum many per-step terms in another order, which scales
  their rounding with their largest entry;
- the backward's plain version against autograd (float64): 1e-10;
- Adam after three steps: 1e-6 (two implementations of one formula in
  float32).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as fnn
import optax

from deepof_tpu.models import blocks as jblocks
from deepof_tpu.models import decoders as jdec
from deepof_tpu.models import heads as jheads
from deepof_tpu.models import zoo as jzoo
from deepof_tpu.train import dataset as jdataset
from deepof_tpu.train import harness as jharness

from deepof_tpu_torch.data import Project
from deepof_tpu_torch.models import blocks as pblocks
from deepof_tpu_torch.models import decoders as pdec
from deepof_tpu_torch.models import heads as pheads
from deepof_tpu_torch.models.zoo import build_model
from deepof_tpu_torch.ops.gru_kernels import (
    GRULayerFunction,
    gru_gate_grads_plain,
    gru_scan_backward,
    gru_scan_backward_plain,
    gru_scan_carries,
    gru_scan_plain,
)
from deepof_tpu_torch.train import dataset as pdataset
from deepof_tpu_torch.train import harness as pharness
from deepof_tpu_torch.train.inference import ModelBundle, embedding_per_video
from deepof_tpu_torch.weights import from_flax_params

from test_torch_public import _project_args, write_project

TOL = 1e-5
GRAD_RTOL = 1e-5
ADJ = np.zeros((5, 5), np.float32)
for _i, _j in [(0, 1), (1, 2), (2, 3), (1, 4)]:
    ADJ[_i, _j] = ADJ[_j, _i] = 1.0
N, E, T, B, LATENT, K = 5, 4, 8, 6, 4, 5


def _noise(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda v: rng.normal(scale=0.3, size=v.shape).astype(np.float32), tree)


def _init(module, seed, *args, **kwargs):
    shapes = jax.eval_shape(lambda *a: module.init(jax.random.PRNGKey(0), *a, **kwargs), *args)["params"]
    return _noise(shapes, seed)


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=tol)


def _grad_close(got, want, name=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, name
    bar = GRAD_RTOL * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bar, f"{name}: max |diff| {err:.3e} > {bar:.3e}"


def _param_grads_close(module, jax_grads, kind):
    """Every parameter gradient of the port's ``module`` against the JAX
    gradient tree carried over like weights."""
    want = from_flax_params(jax.tree_util.tree_map(np.asarray, jax_grads), kind=kind)
    names = dict(module.named_parameters())
    assert set(names) == set(want)
    for name, p in names.items():
        assert p.grad is not None, name
        _grad_close(p.grad, want[name].numpy(), name)


def _windows(rng, b=B):
    """Node (B, T, N, 3) and edge (B, T, E, 1) windows with zero-padded tails,
    an all-zero window (prefix length 0, an all-masked target) and a zero
    frame inside a window (an arbitrary decoder mask)."""
    x = rng.normal(size=(b, T, N, 3)).astype(np.float32)
    a = rng.normal(size=(b, T, E, 1)).astype(np.float32)
    x[0] = 0.0
    a[0] = 0.0
    x[1, -3:] = 0.0
    x[2, 3] = 0.0
    return x, a


# --------------------------------------------------------------------------- #
# The GRU layer
# --------------------------------------------------------------------------- #


def _gru_mask(kind, rng, b, t):
    if kind == "prefix":
        lengths = rng.integers(0, t + 1, size=b)
        lengths[0], lengths[1] = 0, t
        return np.arange(t)[None] < lengths[:, None]
    mask = rng.random((b, t)) < 0.7
    mask[0] = False
    return mask


@pytest.mark.parametrize("mask_kind", ["prefix", "random"])
@pytest.mark.parametrize("with_norm,outputs", [(False, True), (True, False), (True, True), (False, False)])
def test_gru_layer_gradients_match_jax(mask_kind, with_norm, outputs):
    """gru_scan_plain's gradients (x, both directions' weights, the
    LayerNorm) against jax.grad of the JAX BiGRU (flax nn.scan) behind a
    flax LayerNorm, for outputs and final carries."""
    rng = np.random.default_rng(11)
    b, t, f, h = 7, 9, 6, 5
    x = rng.normal(size=(b, t, f)).astype(np.float32)
    mask = _gru_mask(mask_kind, rng, b, t)
    go = rng.normal(size=(b, t, 2 * h)).astype(np.float32)
    gf = rng.normal(size=(b, 2 * h)).astype(np.float32)
    jm, ln = jblocks.BiGRU(h), fnn.LayerNorm(epsilon=1e-3)
    params = _init(jm, 12, jnp.asarray(x), jnp.asarray(mask))
    ln_params = _init(ln, 13, jnp.asarray(x))

    def loss(p, lp, xx):
        y = ln.apply({"params": lp}, xx) if with_norm else xx
        out, fin = jm.apply({"params": p}, y, jnp.asarray(mask))
        return jnp.sum(fin * gf) + (jnp.sum(out * go) if outputs else 0.0)

    g_params, g_ln, g_x = jax.grad(loss, argnums=(0, 1, 2))(params, ln_params, jnp.asarray(x))

    pm = pblocks.BiGRU(f, h)
    pm.load_state_dict(from_flax_params(params, kind="BiGRU"))
    xt = torch.as_tensor(x).requires_grad_()
    gamma = torch.as_tensor(np.asarray(ln_params["scale"])).requires_grad_()
    beta = torch.as_tensor(np.asarray(ln_params["bias"])).requires_grad_()
    out, fin = pm(xt, torch.as_tensor(mask), norm=(gamma, beta, 1e-3) if with_norm else None, outputs=outputs)
    assert (out is None) == (not outputs)
    total = (fin * torch.as_tensor(gf)).sum() + ((out * torch.as_tensor(go)).sum() if outputs else 0.0)
    total.backward()
    _close(total, loss(params, ln_params, jnp.asarray(x)), 1e-4)
    _grad_close(xt.grad, g_x, "x")
    _param_grads_close(pm, g_params, "BiGRU")
    if with_norm:
        _grad_close(gamma.grad, g_ln["scale"], "gamma")
        _grad_close(beta.grad, g_ln["bias"], "beta")


def _gru_case(seed, b, t, f, h, d, mask_kind, outputs):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(b, t, f)))
    mask = torch.as_tensor(_gru_mask(mask_kind, rng, b, t))
    weights = [torch.as_tensor(rng.normal(scale=0.5, size=s)) for s in
               ((d, f, 3 * h), (d, 3 * h), (d, h, 3 * h), (d, h))]
    d_out = torch.as_tensor(rng.normal(size=(b, t, d * h))) if outputs else None
    d_fin = torch.as_tensor(rng.normal(size=(b, d * h)))
    reverse = (False, True) if d == 2 else (True,)
    return x, mask, weights, reverse, d_out, d_fin


def _scan_with_taps(x, mask, wi, bi, wh, bhn, reverse, tap_g, tap_hn):
    """gru_scan_plain's recurrence (un-normed) with taps added to the gate
    pre-activations, x W_i + b_i + tap_g (B, T, D, 3H) and h W_hn + b_hn +
    tap_hn (B, T, D, H): at zero taps their gradients are dG and dHn."""
    b, t, _ = x.shape
    d, h = bhn.shape
    outs, finals = [], []
    for k in range(d):
        xg = x @ wi[k] + bi[k] + tap_g[:, :, k]
        carry = x.new_zeros((b, h))
        out = [None] * t
        for s in (range(t - 1, -1, -1) if reverse[k] else range(t)):
            g, hg = xg[:, s], carry @ wh[k]
            r = torch.sigmoid(g[:, :h] + hg[:, :h])
            z = torch.sigmoid(g[:, h:2 * h] + hg[:, h:2 * h])
            n = torch.tanh(g[:, 2 * h:] + r * (hg[:, 2 * h:] + bhn[k] + tap_hn[:, s, k]))
            m = mask[:, s, None]
            new = (1.0 - z) * n + z * carry
            carry = torch.where(m, new, carry)
            out[s] = torch.where(m, new, 0.0)
        outs.append(torch.stack(out, 1))
        finals.append(carry)
    return torch.cat(outs, -1), torch.cat(finals, -1)


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("mask_kind", ["prefix", "random"])
@pytest.mark.parametrize("outputs", [True, False])
def test_backward_plain_matches_autograd(d, mask_kind, outputs):
    """gru_scan_backward on CPU tensors (its plain version), from the
    carries gru_scan_carries stores, against autograd of gru_scan_plain
    (float64): dx and every weight and bias gradient; the plain gate
    gradients (gru_gate_grads_plain) against the gradients of the gate
    pre-activations, zero at masked steps; GRULayerFunction on the CPU
    gives the same."""
    x, mask, weights, reverse, d_out, d_fin = _gru_case(5 + d, 6, 7, 4, 3, d, mask_kind, outputs)
    out, fin, hs = gru_scan_carries(x, mask, *weights, reverse, outputs)
    p_out, p_fin = gru_scan_plain(x, mask, *weights, reverse, None, outputs)
    assert torch.equal(fin, p_fin) and (out is None or torch.equal(out, p_out))
    got = gru_scan_backward(x, mask, *weights, reverse, hs, d_out, d_fin)
    assert len(got) == 5
    assert all(torch.equal(a, b) for a, b in zip(got, gru_scan_backward_plain(x, mask, *weights, reverse, hs, d_out, d_fin)))

    leaves = [x.clone().requires_grad_()] + [w.clone().requires_grad_() for w in weights]
    o, f_ = gru_scan_plain(leaves[0], mask, *leaves[1:], reverse, None, outputs)
    total = (f_ * d_fin).sum() + ((o * d_out).sum() if outputs else 0.0)
    want = torch.autograd.grad(total, leaves)
    for name, g, w in zip(("dx", "dwi", "dbi", "dwh", "dbhn"), got, want):
        assert g.shape == w.shape, name
        torch.testing.assert_close(g, w, rtol=0, atol=1e-10, msg=name)

    dg, dhn = gru_gate_grads_plain(x, mask, *weights, reverse, hs, d_out, d_fin)
    b, t, _ = x.shape
    h = weights[3].shape[1]
    taps = [torch.zeros(b, t, d, 3 * h, dtype=x.dtype, requires_grad=True),
            torch.zeros(b, t, d, h, dtype=x.dtype, requires_grad=True)]
    o, f_ = _scan_with_taps(x, mask, *weights, reverse, *taps)
    total = (f_ * d_fin).sum() + ((o * d_out).sum() if outputs else 0.0)
    want_dg, want_dhn = torch.autograd.grad(total, taps)
    torch.testing.assert_close(dg, want_dg, rtol=0, atol=1e-10, msg="dG")
    torch.testing.assert_close(dhn, want_dhn, rtol=0, atol=1e-10, msg="dHn")
    assert not dg[~mask].any() and not dhn[~mask].any()  # masked steps: zero gate gradients
    assert dg.abs().max() > 0 and dhn.abs().max() > 0

    fn_leaves = [v.clone().requires_grad_() for v in leaves]
    o, f_ = GRULayerFunction.apply(fn_leaves[0], mask, *fn_leaves[1:], reverse, outputs)
    total = (f_ * d_fin).sum() + ((o * d_out).sum() if outputs else 0.0)
    for g, w in zip(torch.autograd.grad(total, fn_leaves), want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-10)


def test_backward_without_gradients_and_shape_checks():
    x, mask, weights, reverse, _, _ = _gru_case(3, 4, 5, 3, 2, 2, "prefix", True)
    _, _, hs = gru_scan_carries(x, mask, *weights, reverse)
    dx, *dw = gru_scan_backward(x, mask, *weights, reverse, hs)
    assert [tuple(v.shape) for v in (dx, *dw)] == [(4, 5, 3), (2, 3, 6), (2, 6), (2, 2, 6), (2, 2)]
    assert not dx.any() and not any(v.any() for v in dw)
    dg, dhn = gru_gate_grads_plain(x, mask, *weights, reverse, hs)
    assert not dg.any() and not dhn.any()
    with pytest.raises(ValueError, match="hs must be"):
        gru_scan_backward(x, mask, *weights, reverse, hs[:, 1:])
    with pytest.raises(ValueError, match="d_fin must be"):
        gru_scan_backward(x, mask, *weights, reverse, hs, None, torch.zeros(4, 3, dtype=x.dtype))


# --------------------------------------------------------------------------- #
# Decoder, VQ head, VQ-VAE
# --------------------------------------------------------------------------- #


def test_recurrent_decoder_matches_jax():
    """Forward (means and validity under an arbitrary mask) and gradients of
    a log-likelihood through the decoder, against the JAX module."""
    rng = np.random.default_rng(21)
    g = rng.normal(size=(B, LATENT)).astype(np.float32)
    target = rng.normal(size=(B, T, 7)).astype(np.float32)
    target[0] = 0.0
    target[1, 2] = 0.0
    target[3, -2:] = 0.0
    jm = jdec.RecurrentDecoder(output_dim=7, latent_dim=LATENT)
    params = _init(jm, 22, jnp.asarray(g), jnp.asarray(target))

    def loss(p, gg):
        dist = jm.apply({"params": p}, gg, jnp.asarray(target))
        return -jnp.mean(dist.log_prob(jnp.asarray(target))), dist

    (j_loss, j_dist), (g_params, g_g) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(g))
    pm = pdec.RecurrentDecoder(7, LATENT)
    pm.load_state_dict(from_flax_params(params, kind="RecurrentDecoder"))
    gt = torch.as_tensor(g).requires_grad_()
    dist = pm(gt, torch.as_tensor(target))
    np.testing.assert_array_equal(dist.mask.numpy(), np.asarray(j_dist.mask))
    assert not dist.mask[0].any() and not dist.mask[1, 2]
    _close(dist.loc, j_dist.loc)
    _close(dist.mean, j_dist.mean)
    p_loss = -dist.log_prob(torch.as_tensor(target)).mean()
    _close(p_loss, j_loss)
    p_loss.backward()
    _grad_close(gt.grad, g_g, "g")
    _param_grads_close(pm, g_params, "RecurrentDecoder")


def test_probabilistic_head_nan_to_num():
    """Non-finite means become 0 / +-1e6 and pass no gradient, as
    jnp.nan_to_num's."""
    head = pdec.ProbabilisticHead(2, 3)
    w = np.array([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]], np.float32)
    with torch.no_grad():
        head.dense.weight.copy_(torch.as_tensor(w))
    hv = np.array([[[1.0, 2.0], [np.inf, 1.0], [np.nan, 0.5]]], np.float32)
    h = torch.tensor(hv, requires_grad=True)
    dist = head(h, torch.tensor([[True, False, True]]))

    def jloc(v):
        return jnp.nan_to_num(v @ jnp.asarray(w).T, nan=0.0, posinf=1e6, neginf=-1e6)

    np.testing.assert_array_equal(dist.loc.detach().numpy(), np.asarray(jloc(jnp.asarray(hv))))
    assert dist.loc[0, 1].tolist() == [1e6, 0.0, 1e6]
    dist.loc.sum().backward()
    np.testing.assert_array_equal(h.grad.numpy(), np.asarray(jax.grad(lambda v: jnp.sum(jloc(v)))(jnp.asarray(hv))))
    assert h.grad[0, 1:].eq(0).all()


@pytest.mark.parametrize("kmeans", [0.0, 0.7])
def test_vector_quantizer_losses_match_jax(kmeans):
    """Straight-through code, soft counts, vq_loss and kmeans_loss, and the
    gradients of their sum with a code readout, against the JAX head."""
    rng = np.random.default_rng(31)
    z = rng.normal(size=(9, LATENT)).astype(np.float32)
    w = rng.normal(size=(9, LATENT)).astype(np.float32)
    jm = jheads.VectorQuantizer(n_components=K, embedding_dim=LATENT, kmeans_loss=kmeans)
    params = _init(jm, 32, jnp.asarray(z))

    def loss(p, zz):
        q, sc, losses = jm.apply({"params": p}, zz)
        return jnp.sum(q * w) + sum(losses.values()), (q, sc, losses)

    (_, (q, sc, losses)), (g_params, g_z) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(z))
    assert ("kmeans_loss" in losses) == bool(kmeans)
    pm = pheads.VectorQuantizer(K, LATENT, kmeans_loss=kmeans)
    pm.load_state_dict(from_flax_params(params, kind="VectorQuantizer"))
    zt = torch.as_tensor(z).requires_grad_()
    pq, psc, plosses = pm(zt, return_losses=True)
    assert set(plosses) == set(losses)
    _close(pq, q)
    _close(psc, sc)
    for k in losses:
        _close(plosses[k], losses[k])
    ((pq * torch.as_tensor(w)).sum() + sum(plosses.values())).backward()
    _grad_close(zt.grad, g_z, "z")
    _grad_close(pm.codebook.grad, g_params["codebook"], "codebook")
    # The eval call serving uses keeps its results.
    q_eval, sc_eval = pm(zt)
    _close(q_eval, jm.apply({"params": params}, jnp.asarray(z), return_losses=False)[0])


def _jax_vqvae(kmeans=0.0, seed=41):
    rng = np.random.default_rng(seed)
    x, a = _windows(rng)
    jm = jzoo.build_model("VQVAE", (T, N, 3), (T, E, 1), ADJ, latent_dim=LATENT, n_components=K, kmeans_loss=kmeans)
    params = _init(jm, seed + 1, jnp.asarray(x), jnp.asarray(a))
    pm = build_model("VQVAE", (T, N, 3), (T, E, 1), ADJ, LATENT, K, device="cpu", kmeans_loss=kmeans)
    pm.load_state_dict(from_flax_params(params))
    return jm, params, pm, x, a


def test_vqvae_training_forward_matches_jax():
    jm, params, pm, x, a = _jax_vqvae()
    want = jax.jit(lambda p, xx, aa: jm.apply({"params": p}, xx, aa, train=True))(params, jnp.asarray(x), jnp.asarray(a))
    with torch.no_grad():
        got = pm.training_forward(torch.as_tensor(x), torch.as_tensor(a))
    assert pm.training
    for key in ("quantized", "soft_counts", "encoder_output"):
        _close(got[key], want[key])
    for key in ("quantized_reconstruction", "encoding_reconstruction"):
        _close(got[key].loc, want[key].loc)
        np.testing.assert_array_equal(got[key].mask.numpy(), np.asarray(want[key].mask))
        _close(got[key].log_prob(torch.as_tensor(x).reshape(B, T, -1)),
               want[key].log_prob(jnp.asarray(x).reshape(B, T, -1)), 1e-4)
    _close(got["vq_losses"]["vq_loss"], want["vq_losses"]["vq_loss"])
    # The serving forward is unchanged by the decoder.
    with torch.no_grad():
        serving = pm(torch.as_tensor(x), torch.as_tensor(a))
    assert set(serving) == {"encoder_output", "quantized", "soft_counts"}
    assert torch.equal(serving["encoder_output"], got["encoder_output"])


@pytest.fixture(scope="module")
def jax_step():
    """One compile of the JAX package's make_vqvae_step (kmeans_loss 0.5):
    its logs, and the gradients it applied, read from an optimiser that
    keeps them (optax.trace with decay 0) and moves nothing (scale 0)."""
    jm, params, pm, x, a = _jax_vqvae(kmeans=0.5, seed=51)
    opt = optax.chain(optax.trace(decay=0.0), optax.scale(0.0))
    step = jharness.make_vqvae_step(jm, opt)
    copy = jax.tree_util.tree_map(jnp.array, params)
    _, state, _, logs = step(copy, opt.init(copy), {}, jnp.asarray(x), jnp.asarray(a), jax.random.PRNGKey(0))
    return {"params": params, "model": pm, "x": x, "a": a, "logs": logs, "grads": state[0].trace}


def test_train_step_loss_and_gradients_match_jax(jax_step):
    pm, x, a = jax_step["model"], jax_step["x"], jax_step["a"]
    total, logs = pharness.vqvae_loss(pm, torch.as_tensor(x), torch.as_tensor(a))
    assert set(logs) == set(jax_step["logs"])
    for key, want in jax_step["logs"].items():
        _close(logs[key], want, 1e-4 if key in ("total_loss", "enc_rec_loss", "reconstruct_loss") else TOL)
    assert logs["kmeans_loss"].item() > 0
    total.backward()
    _param_grads_close(pm, jax_step["grads"], "VQVAE")


def test_train_step_updates_and_eval_step():
    """make_vqvae_step moves every parameter (all receive gradients) and
    returns the loss it took; the eval step is enc_rec + rec + vq without
    gradients."""
    jm, params, pm, x, a = _jax_vqvae(seed=61)
    xt, at = torch.as_tensor(x), torch.as_tensor(a)
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    total, logs = pharness.vqvae_loss(pm, xt, at)
    ev = pharness.make_vqvae_eval_step(pm)(xt, at)
    _close(ev["total_loss"], logs["enc_rec_loss"] + logs["reconstruct_loss"] + logs["vq_loss"])
    assert ev["total_loss"].grad_fn is None
    step_logs = pharness.make_vqvae_step(pm, pharness.ClippedAdam(pm.parameters(), 1e-3))(xt, at)
    _close(step_logs["total_loss"], total)
    assert all(not torch.equal(before[k], v) for k, v in pm.state_dict().items())


def test_clipped_adam_matches_optax():
    """Three steps of the port's ClippedAdam against the JAX package's
    _make_optimizer (optax.clip(0.75) then optax.adam), gradients large
    enough to clip."""
    rng = np.random.default_rng(71)
    shapes = {"w": (4, 3), "b": (3,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * 2).astype(np.float32) for k, s in shapes.items()} for _ in range(3)]
    opt = jharness._make_optimizer(1e-2)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = opt.init(jp)
    tp = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in params.items()}
    popt = pharness.ClippedAdam(tp.values(), 1e-2)
    for g in grads:
        updates, state = opt.update(jax.tree_util.tree_map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.as_tensor(g[k]).clone()
        popt.step()
    for k in shapes:
        _close(tp[k], jp[k], 1e-6)
    assert any(np.abs(g[k]).max() > 0.75 for g in grads for k in g)


# --------------------------------------------------------------------------- #
# Data, persistence, the entry point
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("bootstrap", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_window_dataset_batches_match_jax(bootstrap, drop_last):
    rng = np.random.default_rng(81)
    data = {key: (rng.normal(size=(n, 4, 5, 3)).astype(np.float32), rng.normal(size=(n, 4, 2, 1)).astype(np.float32),
                  rng.normal(size=(n, 4, 3, 1)).astype(np.float32)) for key, n in (("v1", 530), ("v2", 117))}
    j_ds, p_ds = jdataset.WindowDataset(data), pdataset.WindowDataset(data)
    assert len(p_ds) == len(j_ds) == 647 and p_ds.video_ranges == j_ds.video_ranges
    assert p_ds.n_batches(64) == j_ds.n_batches(64)
    j_rng, p_rng = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(2):  # two epochs from one generator
        kw = dict(shuffle=True, block_size=100, bootstrap=bootstrap, drop_last=drop_last)
        j_batches = list(j_ds.batches(64, rng=j_rng, **kw))
        p_batches = list(pdataset.prefetch(p_ds.batches(64, rng=p_rng, **kw)))
        assert len(p_batches) == len(j_batches)
        for pb, jb in zip(p_batches, j_batches):
            for got, want in zip(pb, jb):
                np.testing.assert_array_equal(got, want)


def test_bundle_save_load_and_what_raises(tmp_path):
    _, _, pm, x, a = _jax_vqvae(seed=91)
    spec = {"model": "VQVAE", "input_shape": [T, N, 3], "edge_feature_shape": [T, E, 1],
            "adjacency": ADJ.astype(int).tolist(), "latent_dim": LATENT, "n_components": K,
            "encoder_type": "recurrent", "use_gnn": True, "use_angles": False, "angle_feature_shape": None}
    bundle = ModelBundle(pm, spec, {"total_loss": [1.5]})
    path = str(tmp_path / "models" / "m.ckpt")
    bundle.save(path)
    loaded = ModelBundle.load(path, device="cpu")
    assert loaded.rebuild_spec == spec and loaded.history == {"total_loss": [1.5]} and not loaded.model.training
    xt, at = torch.as_tensor(x), torch.as_tensor(a)
    with torch.no_grad():
        assert torch.equal(loaded.model.encode(xt, at), pm.encode(xt, at))
        assert torch.equal(loaded.model.group(xt, at), pm.group(xt, at))

    flax_file = tmp_path / "flax.ckpt"
    flax_file.write_bytes(b"\x80\x04}q\x00.")  # a pickle, as the JAX package writes
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        ModelBundle.load(str(flax_file), device="cpu")
    ds = ((({}, {}), {}, ADJ))
    with pytest.raises(ValueError, match="Unknown model_name"):
        pharness.train_deepof_model(ds, ADJ, model_name="GMVAE", device="cpu")
    with pytest.raises(NotImplementedError, match="use_amp"):
        pharness.train_deepof_model(ds, ADJ, model_name="VQVAE", use_amp=True, device="cpu")
    # ``pretrained`` returns the loaded bundle before any of these raises.
    got, score, part, summary = pharness.train_deepof_model(ds, ADJ, model_name="VQVAE", pretrained=path,
                                                            use_amp=True, num_workers=4, device="cpu")
    assert (score, part, summary) == (None, None, {}) and got.rebuild_spec == spec
    with pytest.raises(ValueError, match="num_workers"):
        pharness.train_deepof_model(ds, ADJ, model_name="VQVAE", num_workers=4, device="cpu")
    # spill_to_disk without a dataset_folder keeps the windows in RAM (the
    # JAX package's rule); with one they are mapped from files written there.
    windows = {"v1": (np.ones((5, T, N, 3), np.float32), np.zeros((5, T, E, 1), np.float32),
                      np.zeros((5, T, 0, 1), np.float32))}
    assert pdataset.WindowDataset(windows, spill_to_disk=True)._spill_dir is None
    spilled = pdataset.WindowDataset(windows, dataset_folder=str(tmp_path / "spill"), spill_to_disk=True)
    assert len(spilled) == 5 and spilled.video_ranges == {"v1": (0, 5)} and isinstance(spilled.x, np.memmap)
    np.testing.assert_array_equal(next(spilled.batches(5, shuffle=False))[0], windows["v1"][0])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The public fixture of test_torch_public (2 x 300 frames, two
    deepof_14 animals), one recording held out, through
    deep_unsupervised_embedding for one epoch of 2 train and 1 val batches."""
    root = write_project(tmp_path_factory.mktemp("train_project"), "csv")
    coords = Project(**_project_args(root, "csv"), device="cpu").create(force=True, test=True, verbose=False)
    ggd = coords.get_graph_dataset(window_size=8, test_videos=1)
    bundle, score, part, summary = coords.deep_unsupervised_embedding(
        ggd[:3], adjacency_matrix=ggd[2], embedding_model="VQVAE", batch_size=16, latent_dim=4,
        epochs=1, n_clusters=5, save_checkpoints=True, verbose=False,
        limit_train_batches=2, limit_val_batches=1,
    )
    return coords, ggd, bundle, score, part, summary, root


def test_deep_unsupervised_embedding_trains_saves_and_serves(trained):
    coords, (dataset, meta, adj, tab_dict, scaler), bundle, score, part, summary, root = trained
    assert score is None and part is None
    assert {"total_loss", "vq_loss", "val_total_loss", "val_reconstruct_loss"} <= set(summary)
    assert all(np.isfinite(v) for v in summary.values())
    assert bundle.rebuild_spec["input_shape"] == [8, 28, 3] and bundle.rebuild_spec["edge_feature_shape"] == [8, 32, 1]
    assert bundle.best_state is not None and not bundle.model.training
    models = os.path.join(root, "p", "Trained_models", "models")
    assert sorted(os.listdir(models)) == ["VQVAE_recurrent_latent4_k5_run0.ckpt", "VQVAE_recurrent_latent4_k5_run0_best.ckpt"]

    emb, counts = embedding_per_video(coords, tab_dict, bundle, meta, global_scaler=scaler, batch_size=64)
    loaded, *_ = coords.deep_unsupervised_embedding(
        None, embedding_model="VQVAE", pretrained="VQVAE_recurrent_latent4_k5_run0.ckpt",
    )
    emb2, counts2 = embedding_per_video(coords, tab_dict, loaded, meta, global_scaler=scaler, batch_size=64)
    assert sorted(emb) == ["test", "test2"]
    for key in emb:
        assert emb[key].shape == (293, 4) and counts[key].shape == (293, 5)
        assert np.isfinite(emb[key]).all()
        np.testing.assert_array_equal(emb2[key], emb[key])
        np.testing.assert_array_equal(counts2[key], counts[key])


def test_graph_dataset_shuffle(trained):
    """shuffle=True permutes each recording's windows with one
    np.random.default_rng(42), recording by recording in the parts' order,
    as the JAX package does."""
    coords, (dataset, *_), *_ = trained
    shuffled = coords.get_graph_dataset(window_size=8, test_videos=1, shuffle=True)[0]
    rng = np.random.default_rng(42)
    for part, s_part in zip(dataset, shuffled):
        assert list(s_part) == list(part)
        for key in part:
            plain = part[key].realize()
            order = rng.permutation(plain[0].shape[0])
            for got, want in zip(s_part[key].realize(), plain):
                np.testing.assert_array_equal(got, want[order])
