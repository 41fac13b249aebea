"""The port's TCN and transformer encoders and decoders against the JAX
package's, float32 on the CPU: the blocks (BatchNorm, the TCN, the
positional encoding, both attention layers with an all-padding stream,
dropout), the VQ-VAE and VaDE with each encoder at their defaults in eval
mode, ``from_flax_params`` with batch stats, the eval-mode switch of
evaluation, latent extraction and serving, and the served outputs against
the reference files of the JAX package's. One train step of each model
family: ``test_torch_encoder_steps``; ``deep_unsupervised_embedding`` with
each encoder: ``test_torch_encoder_fits``.

Inputs are numpy draws from fixed seeds fed to both packages; parameters
are drawn at the scale of flax's initialisers and cross over with
``from_flax_params(..., batch_stats=...)``. The blocks' JAX programs run
here, each compiled once, XLA's optimisations off (``run_jax``); the full
models' (5-15 s of compile each, several times that beside tier-1's other
workers) were run once by ``scripts/make_torch_reference.py`` with the
same draws and are read from ``tests/data/encoder_cases.npz``
(``torch_encoder_cases``). JAX programs record the keep masks their
dropout layers draw with ``jax.random.bernoulli`` as outputs, in the order
the layers run, and the port is given them (``DropoutDraws(masks=...)``).
Bars:
- forwards: 1e-5 (1e-4 for reconstructions, which sum over T*N*F terms);
- running statistics after a forward or a step: 1e-6;
- gradients: 1e-5 * max(1, max |g|) per tensor (``test_torch_train``'s),
  a bias that a train-mode BatchNorm absorbs at the scale of its layer's
  weight (``_ABSORBED_BIASES``).
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepof_tpu.models import blocks as jblocks

from deepof_tpu_torch.models import blocks as pblocks
from deepof_tpu_torch.models.blocks import DropoutDraws, use_dropout_draws
from deepof_tpu_torch.models.decoders import MaskedNormal
from deepof_tpu_torch.models.zoo import build_model
from deepof_tpu_torch.train import harness as pharness
from deepof_tpu_torch.train import losses as plosses
from deepof_tpu_torch.train.inference import scanned_windowed_forward
from deepof_tpu_torch.weights import from_flax_params

import torch_encoder_cases
from test_torch_train import ADJ, E, GRAD_RTOL, N, T, _close
from torch_encoder_cases import B, K, LATENT, MODELS

REFERENCES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


# --------------------------------------------------------------------------- #
# Helpers shared with test_torch_contrastive
# --------------------------------------------------------------------------- #


def flax_draws(shapes, seed):
    """Parameters at the scale of flax's initialisers: kernels N(0,
    fan_in^-1/2) (attention q / k / v over their input axis), BatchNorm
    and LayerNorm scales 1 + N(0, 0.1), biases N(0, 0.05), CensNet leaves
    and the latent heads N(0, 0.5)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        names = [str(getattr(p, "key", p)) for p in path]
        shape = leaf.shape
        if names[-1] == "kernel":
            fan_in = shape[0] if names[-2] in ("query", "key", "value") else int(np.prod(shape[:-1]))
            std = fan_in ** -0.5
            return rng.normal(scale=std, size=shape).astype(np.float32)
        if names[-1] == "scale":
            return (1.0 + rng.normal(scale=0.1, size=shape)).astype(np.float32)
        if names[-1] == "bias":
            return rng.normal(scale=0.05, size=shape).astype(np.float32)
        return rng.normal(scale=0.5, size=shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def stats_draws(shapes, seed):
    """BatchNorm running statistics: means N(0, 0.2), variances U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, v: (rng.normal(scale=0.2, size=v.shape) if str(path[-1].key) == "mean"
                         else rng.uniform(0.5, 1.5, size=v.shape)).astype(np.float32), shapes)


def jax_variables(module, seed, *args, **kwargs):
    """(params, batch_stats) of ``module`` drawn from ``seed``."""
    shapes = jax.eval_shape(lambda *a: module.init(jax.random.PRNGKey(0), *a, **kwargs), *args)
    return flax_draws(shapes["params"], seed), stats_draws(shapes.get("batch_stats", {}), seed + 1)


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _recording(fn):
    """``fn`` returning (its outputs, the keep masks its
    ``jax.random.bernoulli`` calls, flax's dropout, drew in call order)."""

    def traced(*a):
        masks, orig = [], jax.random.bernoulli

        def record(key, p=0.5, shape=None, **kw):
            mask = orig(key, p, shape, **kw)
            masks.append(mask)
            return mask

        jax.random.bernoulli = record
        try:
            return fn(*a), masks
        finally:
            jax.random.bernoulli = orig

    return traced


def run_jax(fn, *args):
    """``fn(*args)`` under one ``jax.jit`` compile: (outputs, [mask, ...]),
    the keep masks of its dropout layers in the order they ran."""
    out, masks = jax.jit(_recording(fn))(*args)
    return out, [np.asarray(m) for m in masks]


def run_jax_all(calls):
    """``{name: (fn, args)}`` -> ``{name: (outputs, masks)}`` as ``run_jax``
    gives them: every program traced in turn, then all compiled at once in
    threads (XLA compiles without the interpreter lock), then run."""
    lowered = {name: jax.jit(_recording(fn)).lower(*args) for name, (fn, args) in calls.items()}
    with ThreadPoolExecutor(len(lowered)) as pool:
        compiled = dict(zip(lowered, pool.map(lambda low: low.compile(), lowered.values())))
    out = {}
    for name, (_, args) in calls.items():
        res, masks = compiled[name](*args)
        out[name] = (res, [np.asarray(m) for m in masks])
    return out


@pytest.fixture(scope="module", autouse=True)
def fast_jax_compiles():
    """XLA compiles these modules' programs with most optimisations off: the
    same operations, compiled in about half the time."""
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's small CPU tensors on one thread: intra-op threads buy
    little at these sizes, and beside tier-1's other test workers they spin
    (the fits of test_torch_encoder_fits took 785 s there on eight threads)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



def running_stats_close(module, want_stats, kind, params, tol=1e-6):
    """The port's BatchNorm buffers against a flax batch-stats tree."""
    want = from_flax_params(params, kind=kind, batch_stats=to_numpy(want_stats))
    got = module.state_dict()
    names = [k for k in want if "running" in k]
    assert names
    for name in names:
        _close(got[name], want[name], tol)


# Biases whose output goes straight into a train-mode BatchNorm: the batch
# mean absorbs them, so their exact gradient is 0 and both packages compute
# rounding noise of the gradients around them. Each is held at GRAD_RTOL of
# max(1, max |g|) of its layer's weight, the scale of that noise.
_ABSORBED_BIASES = ("conv1.bias", "conv2.bias", "decoder.dense0.bias")


def param_grads_close(module, jax_grads, kind, batch_stats, rtol=GRAD_RTOL):
    """Every parameter gradient of ``module`` against the JAX gradient tree,
    carried over like weights (``batch_stats`` only fill the buffers'
    names), at ``rtol`` of max(1, max |g|)."""
    want = from_flax_params(to_numpy(jax_grads), kind=kind, batch_stats=to_numpy(batch_stats))
    names = dict(module.named_parameters())
    assert set(names) <= set(want)
    for name, p in names.items():
        assert p.grad is not None, name
        ref = want[name.replace(".bias", ".weight")] if name.endswith(_ABSORBED_BIASES) else want[name]
        bar = rtol * max(1.0, float(ref.abs().max()))
        err = float((p.grad - want[name]).abs().max())
        assert err <= bar, f"{name}: max |diff| {err:.3e} > {bar:.3e}"


def carried(model, encoder, params, stats, **kw):
    pm = build_model(model, (T, N, 3), (T, E, 1), ADJ, LATENT, K, encoder_type=encoder, device="cpu", **kw)
    pm.load_state_dict(from_flax_params(to_numpy(params), kind=model, batch_stats=to_numpy(stats)))
    return pm


# --------------------------------------------------------------------------- #
# (a) Blocks
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("axis", [-1, 1])
def test_batch_norm_matches_flax(axis):
    """Train mode (batch statistics, flax's fast variance, the running
    update at momentum 0.99) and eval mode (running statistics) on (B, T,
    C) and (B, C, T) layouts."""
    import flax.linen as fnn

    rng = np.random.default_rng(0)
    x = (rng.normal(size=(6, 5, 7)) * 2 + 1).astype(np.float32)
    xj = x if axis == -1 else x.transpose(0, 2, 1)
    bn = fnn.BatchNorm(momentum=0.99, epsilon=1e-3)
    params, stats = jax_variables(bn, 1, jnp.asarray(xj), use_running_average=False)
    variables = {"params": params, "batch_stats": stats}
    pm = pblocks.BatchNorm(x.shape[axis])
    pm.load_state_dict({"weight": torch.as_tensor(params["scale"]), "bias": torch.as_tensor(params["bias"]),
                        "running_mean": torch.as_tensor(stats["mean"]), "running_var": torch.as_tensor(stats["var"])})
    want_eval = bn.apply(variables, jnp.asarray(xj), use_running_average=True)
    want_train, moved = bn.apply(variables, jnp.asarray(xj), use_running_average=False, mutable=["batch_stats"])
    got_eval = pm.eval()(torch.as_tensor(x), axis=axis)
    got_train = pm.train()(torch.as_tensor(x), axis=axis)
    back = (lambda v: v) if axis == -1 else (lambda v: np.asarray(v).transpose(0, 2, 1))
    _close(got_eval, back(want_eval))
    _close(got_train, back(want_train))
    _close(pm.running_mean, moved["batch_stats"]["mean"], 1e-6)
    _close(pm.running_var, moved["batch_stats"]["var"], 1e-6)


@pytest.fixture(scope="module")
def narrow_tcn():
    """A narrow JAX TCN (8 filters, dilations (1, 2), two stacks) with its
    draws and outputs in eval and train mode, both with the last step and
    every step."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, T, 3)).astype(np.float32)
    out = {}
    for seq in (False, True):
        jm = jblocks.TCN(conv_filters=8, conv_dilations=(1, 2), return_sequences=seq)
        params, stats = jax_variables(jm, 3, jnp.asarray(x))
        (want_eval, want_train), _ = run_jax(
            lambda v, xx: (jm.apply(v, xx), jm.apply(v, xx, train=True, mutable=["batch_stats"])),
            {"params": params, "batch_stats": stats}, jnp.asarray(x))
        out[seq] = (params, stats, want_eval, want_train)
    return x, out


@pytest.mark.parametrize("return_sequences", [False, True], ids=["last", "sequence"])
def test_tcn_matches_jax(narrow_tcn, return_sequences):
    """The causal pad, the 1x1 downsample of the first block only, summed
    skips, BatchNorm in both modes and the running statistics after."""
    x, out = narrow_tcn
    params, stats, want_eval, (want_train, moved) = out[return_sequences]
    assert set(params["TemporalBlock_0"]) == {"conv1", "bn1", "conv2", "bn2", "downsample"}
    assert "downsample" not in params["TemporalBlock_1"]
    pm = pblocks.TCN(3, 8, conv_dilations=(1, 2), return_sequences=return_sequences)
    pm.load_state_dict(from_flax_params(to_numpy(params), kind="TCN", batch_stats=to_numpy(stats)))
    _close(pm.eval()(torch.as_tensor(x)), want_eval)
    with torch.no_grad():
        _close(pm.train()(torch.as_tensor(x)), want_train)
    running_stats_close(pm, moved["batch_stats"], "TCN", params)


@pytest.mark.parametrize("d_model", [12, 13])
def test_positional_encoding_matches_jax(d_model):
    want = jblocks.sinusoidal_positional_encoding(50, d_model)
    got = pblocks.sinusoidal_positional_encoding(50, d_model)
    assert got.shape == want.shape == (1, 50, d_model)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("layer", ["encoder", "causal"])
def test_attention_layers_match_jax(layer):
    """TransformerEncoderLayer (key-padding mask; stream 0 all padding, so
    every logit is float32's min and its attention uniform, not NaN) and
    CausalSelfAttentionLayer, eval and train mode, the train mode with
    flax's keep masks: the attention weights' one (T, T) mask shared by the
    batch and the heads, then the elementwise ones."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(5, T, 12)).astype(np.float32)
    if layer == "encoder":
        valid = np.ones((5, T), bool)
        valid[0] = False
        valid[1, -3:] = False
        jm = jblocks.TransformerEncoderLayer(key_dim=12, num_heads=4, dff=16, rate=0.3)
        args = (jnp.asarray(x), jnp.asarray(~valid))
        pm = pblocks.TransformerEncoderLayer(12, 4, 16, 0.3)
        kind, p_args = "TransformerEncoderLayer", (torch.as_tensor(x), torch.as_tensor(valid))
    else:
        jm = jblocks.CausalSelfAttentionLayer(d_model=12, num_heads=4, dff=16, rate=0.3)
        args = (jnp.asarray(x),)
        pm = pblocks.CausalSelfAttentionLayer(12, 4, 16, 0.3)
        kind, p_args = "CausalSelfAttentionLayer", (torch.as_tensor(x),)
    params, _ = jax_variables(jm, 5, *args)
    (want_eval, want_train), masks = run_jax(
        lambda p, *a: (jm.apply({"params": p}, *a),
                       jm.apply({"params": p}, *a, train=True, rngs={"dropout": jax.random.PRNGKey(6)})),
        params, *args)
    n_drop = 3 if layer == "encoder" else 4
    assert len(masks) == n_drop and masks[0].shape == (1, 1, T, T)
    pm.load_state_dict(from_flax_params(to_numpy(params), kind=kind))
    with torch.no_grad():
        got_eval = pm.eval()(*p_args)
        use_dropout_draws(pm, DropoutDraws(masks=masks))
        got_train = pm.train()(*p_args)
    assert torch.isfinite(got_eval).all() and torch.isfinite(got_train).all()
    _close(got_eval, want_eval)
    _close(got_train, want_train)


def test_attention_of_an_all_padding_stream_is_uniform():
    """With every key masked, each query's weights are 1 / T: the output is
    the mean of the values at every step."""
    attn = pblocks.MultiHeadAttention(6, 2, generator=torch.Generator().manual_seed(0))
    x = torch.randn(3, 5, 6, generator=torch.Generator().manual_seed(1))
    valid = torch.zeros(3, 5, dtype=torch.bool)
    with torch.no_grad():
        got = attn.eval()(x, valid[:, None, None, :])
        v = (x @ attn.value.flatten(1)).mean(dim=1, keepdim=True)
        want = (v @ attn.out.flatten(0, 1)).expand(-1, 5, -1)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_dropout_keep_rate_scaling_and_eval():
    """Dropout keeps ~1 - rate of the entries, scales them by 1 / (1 -
    rate), zeroes the rest, and is the identity in eval mode; masks given
    are served in order and checked; a train-mode forward without draws,
    or with too few masks, raises."""
    drop = pblocks.Dropout(0.3)
    x = torch.ones(400_000)
    use_dropout_draws(drop, DropoutDraws(torch.Generator().manual_seed(0)))
    y = drop.train()(x)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.005
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / 0.7))
    assert drop.eval()(x) is x
    draws = DropoutDraws(masks=[np.array([True, False, True])], record=True)
    use_dropout_draws(drop, draws)
    torch.testing.assert_close(drop.train()(torch.ones(3)), torch.tensor([1 / 0.7, 0.0, 1 / 0.7]))
    assert [m.tolist() for m in draws.recorded] == [[True, False, True]]
    with pytest.raises(ValueError, match="more dropout layers"):
        drop(torch.ones(3))
    use_dropout_draws(drop, DropoutDraws(masks=[np.ones(4, bool)]))
    with pytest.raises(ValueError, match="shape"):
        drop(torch.ones(3))
    use_dropout_draws(drop, None)
    with pytest.raises(RuntimeError, match="DropoutDraws"):
        drop(torch.ones(3))
    assert pblocks.set_dropout_rate(drop, 0.0) is drop and torch.equal(drop(x), x)


# --------------------------------------------------------------------------- #
# (b) The models at their defaults
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def jax_cases():
    """The JAX package's outputs for the models' tests, from
    ``tests/data/encoder_cases.npz`` (``torch_encoder_cases``)."""
    return torch_encoder_cases.load()


@pytest.fixture(scope="module")
def jax_models(jax_cases):
    """(model, encoder) -> (params, stats, x, a, the JAX package's eval
    forward)."""
    out = {}
    for model, encoder in MODELS:
        case = jax_cases[f"eval-{model}-{encoder}"]
        x, a, _ = torch_encoder_cases.model_inputs(model, encoder)
        out[model, encoder] = (case["params"], case["stats"], x, a, case["out"])
    return out


def _outputs_close(got, want, model):
    keys = (("encoder_output", "quantized", "soft_counts") if model == "VQVAE"
            else ("encoder_output", "latent", "categorical", "z_mean", "z_log_var"))
    recons = (("quantized_reconstruction", "encoding_reconstruction") if model == "VQVAE"
              else ("reconstruction",))
    for k in keys:
        _close(got[k], want[k])
    for k in recons:
        _close(got[k].loc, want[k]["loc"], 1e-4)
        np.testing.assert_array_equal(got[k].mask.numpy(), want[k]["mask"])
    if model == "VQVAE":
        _close(got["vq_losses"]["vq_loss"], want["vq_loss"])


@pytest.mark.parametrize("model,encoder", MODELS)
def test_models_match_jax_in_eval_mode(jax_models, model, encoder):
    """The training forward in eval mode (the JAX package's ``train=False``),
    and the serving forward, encode, embed and group, which run in eval
    mode from a model in train mode and move no buffer. Train mode, with
    the JAX package's dropout masks: ``test_torch_encoder_steps``."""
    params, stats, x, a, want_eval = jax_models[model, encoder]
    pm = carried(model, encoder, params, stats)
    xt, at = torch.as_tensor(x), torch.as_tensor(a)
    with torch.no_grad():
        _outputs_close(pm.training_forward(xt, at, train=False), want_eval, model)
        assert pm.training  # the mode is restored
        before = {k: v.clone() for k, v in pm.state_dict().items()}
        _close(pm.encode(xt, at), want_eval["encoder_output"])
        if model == "VaDE":
            _close(pm.embed(xt, at), want_eval["z_mean"])
            _close(pm.group(xt, at), want_eval["categorical"])
        else:
            _close(pm.group(xt, at), want_eval["soft_counts"])
        assert pm.training and all(torch.equal(before[k], v) for k, v in pm.state_dict().items())


def test_from_flax_params_with_batch_stats_and_what_raises(jax_models):
    """Every BatchNorm of a TCN VQ-VAE reads its stats; a missing stats key,
    an unknown one, or no stats at all raise; a recurrent model needs
    none, and a recurrent bundle's state dict (no BatchNorm buffers, as
    bundles were saved before BatchNorm came) still loads."""
    params, stats, *_ = jax_models["VQVAE", "TCN"]
    state = from_flax_params(to_numpy(params), kind="VQVAE", batch_stats=to_numpy(stats))
    # Encoder: two TCNs of 8 blocks with 2 BatchNorms each, the head's 2;
    # decoder: the 3 after its Dense layers, its TCN's 4 blocks with 2 each.
    assert sum(k.endswith("running_mean") for k in state) == 2 * 8 * 2 + 2 + 3 + 4 * 2
    missing = to_numpy(stats)
    del missing["decoder"]["BatchNorm_1"]["var"]
    with pytest.raises(KeyError, match="missing"):
        from_flax_params(to_numpy(params), kind="VQVAE", batch_stats=missing)
    extra = to_numpy(stats)
    extra["encoder"]["BatchNorm_7"] = {"mean": np.zeros(3)}
    with pytest.raises(KeyError, match="unknown"):
        from_flax_params(to_numpy(params), kind="VQVAE", batch_stats=extra)
    with pytest.raises(KeyError, match="batch_stats"):
        from_flax_params(to_numpy(params), kind="VQVAE")
    recurrent = build_model("VQVAE", (T, N, 3), (T, E, 1), ADJ, LATENT, K, device="cpu")
    assert not any("running" in k for k in recurrent.state_dict())
    again = build_model("VQVAE", (T, N, 3), (T, E, 1), ADJ, LATENT, K, device="cpu",
                        generator=torch.Generator().manual_seed(3))
    again.load_state_dict(recurrent.state_dict())


# --------------------------------------------------------------------------- #
# (c) Evaluation, latents and serving in eval mode
# --------------------------------------------------------------------------- #


def test_evaluation_and_serving_leave_running_statistics(jax_models):
    """make_vqvae_eval_step / make_vade_eval_step, extract_latents and
    scanned_windowed_forward run in eval mode: the BatchNorm buffers do not
    move, the model keeps its mode, and the eval losses are those of the
    eval-mode forward; a train step moves them."""
    for model, encoder in (("VQVAE", "TCN"), ("VaDE", "transformer")):
        params, stats, x, a, want_eval = jax_models[model, encoder]
        pm = carried(model, encoder, params, stats)
        use_dropout_draws(pm, DropoutDraws(torch.Generator().manual_seed(0)))
        xt, at = torch.as_tensor(x), torch.as_tensor(a)
        before = {k: v.clone() for k, v in pm.state_dict().items()}
        if model == "VQVAE":
            logs = pharness.make_vqvae_eval_step(pm)(xt, at)
            recon = want_eval["quantized_reconstruction"]
            want = -MaskedNormal(torch.as_tensor(recon["loc"]), torch.as_tensor(recon["mask"])).log_prob(
                xt.reshape(B, T, -1)).mean()
            _close(logs["reconstruct_loss"], want, 1e-4)
        else:
            loss_params = plosses.VadeLossParams(n_components=K)
            pharness.make_vade_eval_step(pm, loss_params, torch.Generator().manual_seed(0))(xt, at, kl_weight=0.5)
        if model == "VaDE":
            ds = pharness.WindowDataset({"r": (x, a, np.zeros((B, T, 0, 1), np.float32))})
            _close(pharness.extract_latents(pm, ds, 3), want_eval["z_mean"])
        assert pm.training
        assert all(torch.equal(before[k], v) for k, v in pm.state_dict().items())
        if model == "VQVAE":
            step = pharness.make_vqvae_step(pm, pharness._make_optimizer(pm.named_parameters(), 0.0))
        else:
            step = pharness.make_vade_step(pm, pharness._make_optimizer(pm.named_parameters(), 0.0),
                                           plosses.VadeLossParams(n_components=K), torch.Generator().manual_seed(1))
        step(xt, at)
        assert not torch.equal(before["encoder.mlp.bn1.running_mean"], pm.encoder.mlp.bn1.running_mean)


def _reference(name):
    """(ModelBundle on the CPU, file arrays, frame, layout) of an encoder
    reference written by scripts/make_torch_reference.py."""
    import chip_smoke

    return chip_smoke.encoder_reference_bundle(os.path.join(REFERENCES, name), "cpu")


@pytest.mark.parametrize("name", ["tcn_reference.npz", "transformer_reference.npz"])
def test_served_outputs_match_the_jax_reference_files(name):
    """The port's serving path (the window kernel's plain version, the
    encoder's streams, eval mode) on the reference frame against the JAX
    package's scanned_windowed_forward, stored with the float16-exact
    parameters and batch stats (no JAX call here)."""
    bundle, ref, frame, layout = _reference(name)
    window = int(ref["window"])
    emb, counts = scanned_windowed_forward(bundle, frame, layout, window, str(ref["model"]), block=128,
                                           device="cpu")
    assert emb.shape == ref["embeddings"].shape and counts.shape == ref["soft_counts"].shape
    _close(emb, ref["embeddings"])
    _close(counts, ref["soft_counts"])
    assert not bundle.model.training
