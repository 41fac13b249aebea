"""The port's serving-path modules against the JAX package's flax modules on
weights carried over by ``from_flax_params``, float32 on the CPU.

Each flax module's parameter tree takes its shapes from ``jax.eval_shape``
of the module's init and its values from seeded numpy noise (so biases,
LayerNorm scales and the codebook are all exercised); the tree is carried
over, and both forwards see the same numpy inputs. Bar: max |diff| <= 1e-5
(the JAX package's transplant bar against upstream deepof).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as fnn

from deepof_tpu.models import blocks as jblocks
from deepof_tpu.models import encoders as jenc
from deepof_tpu.models import gnn as jgnn
from deepof_tpu.models import heads as jheads
from deepof_tpu.models import zoo as jzoo

from deepof_tpu_torch.models import blocks as pblocks
from deepof_tpu_torch.models import encoders as penc
from deepof_tpu_torch.models import gnn as pgnn
from deepof_tpu_torch.models import heads as pheads
from deepof_tpu_torch.models import zoo as pzoo
from deepof_tpu_torch.weights import from_flax_params

TOL = 1e-5
ADJ = np.zeros((5, 5), np.float32)
for _i, _j in [(0, 1), (1, 2), (2, 3), (1, 4)]:
    ADJ[_i, _j] = ADJ[_j, _i] = 1.0
N, E = 5, 4


def _init(module, seed, *args, **kwargs):
    shapes = jax.eval_shape(
        lambda *a: module.init(jax.random.PRNGKey(0), *a, **kwargs), *args
    )["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda v: rng.normal(scale=0.3, size=v.shape).astype(np.float32), shapes
    )


def _load(module, params, kind):
    module.load_state_dict(from_flax_params(params, kind=kind))
    return module.eval()


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=TOL)


def _inputs(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    # Zero-padded tails and one all-zero stream: prefix lengths short of T,
    # and a length of 0.
    x[0] = 0.0
    x[1, -3:] = 0.0
    return x


@pytest.mark.parametrize("latent", [4, 70])  # 70: d = 64 != latent, Dense branch
def test_recurrent_block(latent):
    rng = np.random.default_rng(latent)
    x = _inputs(rng, (5, 8, 3))
    jm = jblocks.RecurrentBlock(latent)
    params = _init(jm, latent, jnp.asarray(x))
    assert ("Dense_0" in params) == (latent == 70)
    pm = _load(pblocks.RecurrentBlock(3, latent), params, "RecurrentBlock")
    with torch.no_grad():
        got = pm(torch.as_tensor(x))
    _close(got, jm.apply({"params": params}, jnp.asarray(x)))


def test_bigru_and_validity_mask():
    rng = np.random.default_rng(1)
    x = _inputs(rng, (4, 6, 3))
    mask = np.array(jblocks.frame_validity_mask(jnp.asarray(x)))
    np.testing.assert_array_equal(pblocks.frame_validity_mask(torch.as_tensor(x)).numpy(), mask)
    jm = jblocks.BiGRU(5)
    params = _init(jm, 1, jnp.asarray(x), jnp.asarray(mask))
    pm = _load(pblocks.BiGRU(3, 5), params, "BiGRU")
    with torch.no_grad():
        out, fin = pm(torch.as_tensor(x), torch.as_tensor(mask))
    want_out, want_fin = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask))
    _close(out, want_out)
    _close(fin, want_fin)


def test_bigru_with_norm_final_only():
    # The RecurrentBlock's LayerNorm_0 + BiGRU_1 pair, as the port runs it:
    # one call with the norm folded in and no per-step outputs.
    rng = np.random.default_rng(6)
    x = _inputs(rng, (5, 7, 6))
    mask = np.array(jblocks.frame_validity_mask(jnp.asarray(x)))
    ln = fnn.LayerNorm(epsilon=1e-3)
    ln_params = _init(ln, 7, jnp.asarray(x))
    jm = jblocks.BiGRU(4)
    params = _init(jm, 6, jnp.asarray(x), jnp.asarray(mask))
    pm = _load(pblocks.BiGRU(6, 4), params, "BiGRU")
    norm = (torch.as_tensor(np.asarray(ln_params["scale"])), torch.as_tensor(np.asarray(ln_params["bias"])), 1e-3)
    with torch.no_grad():
        out, fin = pm(torch.as_tensor(x), torch.as_tensor(mask), norm=norm, outputs=False)
    y = ln.apply({"params": ln_params}, jnp.asarray(x))
    _, want_fin = jm.apply({"params": params}, y, jnp.asarray(mask))
    assert out is None
    _close(fin, want_fin)


def test_censnet_conv():
    rng = np.random.default_rng(2)
    nodes = rng.normal(size=(3, N, 6)).astype(np.float32)
    edges = rng.normal(size=(3, E, 6)).astype(np.float32)
    ops = jgnn.censnet_operators(ADJ)
    for got_op, want_op in zip(pgnn.censnet_operators(ADJ), ops):
        np.testing.assert_array_equal(got_op, want_op)
    jm = jgnn.CensNetConv(node_channels=4, edge_channels=4, operators=ops)
    params = _init(jm, 2, jnp.asarray(nodes), jnp.asarray(edges))
    pm = _load(pgnn.CensNetConv(6, 6, 4, 4, ADJ), params, "CensNetConv")
    with torch.no_grad():
        got = pm(torch.as_tensor(nodes), torch.as_tensor(edges))
    want = jm.apply({"params": params}, jnp.asarray(nodes), jnp.asarray(edges))
    _close(got[0], want[0])
    _close(got[1], want[1])


# The encoder with the GNN is held to JAX through VQVAE.encode below.
@pytest.mark.parametrize("use_gnn", [False])
def test_recurrent_encoder(use_gnn):
    rng = np.random.default_rng(3)
    x = _inputs(rng, (4, 8, N, 3))
    a = _inputs(rng, (4, 8, E, 1))
    jm = jenc.RecurrentEncoder(latent_dim=4, adjacency=ADJ, use_gnn=use_gnn)
    params = _init(jm, 3, jnp.asarray(x), jnp.asarray(a))
    pm = _load(penc.RecurrentEncoder((8, N, 3), (8, E, 1), 4, ADJ, use_gnn), params, "RecurrentEncoder")
    with torch.no_grad():
        got = pm(torch.as_tensor(x), torch.as_tensor(a))
    _close(got, jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(a)))


@pytest.mark.parametrize("use_gnn", [True, False])
def test_forward_equals_forward_streams(use_gnn):
    # The public (B, T, N, 3) / (B, T, E, 1) forward is the stream forward
    # on the reshaped streams, bit for bit, for the encoder and the VQ-VAE.
    rng = np.random.default_rng(8)
    b, t = 4, 8
    x = torch.as_tensor(_inputs(rng, (b, t, N, 3)))
    a = torch.as_tensor(_inputs(rng, (b, t, E, 1)))
    model = pzoo.build_model("VQVAE", (t, N, 3), (t, E, 1), ADJ, latent_dim=4, n_components=5,
                             use_gnn=use_gnn, generator=torch.Generator().manual_seed(8), device="cpu")
    if use_gnn:
        xg = x.transpose(1, 2).reshape(b * N, t, 3).contiguous()
        ag = a.transpose(1, 2).reshape(b * E, t, 1).contiguous()
    else:
        xg, ag = x.reshape(b, t, N * 3), None
    with torch.no_grad():
        assert torch.equal(model.encoder(x, a), model.encoder.forward_streams(xg, ag))
        out, out_streams = model(x, a), model.forward_streams(xg, ag)
    assert out.keys() == out_streams.keys()
    for key in out:
        assert torch.equal(out[key], out_streams[key]), key


def test_vector_quantizer():
    rng = np.random.default_rng(4)
    z = rng.normal(size=(9, 4)).astype(np.float32)
    jm = jheads.VectorQuantizer(n_components=6, embedding_dim=4)
    params = _init(jm, 4, jnp.asarray(z))
    pm = _load(pheads.VectorQuantizer(6, 4), params, "VectorQuantizer")
    with torch.no_grad():
        q, sc = pm(torch.as_tensor(z))
    wq, wsc, _ = jm.apply({"params": params}, jnp.asarray(z), return_losses=False)
    _close(q, wq)
    _close(sc, wsc)


def test_vqvae_encode_group_and_weight_keys():
    rng = np.random.default_rng(5)
    x = _inputs(rng, (4, 8, N, 3))
    a = _inputs(rng, (4, 8, E, 1))
    jm = jzoo.build_model("VQVAE", (8, N, 3), (8, E, 1), ADJ, latent_dim=4, n_components=5)
    params = _init(jm, 5, jnp.asarray(x), jnp.asarray(a))  # encoder, codebook and decoder
    assert set(params) == {"encoder", "vq_layer", "decoder"}
    pm = pzoo.build_model("VQVAE", (8, N, 3), (8, E, 1), ADJ, latent_dim=4, n_components=5, device="cpu")
    _load(pm, params, "VQVAE")
    xt, at = torch.as_tensor(x), torch.as_tensor(a)
    with torch.no_grad():
        enc, group, out = pm.encode(xt, at), pm.group(xt, at), pm(xt, at)
    want_enc = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(a), method=jm.encode)
    want_group = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(a), method=jm.group)
    _close(enc, want_enc)
    _close(group, want_group)
    _close(out["encoder_output"], want_enc)
    _close(out["soft_counts"], want_group)

    with pytest.raises(KeyError, match="unknown"):
        from_flax_params({**params, "extra": {}}, kind="VQVAE")
    enc_params = dict(params["encoder"])
    del enc_params["Dense_0"]
    with pytest.raises(KeyError, match="missing"):
        from_flax_params({"encoder": enc_params, "vq_layer": params["vq_layer"],
                          "decoder": params["decoder"]}, kind="VQVAE")
    with pytest.raises(KeyError, match="missing"):  # the decoder is converted, not skipped
        from_flax_params({"encoder": params["encoder"], "vq_layer": params["vq_layer"]}, kind="VQVAE")
    contrastive = pzoo.build_model("Contrastive", (8, N, 3), (8, E, 1), ADJ, latent_dim=4, device="cpu")
    assert isinstance(contrastive, pzoo.Contrastive) and contrastive.window_size == 4
    with pytest.raises(ValueError, match="Unknown model"):
        pzoo.build_model("GMVAE", (8, N, 3), (8, E, 1), ADJ, latent_dim=4, device="cpu")


def test_rms_stabilize_and_group_reshape():
    rng = np.random.default_rng(6)
    x = (rng.normal(size=(5, 7)) * 30).astype(np.float32)
    x[0, 0] = np.nan
    _close(pblocks.rms_stabilize(torch.as_tensor(x)), jblocks.rms_stabilize(jnp.asarray(x)))
    y = rng.normal(size=(2, 3, 4, 5)).astype(np.float32)
    _close(pblocks.tf_style_group_reshape(torch.as_tensor(y)), jblocks.tf_style_group_reshape(jnp.asarray(y)))


def test_lecun_normal_is_flax_truncated_normal():
    """1M draws at fan_in 80: none beyond flax's truncation bound
    2 fan_in^-0.5 / 0.87962566, and mean and standard deviation within 1% of
    those of ``jax.nn.initializers.lecun_normal()``'s draws."""
    fan_in, n = 80, 1_000_000
    got = pblocks.lecun_normal((n // fan_in, fan_in), fan_in, torch.Generator().manual_seed(0)).double().numpy()
    want = np.asarray(jax.nn.initializers.lecun_normal()(jax.random.PRNGKey(0), (fan_in, n // fan_in), jnp.float32),
                      np.float64)
    bound = 2.0 * fan_in ** -0.5 / 0.87962566
    assert np.abs(got).max() <= bound * (1 + 1e-6)
    assert np.abs(want).max() <= bound * (1 + 1e-6)
    scale = fan_in ** -0.5
    assert abs(got.mean() - want.mean()) <= 0.01 * scale
    assert abs(got.std() / want.std() - 1.0) <= 0.01
