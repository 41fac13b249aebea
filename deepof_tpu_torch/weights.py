"""Carry weights from the JAX package's flax parameter trees to the port.

``from_flax_params`` maps a ``variables["params"]`` tree, given as nested
dicts of numpy arrays, onto the state-dict names of the port's modules
(the inverse direction of ``tests/torch_to_flax.py``):

- Conv kernel (k, in, out) -> weight (out, in, k);
- Dense kernel (in, out) -> weight (out, in);
- LayerNorm scale / bias -> weight / bias;
- GRUCell ir/iz/in/hr/hz/hn -> ``wi`` (F, 3H), ``bi`` (3H,), ``wh`` (H, 3H),
  ``bhn`` (H,), the flax form the GRU kernel consumes;
- CensNet leaves, the (D, K) codebook and the GMM prior's (K, D) means and
  log-variances as they are.

Unknown or missing keys raise, so a whole JAX VQ-VAE (encoder, codebook
and decoder) or VaDE (encoder, latent head and decoder) crosses over or
nothing does.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

State = Dict[str, torch.Tensor]


def _keys(tree: dict, where: str, required, optional=()) -> None:
    keys = set(tree)
    missing = set(required) - keys
    unknown = keys - set(required) - set(optional)
    if missing or unknown:
        raise KeyError(
            f"flax params at {where}: missing {sorted(missing)}, unknown {sorted(unknown)}"
        )


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32))


def _nest(prefix: str, state: State) -> State:
    return {f"{prefix}.{k}": v for k, v in state.items()}


def _gru_cell(p: dict, where: str) -> State:
    _keys(p, where, ("ir", "iz", "in", "hr", "hz", "hn"))
    for g in ("ir", "iz", "in", "hn"):
        _keys(p[g], f"{where}/{g}", ("kernel", "bias"))
    for g in ("hr", "hz"):
        _keys(p[g], f"{where}/{g}", ("kernel",))
    return {
        "wi": _t(np.concatenate([p[g]["kernel"] for g in ("ir", "iz", "in")], axis=1)),
        "bi": _t(np.concatenate([p[g]["bias"] for g in ("ir", "iz", "in")])),
        "wh": _t(np.concatenate([p[g]["kernel"] for g in ("hr", "hz", "hn")], axis=1)),
        "bhn": _t(p["hn"]["bias"]),
    }


def _masked_gru(p: dict, where: str) -> State:
    _keys(p, where, ("GRUCell_0",))
    return _gru_cell(p["GRUCell_0"], f"{where}/GRUCell_0")


def _bigru(p: dict, where: str) -> State:
    _keys(p, where, ("MaskedGRU_0", "MaskedGRU_1"))
    return {
        **_nest("fwd", _masked_gru(p["MaskedGRU_0"], f"{where}/MaskedGRU_0")),
        **_nest("bwd", _masked_gru(p["MaskedGRU_1"], f"{where}/MaskedGRU_1")),
    }


def _layer_norm(p: dict, where: str) -> State:
    _keys(p, where, ("scale", "bias"))
    return {"weight": _t(p["scale"]), "bias": _t(p["bias"])}


def _dense(p: dict, where: str) -> State:
    _keys(p, where, ("kernel", "bias"))
    return {"weight": _t(np.asarray(p["kernel"]).T), "bias": _t(p["bias"])}


def _recurrent_block(p: dict, where: str) -> State:
    _keys(p, where, ("Conv_0", "BiGRU_0", "LayerNorm_0", "BiGRU_1", "LayerNorm_1"), ("Dense_0",))
    _keys(p["Conv_0"], f"{where}/Conv_0", ("kernel",))
    state = {
        "conv_weight": _t(np.asarray(p["Conv_0"]["kernel"]).transpose(2, 1, 0)),
        **_nest("gru1", _bigru(p["BiGRU_0"], f"{where}/BiGRU_0")),
        **_nest("norm1", _layer_norm(p["LayerNorm_0"], f"{where}/LayerNorm_0")),
        **_nest("gru2", _bigru(p["BiGRU_1"], f"{where}/BiGRU_1")),
        **_nest("norm2", _layer_norm(p["LayerNorm_1"], f"{where}/LayerNorm_1")),
    }
    if "Dense_0" in p:
        state.update(_nest("proj", _dense(p["Dense_0"], f"{where}/Dense_0")))
    return state


_CENSNET_LEAVES = (
    "node_kernel", "edge_kernel", "node_weights", "edge_weights", "node_bias", "edge_bias",
)


def _censnet(p: dict, where: str) -> State:
    _keys(p, where, _CENSNET_LEAVES)
    return {k: _t(p[k]) for k in _CENSNET_LEAVES}


def _recurrent_encoder(p: dict, where: str) -> State:
    """flax numbers RecurrentBlocks in creation order: with the GNN node,
    edge, then the angle block (after CensNetConv_0) as RecurrentBlock_2;
    without it the flat block, then the angle block as RecurrentBlock_1."""
    if "CensNetConv_0" in p:
        blocks = ("node_block", "edge_block")
        _keys(p, where, ("RecurrentBlock_0", "RecurrentBlock_1", "CensNetConv_0", "Dense_0"),
              ("RecurrentBlock_2",))
        state = _nest("censnet", _censnet(p["CensNetConv_0"], f"{where}/CensNetConv_0"))
    else:
        blocks = ("block",)
        _keys(p, where, ("RecurrentBlock_0", "Dense_0"), ("RecurrentBlock_1",))
        state = {}
    if f"RecurrentBlock_{len(blocks)}" in p:
        blocks += ("angle_block",)
    for i, name in enumerate(blocks):
        state.update(_nest(name, _recurrent_block(p[f"RecurrentBlock_{i}"], f"{where}/RecurrentBlock_{i}")))
    state.update(_nest("dense", _dense(p["Dense_0"], f"{where}/Dense_0")))
    return state


def _recurrent_decoder(p: dict, where: str) -> State:
    _keys(p, where, ("BiGRU_0", "LayerNorm_0", "BiGRU_1", "LayerNorm_1", "Conv_0", "LayerNorm_2",
                     "ProbabilisticHead_0"))
    _keys(p["Conv_0"], f"{where}/Conv_0", ("kernel",))
    _keys(p["ProbabilisticHead_0"], f"{where}/ProbabilisticHead_0", ("Dense_0",))
    return {
        **_nest("gru1", _bigru(p["BiGRU_0"], f"{where}/BiGRU_0")),
        **_nest("norm1", _layer_norm(p["LayerNorm_0"], f"{where}/LayerNorm_0")),
        **_nest("gru2", _bigru(p["BiGRU_1"], f"{where}/BiGRU_1")),
        **_nest("norm2", _layer_norm(p["LayerNorm_1"], f"{where}/LayerNorm_1")),
        "conv_weight": _t(np.asarray(p["Conv_0"]["kernel"]).transpose(2, 1, 0)),
        **_nest("norm3", _layer_norm(p["LayerNorm_2"], f"{where}/LayerNorm_2")),
        **_nest("head.dense", _dense(p["ProbabilisticHead_0"]["Dense_0"], f"{where}/ProbabilisticHead_0/Dense_0")),
    }


def _vector_quantizer(p: dict, where: str) -> State:
    _keys(p, where, ("codebook",))
    return {"codebook": _t(p["codebook"])}


def _vqvae(p: dict, where: str) -> State:
    _keys(p, where, ("encoder", "vq_layer", "decoder"))
    return {
        **_nest("encoder", _recurrent_encoder(p["encoder"], f"{where}/encoder")),
        **_nest("vq_layer", _vector_quantizer(p["vq_layer"], f"{where}/vq_layer")),
        **_nest("decoder", _recurrent_decoder(p["decoder"], f"{where}/decoder")),
    }


def _gaussian_mixture_latent(p: dict, where: str) -> State:
    _keys(p, where, ("gmm_means", "gmm_log_vars", "encoder_mean", "encoder_log_var"))
    return {
        "gmm_means": _t(p["gmm_means"]),
        "gmm_log_vars": _t(p["gmm_log_vars"]),
        **_nest("encoder_mean", _dense(p["encoder_mean"], f"{where}/encoder_mean")),
        **_nest("encoder_log_var", _dense(p["encoder_log_var"], f"{where}/encoder_log_var")),
    }


def _vade(p: dict, where: str) -> State:
    _keys(p, where, ("encoder", "latent_space", "decoder"))
    return {
        **_nest("encoder", _recurrent_encoder(p["encoder"], f"{where}/encoder")),
        **_nest("latent_space", _gaussian_mixture_latent(p["latent_space"], f"{where}/latent_space")),
        **_nest("decoder", _recurrent_decoder(p["decoder"], f"{where}/decoder")),
    }


_CONVERTERS: Dict[str, Callable[[dict, str], State]] = {
    "VQVAE": _vqvae,
    "VaDE": _vade,
    "GaussianMixtureLatent": _gaussian_mixture_latent,
    "RecurrentEncoder": _recurrent_encoder,
    "RecurrentDecoder": _recurrent_decoder,
    "RecurrentBlock": _recurrent_block,
    "CensNetConv": _censnet,
    "VectorQuantizer": _vector_quantizer,
    "BiGRU": _bigru,
    "MaskedGRU": _masked_gru,
}


def from_flax_params(params: dict, kind: str = "VQVAE") -> State:
    """State dict for the port's ``kind`` module from a flax params tree.

    Load it with ``module.load_state_dict(state)`` (strict), which also
    checks every shape.
    """
    if kind not in _CONVERTERS:
        raise ValueError(f"unknown module kind {kind!r}; one of {sorted(_CONVERTERS)}")
    return _CONVERTERS[kind](params, "<root>")
