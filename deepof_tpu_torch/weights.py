"""Carry weights from the JAX package's flax variable trees to the port.

``from_flax_params`` maps a ``variables["params"]`` tree and, for modules
with BatchNorm, its ``variables["batch_stats"]`` tree, both given as
nested dicts of numpy arrays, onto the state-dict names of the port's
modules (the inverse direction of ``tests/torch_to_flax.py``):

- Conv kernel (k, in, out) -> weight (out, in, k);
- Dense kernel (in, out) -> weight (out, in);
- LayerNorm scale / bias -> weight / bias;
- BatchNorm scale / bias -> weight / bias, and its batch stats mean / var
  -> running_mean / running_var;
- GRUCell ir/iz/in/hr/hz/hn -> ``wi`` (F, 3H), ``bi`` (3H,), ``wh`` (H, 3H),
  ``bhn`` (H,), the flax form the GRU kernel consumes;
- attention kernels query / key / value (in, heads, head_dim) and out
  (heads, head_dim, out), CensNet leaves, the (D, K) codebook and the GMM
  prior's (K, D) means and log-variances as they are.

flax numbers a module's children of one kind in creation order, across the
stream cores: the transformer encoder's ``Dense_0`` and layers 0..L-1 are
the node core's, ``Dense_1`` and layers L..2L-1 the edge core's, then the
angle core's, then the head's Dense and BatchNorm.

Unknown or missing keys raise, in the params and in the batch stats, so a
whole model (encoder, latent head and decoder) crosses over or nothing
does.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Optional

import numpy as np
import torch

State = Dict[str, torch.Tensor]


def _keys(tree: dict, where: str, required, optional=(), collection: str = "params") -> None:
    keys = set(tree)
    missing = set(required) - keys
    unknown = keys - set(required) - set(optional)
    if missing or unknown:
        raise KeyError(
            f"flax {collection} at {where}: missing {sorted(missing)}, unknown {sorted(unknown)}"
        )


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32))


def _nest(prefix: str, state: State) -> State:
    return {f"{prefix}.{k}": v for k, v in state.items()}


def _stats(s: dict, name: str) -> dict:
    """The batch-stats subtree of child ``name`` (the BatchNorms take their
    leaves out of it, so that what is left over at the end is what no
    converter read)."""
    return s.setdefault(name, {})


def _gru_cell(p: dict, s: dict, where: str) -> State:
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


def _masked_gru(p: dict, s: dict, where: str) -> State:
    _keys(p, where, ("GRUCell_0",))
    return _gru_cell(p["GRUCell_0"], s, f"{where}/GRUCell_0")


def _bigru(p: dict, s: dict, where: str) -> State:
    _keys(p, where, ("MaskedGRU_0", "MaskedGRU_1"))
    return {
        **_nest("fwd", _masked_gru(p["MaskedGRU_0"], s, f"{where}/MaskedGRU_0")),
        **_nest("bwd", _masked_gru(p["MaskedGRU_1"], s, f"{where}/MaskedGRU_1")),
    }


def _layer_norm(p: dict, where: str) -> State:
    _keys(p, where, ("scale", "bias"))
    return {"weight": _t(p["scale"]), "bias": _t(p["bias"])}


def _dense(p: dict, where: str) -> State:
    _keys(p, where, ("kernel", "bias"))
    return {"weight": _t(np.asarray(p["kernel"]).T), "bias": _t(p["bias"])}


def _conv(p: dict, where: str, bias: bool = True) -> State:
    _keys(p, where, ("kernel", "bias") if bias else ("kernel",))
    state = {"weight": _t(np.asarray(p["kernel"]).transpose(2, 1, 0))}
    if bias:
        state["bias"] = _t(p["bias"])
    return state


def _batch_norm(p: dict, stats: dict, where: str) -> State:
    _keys(p, where, ("scale", "bias"))
    _keys(stats, where, ("mean", "var"), collection="batch_stats")
    return {"weight": _t(p["scale"]), "bias": _t(p["bias"]),
            "running_mean": _t(stats.pop("mean")), "running_var": _t(stats.pop("var"))}


def _recurrent_block(p: dict, s: dict, where: str) -> State:
    _keys(p, where, ("Conv_0", "BiGRU_0", "LayerNorm_0", "BiGRU_1", "LayerNorm_1"), ("Dense_0",))
    state = {
        "conv_weight": _conv(p["Conv_0"], f"{where}/Conv_0", bias=False)["weight"],
        **_nest("gru1", _bigru(p["BiGRU_0"], s, f"{where}/BiGRU_0")),
        **_nest("norm1", _layer_norm(p["LayerNorm_0"], f"{where}/LayerNorm_0")),
        **_nest("gru2", _bigru(p["BiGRU_1"], s, f"{where}/BiGRU_1")),
        **_nest("norm2", _layer_norm(p["LayerNorm_1"], f"{where}/LayerNorm_1")),
    }
    if "Dense_0" in p:
        state.update(_nest("proj", _dense(p["Dense_0"], f"{where}/Dense_0")))
    return state


_CENSNET_LEAVES = (
    "node_kernel", "edge_kernel", "node_weights", "edge_weights", "node_bias", "edge_bias",
)


def _censnet(p: dict, s: dict, where: str) -> State:
    _keys(p, where, _CENSNET_LEAVES)
    return {k: _t(p[k]) for k in _CENSNET_LEAVES}


def _temporal_block(p: dict, s: dict, where: str) -> State:
    _keys(p, where, ("conv1", "bn1", "conv2", "bn2"), ("downsample",))
    state = {}
    for name in ("conv1", "bn1", "conv2", "bn2", "downsample"):
        if name.startswith("bn"):
            state.update(_nest(name, _batch_norm(p[name], _stats(s, name), f"{where}/{name}")))
        elif name in p:
            state.update(_nest(name, _conv(p[name], f"{where}/{name}")))
    return state


def _tcn(p: dict, s: dict, where: str) -> State:
    n = len(p)
    _keys(p, where, [f"TemporalBlock_{i}" for i in range(n)])
    state = {}
    for i in range(n):
        name = f"TemporalBlock_{i}"
        state.update(_nest(f"blocks.{i}", _temporal_block(p[name], _stats(s, name), f"{where}/{name}")))
    return state


def _mha(p: dict, where: str) -> State:
    _keys(p, where, ("query", "key", "value", "out"))
    for name in ("query", "key", "value", "out"):
        _keys(p[name], f"{where}/{name}", ("kernel",))
    return {name: _t(p[name]["kernel"]) for name in ("query", "key", "value", "out")}


def _transformer_encoder_layer(p: dict, s: dict, where: str) -> State:
    _keys(p, where, ("MultiHeadDotProductAttention_0", "LayerNorm_0", "Dense_0", "Dense_1", "LayerNorm_1"))
    return {
        **_nest("attn", _mha(p["MultiHeadDotProductAttention_0"], f"{where}/MultiHeadDotProductAttention_0")),
        **_nest("norm1", _layer_norm(p["LayerNorm_0"], f"{where}/LayerNorm_0")),
        **_nest("ff1", _dense(p["Dense_0"], f"{where}/Dense_0")),
        **_nest("ff2", _dense(p["Dense_1"], f"{where}/Dense_1")),
        **_nest("norm2", _layer_norm(p["LayerNorm_1"], f"{where}/LayerNorm_1")),
    }


def _causal_layer(p: dict, s: dict, where: str) -> State:
    _keys(p, where, ("LayerNorm_0", "MultiHeadDotProductAttention_0", "LayerNorm_1", "Dense_0", "Dense_1"))
    return {
        **_nest("norm1", _layer_norm(p["LayerNorm_0"], f"{where}/LayerNorm_0")),
        **_nest("attn", _mha(p["MultiHeadDotProductAttention_0"], f"{where}/MultiHeadDotProductAttention_0")),
        **_nest("norm2", _layer_norm(p["LayerNorm_1"], f"{where}/LayerNorm_1")),
        **_nest("ff1", _dense(p["Dense_0"], f"{where}/Dense_0")),
        **_nest("ff2", _dense(p["Dense_1"], f"{where}/Dense_1")),
    }


def _count(p: dict, kind: str) -> int:
    return sum(1 for k in p if k.startswith(f"{kind}_"))


def _stream_blocks(p: dict, n_blocks: int) -> tuple:
    """The port's names of an encoder's stream blocks, in flax's creation
    order: with the GNN node, edge, then angle; without it flat, then
    angle."""
    names = ("node_block", "edge_block") if "CensNetConv_0" in p else ("block",)
    if n_blocks > len(names):
        names += ("angle_block",)
    if n_blocks != len(names):
        raise KeyError(f"flax params: {n_blocks} stream blocks where the encoder has {len(names)} or "
                       f"{len(names) + 1}")
    return names


def _mlp_head(p: dict, s: dict, where: str, first_dense: int) -> State:
    dense = [f"Dense_{first_dense + i}" for i in range(3)]
    state = {}
    for name, src in zip(("dense1", "dense2", "dense3"), dense):
        state.update(_nest(f"mlp.{name}", _dense(p[src], f"{where}/{src}")))
    for name, src in zip(("bn1", "bn2"), ("BatchNorm_0", "BatchNorm_1")):
        state.update(_nest(f"mlp.{name}", _batch_norm(p[src], _stats(s, src), f"{where}/{src}")))
    return state


def _censnet_state(p: dict, s: dict, where: str) -> State:
    return _nest("censnet", _censnet(p["CensNetConv_0"], s, f"{where}/CensNetConv_0")) if "CensNetConv_0" in p else {}


def _recurrent_encoder(p: dict, s: dict, where: str) -> State:
    blocks = _stream_blocks(p, _count(p, "RecurrentBlock"))
    gnn = ("CensNetConv_0",) if "CensNetConv_0" in p else ()
    _keys(p, where, [f"RecurrentBlock_{i}" for i in range(len(blocks))] + list(gnn) + ["Dense_0"])
    state = _censnet_state(p, s, where)
    for i, name in enumerate(blocks):
        state.update(_nest(name, _recurrent_block(p[f"RecurrentBlock_{i}"], s, f"{where}/RecurrentBlock_{i}")))
    state.update(_nest("dense", _dense(p["Dense_0"], f"{where}/Dense_0")))
    return state


def _tcn_encoder(p: dict, s: dict, where: str) -> State:
    blocks = _stream_blocks(p, _count(p, "TCN"))
    gnn = ("CensNetConv_0",) if "CensNetConv_0" in p else ()
    _keys(p, where, [f"TCN_{i}" for i in range(len(blocks))] + list(gnn)
          + ["Dense_0", "Dense_1", "Dense_2", "BatchNorm_0", "BatchNorm_1"])
    state = _censnet_state(p, s, where)
    for i, name in enumerate(blocks):
        state.update(_nest(name, _tcn(p[f"TCN_{i}"], _stats(s, f"TCN_{i}"), f"{where}/TCN_{i}")))
    state.update(_mlp_head(p, s, where, 0))
    return state


def _transformer_encoder(p: dict, s: dict, where: str) -> State:
    n_cores = _count(p, "Dense") - 3
    blocks = _stream_blocks(p, n_cores)
    n_layers, rest = divmod(_count(p, "TransformerEncoderLayer"), max(n_cores, 1))
    if rest:
        raise KeyError(f"flax params at {where}: {_count(p, 'TransformerEncoderLayer')} encoder layers "
                       f"for {n_cores} cores")
    gnn = ("CensNetConv_0",) if "CensNetConv_0" in p else ()
    layers = [f"TransformerEncoderLayer_{i}" for i in range(n_cores * n_layers)]
    _keys(p, where, [f"Dense_{i}" for i in range(n_cores + 3)] + layers + list(gnn) + ["BatchNorm_0", "BatchNorm_1"])
    state = _censnet_state(p, s, where)
    for c, name in enumerate(blocks):
        state.update(_nest(f"{name}.embed", _dense(p[f"Dense_{c}"], f"{where}/Dense_{c}")))
        for j in range(n_layers):
            src = layers[c * n_layers + j]
            state.update(_nest(f"{name}.layers.{j}", _transformer_encoder_layer(p[src], s, f"{where}/{src}")))
    state.update(_mlp_head(p, s, where, n_cores))
    return state


def _head_dense(p: dict, where: str) -> State:
    _keys(p["ProbabilisticHead_0"], f"{where}/ProbabilisticHead_0", ("Dense_0",))
    return _nest("head.dense", _dense(p["ProbabilisticHead_0"]["Dense_0"], f"{where}/ProbabilisticHead_0/Dense_0"))


def _recurrent_decoder(p: dict, s: dict, where: str) -> State:
    _keys(p, where, ("BiGRU_0", "LayerNorm_0", "BiGRU_1", "LayerNorm_1", "Conv_0", "LayerNorm_2",
                     "ProbabilisticHead_0"))
    return {
        **_nest("gru1", _bigru(p["BiGRU_0"], s, f"{where}/BiGRU_0")),
        **_nest("norm1", _layer_norm(p["LayerNorm_0"], f"{where}/LayerNorm_0")),
        **_nest("gru2", _bigru(p["BiGRU_1"], s, f"{where}/BiGRU_1")),
        **_nest("norm2", _layer_norm(p["LayerNorm_1"], f"{where}/LayerNorm_1")),
        "conv_weight": _conv(p["Conv_0"], f"{where}/Conv_0", bias=False)["weight"],
        **_nest("norm3", _layer_norm(p["LayerNorm_2"], f"{where}/LayerNorm_2")),
        **_head_dense(p, where),
    }


def _tcn_decoder(p: dict, s: dict, where: str) -> State:
    _keys(p, where, ("Dense_0", "Dense_1", "Dense_2", "BatchNorm_0", "BatchNorm_1", "BatchNorm_2", "TCN_0",
                     "ProbabilisticHead_0"))
    state = {}
    for i in range(3):
        state.update(_nest(f"dense{i}", _dense(p[f"Dense_{i}"], f"{where}/Dense_{i}")))
        state.update(_nest(f"bn{i}", _batch_norm(p[f"BatchNorm_{i}"], _stats(s, f"BatchNorm_{i}"),
                                                 f"{where}/BatchNorm_{i}")))
    state.update(_nest("tcn", _tcn(p["TCN_0"], _stats(s, "TCN_0"), f"{where}/TCN_0")))
    state.update(_head_dense(p, where))
    return state


def _transformer_decoder(p: dict, s: dict, where: str) -> State:
    n_layers = _count(p, "CausalSelfAttentionLayer")
    layers = [f"CausalSelfAttentionLayer_{i}" for i in range(n_layers)]
    _keys(p, where, ["Dense_0", "Dense_1", "Dense_2", "Dense_3", "ProbabilisticHead_0"] + layers)
    state = {}
    for i in range(3):
        state.update(_nest(f"dense{i}", _dense(p[f"Dense_{i}"], f"{where}/Dense_{i}")))
    for i, src in enumerate(layers):
        state.update(_nest(f"layers.{i}", _causal_layer(p[src], s, f"{where}/{src}")))
    state.update(_nest("out", _dense(p["Dense_3"], f"{where}/Dense_3")))
    state.update(_head_dense(p, where))
    return state


def _encoder(p: dict, s: dict, where: str) -> State:
    """Any of the three encoders, told apart by their children's kinds."""
    if "TCN_0" in p:
        return _tcn_encoder(p, s, where)
    if "TransformerEncoderLayer_0" in p:
        return _transformer_encoder(p, s, where)
    return _recurrent_encoder(p, s, where)


def _decoder(p: dict, s: dict, where: str) -> State:
    if "TCN_0" in p:
        return _tcn_decoder(p, s, where)
    if "CausalSelfAttentionLayer_0" in p:
        return _transformer_decoder(p, s, where)
    return _recurrent_decoder(p, s, where)


def _vector_quantizer(p: dict, s: dict, where: str) -> State:
    _keys(p, where, ("codebook",))
    return {"codebook": _t(p["codebook"])}


def _vqvae(p: dict, s: dict, where: str) -> State:
    _keys(p, where, ("encoder", "vq_layer", "decoder"))
    return {
        **_nest("encoder", _encoder(p["encoder"], _stats(s, "encoder"), f"{where}/encoder")),
        **_nest("vq_layer", _vector_quantizer(p["vq_layer"], s, f"{where}/vq_layer")),
        **_nest("decoder", _decoder(p["decoder"], _stats(s, "decoder"), f"{where}/decoder")),
    }


def _gaussian_mixture_latent(p: dict, s: dict, where: str) -> State:
    _keys(p, where, ("gmm_means", "gmm_log_vars", "encoder_mean", "encoder_log_var"))
    return {
        "gmm_means": _t(p["gmm_means"]),
        "gmm_log_vars": _t(p["gmm_log_vars"]),
        **_nest("encoder_mean", _dense(p["encoder_mean"], f"{where}/encoder_mean")),
        **_nest("encoder_log_var", _dense(p["encoder_log_var"], f"{where}/encoder_log_var")),
    }


def _vade(p: dict, s: dict, where: str) -> State:
    _keys(p, where, ("encoder", "latent_space", "decoder"))
    return {
        **_nest("encoder", _encoder(p["encoder"], _stats(s, "encoder"), f"{where}/encoder")),
        **_nest("latent_space", _gaussian_mixture_latent(p["latent_space"], s, f"{where}/latent_space")),
        **_nest("decoder", _decoder(p["decoder"], _stats(s, "decoder"), f"{where}/decoder")),
    }


def _contrastive(p: dict, s: dict, where: str) -> State:
    _keys(p, where, ("encoder",))
    return _nest("encoder", _encoder(p["encoder"], _stats(s, "encoder"), f"{where}/encoder"))


_CONVERTERS: Dict[str, Callable[[dict, dict, str], State]] = {
    "VQVAE": _vqvae,
    "VaDE": _vade,
    "Contrastive": _contrastive,
    "GaussianMixtureLatent": _gaussian_mixture_latent,
    "RecurrentEncoder": _recurrent_encoder,
    "TCNEncoder": _tcn_encoder,
    "TransformerEncoder": _transformer_encoder,
    "RecurrentDecoder": _recurrent_decoder,
    "TCNDecoder": _tcn_decoder,
    "TransformerDecoder": _transformer_decoder,
    "RecurrentBlock": _recurrent_block,
    "TCN": _tcn,
    "TransformerEncoderLayer": _transformer_encoder_layer,
    "CausalSelfAttentionLayer": _causal_layer,
    "CensNetConv": _censnet,
    "VectorQuantizer": _vector_quantizer,
    "BiGRU": _bigru,
    "MaskedGRU": _masked_gru,
}


def _leaves(tree: dict, prefix: str = "") -> list:
    out = []
    for k, v in tree.items():
        out += _leaves(v, f"{prefix}/{k}") if isinstance(v, dict) else [f"{prefix}/{k}"]
    return out


def from_flax_params(params: dict, kind: str = "VQVAE", batch_stats: Optional[dict] = None) -> State:
    """State dict for the port's ``kind`` module from a flax params tree and,
    where the module holds BatchNorm, its batch-stats tree.

    Load it with ``module.load_state_dict(state)`` (strict), which also
    checks every shape. A BatchNorm whose stats are missing raises, and so
    does a stats leaf that no BatchNorm reads.
    """
    if kind not in _CONVERTERS:
        raise ValueError(f"unknown module kind {kind!r}; one of {sorted(_CONVERTERS)}")
    stats = copy.deepcopy(batch_stats) if batch_stats else {}
    state = _CONVERTERS[kind](params, stats, "<root>")
    unknown = _leaves(stats)
    if unknown:
        raise KeyError(f"flax batch_stats: unknown {sorted(unknown)}")
    return state
