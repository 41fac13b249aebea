"""Sequence encoders, each optionally fused with a CensNet graph conv over
the body graph (port of deepof_tpu/models/encoders.py: ``RecurrentEncoder``
:43, ``TCNEncoder`` :99, ``TransformerEncoder`` :173), with the optional
angle stream.

Every encoder takes its streams two ways: ``forward(x, a, angles)`` from
windows, and ``forward_streams(xg, ag, ang)`` from the streams as the
window kernel writes them (node n of window b at stream b*N + n). With the
GNN each node and each edge is a stream of its own; without it the node
features are one flat stream. The TCN and transformer encoders end in the
same MLP head with BatchNorm; the transformer's output is standardised over
the batch in train mode.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepof_tpu_torch.models.blocks import (
    TCN,
    BatchNorm,
    Dense,
    Dropout,
    RecurrentBlock,
    TransformerEncoderLayer,
    frame_validity_mask,
    positional_encoding,
    rms_stabilize,
    tf_style_group_reshape,
)
from deepof_tpu_torch.models.gnn import CensNetConv


class _StreamEncoder(nn.Module):
    """What the three encoders share: one summary block per stream kind
    (``make_block(in_features) -> module`` whose output has ``width``
    features), CensNet over the node and edge summaries, the angle stream's
    block concatenated last, and the head (``make_head(in_features)``,
    registered as ``head_name`` before the angle block) on the
    concatenation, through ``head``."""

    def __init__(self, input_shape, edge_feature_shape, latent_dim: int, adjacency, use_gnn: bool,
                 generator, angle_feature_shape, make_block, width: int, head_name: str, make_head):
        super().__init__()
        _, n, f_node = input_shape
        _, e, f_edge = edge_feature_shape
        self.n_nodes, self.n_edges = n, e
        self.use_gnn = use_gnn
        f_angle = int(np.prod(angle_feature_shape[1:])) if angle_feature_shape else 0
        if use_gnn:
            self.node_block = make_block(f_node)
            self.edge_block = make_block(f_edge)
            self.censnet = CensNetConv(width, width, latent_dim, latent_dim, adjacency, generator)
            enc_dim = (n + e) * latent_dim
        else:
            self.block = make_block(n * f_node)
            enc_dim = width
        self.add_module(head_name, make_head(enc_dim + (width if f_angle else 0)))
        self.angle_block = make_block(f_angle) if f_angle else None

    def forward(self, x: torch.Tensor, a: torch.Tensor, angles: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, T, N, F_node), a (B, T, E, F_edge), angles (B, T, A[, 1])
        where the encoder has an angle block -> (B, latent_dim)."""
        b, t, n, f_node = x.shape
        ang = None if angles is None else angles.reshape(b, t, -1)
        if self.use_gnn:
            e, f_edge = a.shape[2:]
            xg = tf_style_group_reshape(x).reshape(b * n, t, f_node)
            ag = tf_style_group_reshape(a).reshape(b * e, t, f_edge)
            return self.forward_streams(xg, ag, ang)
        return self.forward_streams(x.reshape(b, t, n * f_node), None, ang)

    def forward_streams(self, xg: torch.Tensor, ag: Optional[torch.Tensor],
                        ang: Optional[torch.Tensor] = None) -> torch.Tensor:
        """With the GNN: xg (B*N, T, F_node) and ag (B*E, T, F_edge), stream
        b*N + n being node n of sample b (window-major, as
        ``ops.window_kernels.window_streams`` writes them). Without: xg is
        the one flat stream (B, T, N*F_node) and ag is not read. ang: the
        flat angle stream (B, T, A), read when the encoder has an angle
        block and required then. -> (B, latent_dim)."""
        if (ang is not None) != (self.angle_block is not None):
            raise ValueError(
                "angles given to an encoder without an angle block, or missing for one with it"
            )
        if self.use_gnn:
            b = xg.shape[0] // self.n_nodes
            node_emb = self.node_block(xg).reshape(b, self.n_nodes, -1)
            edge_emb = self.edge_block(ag).reshape(b, self.n_edges, -1)
            node_g, edge_g = self.censnet(node_emb, edge_emb)
            enc = torch.cat([node_g.reshape(b, -1), edge_g.reshape(b, -1)], dim=-1)
        else:
            enc = self.block(xg)
        if ang is not None:
            enc = torch.cat([enc, self.angle_block(ang)], dim=-1)
        return self.head(enc)


class RecurrentEncoder(_StreamEncoder):
    """Conv1D -> stacked BiGRU per node / edge stream -> CensNet -> Dense
    (each stream's RecurrentBlock gives 2*latent features; the angle stream
    its own RecurrentBlock)."""

    def __init__(self, input_shape, edge_feature_shape, latent_dim: int,
                 adjacency: Optional[np.ndarray] = None, use_gnn: bool = True,
                 generator: Optional[torch.Generator] = None, angle_feature_shape=None):
        super().__init__(input_shape, edge_feature_shape, latent_dim, adjacency, use_gnn, generator,
                         angle_feature_shape, lambda f: RecurrentBlock(f, latent_dim, generator), 2 * latent_dim,
                         "dense", lambda d: Dense(d, latent_dim, generator))

    def head(self, enc: torch.Tensor) -> torch.Tensor:
        return self.dense(enc)


class MLPHead(nn.Module):
    """The TCN and transformer encoders' head: RMS guard -> Dense(2L) ->
    ReLU -> BatchNorm -> Dense(L) -> ReLU -> BatchNorm -> Dense(L)."""

    def __init__(self, in_features: int, latent_dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dense1 = Dense(in_features, 2 * latent_dim, generator)
        self.bn1 = BatchNorm(2 * latent_dim)
        self.dense2 = Dense(2 * latent_dim, latent_dim, generator)
        self.bn2 = BatchNorm(latent_dim)
        self.dense3 = Dense(latent_dim, latent_dim, generator)

    def forward(self, enc: torch.Tensor) -> torch.Tensor:
        h = self.bn1(F.relu(self.dense1(rms_stabilize(enc))))
        h = self.bn2(F.relu(self.dense2(h)))
        return self.dense3(h)


class TCNEncoder(_StreamEncoder):
    """Per-stream causal dilated TCN (32 filters, kernel 4, dilations
    (1, 2, 4, 8) twice; its last step) -> CensNet -> MLP head."""

    def __init__(self, input_shape, edge_feature_shape, latent_dim: int,
                 adjacency: Optional[np.ndarray] = None, use_gnn: bool = True,
                 generator: Optional[torch.Generator] = None, angle_feature_shape=None):
        super().__init__(input_shape, edge_feature_shape, latent_dim, adjacency, use_gnn, generator,
                         angle_feature_shape, lambda f: TCN(f, 32, generator=generator), 32,
                         "mlp", lambda d: MLPHead(d, latent_dim, generator))

    def head(self, enc: torch.Tensor) -> torch.Tensor:
        return self.mlp(enc)


class TransformerCore(nn.Module):
    """One stream's transformer: Dense(key_dim) -> ReLU -> * sqrt(key_dim) ->
    + positional encoding -> dropout -> encoder layers (all-zero frames of
    the stream masked as keys) -> the last step (B', key_dim)."""

    def __init__(self, in_features: int, key_dim: int, num_layers: int, num_heads: int, dff: int,
                 rate: float, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.key_dim = key_dim
        self.embed = Dense(in_features, key_dim, generator)
        self.drop = Dropout(rate)
        self.layers = nn.ModuleList(
            [TransformerEncoderLayer(key_dim, num_heads, dff, rate, generator) for _ in range(num_layers)])

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        valid = frame_validity_mask(y)
        h = F.relu(self.embed(y)) * math.sqrt(self.key_dim)
        h = self.drop(h + positional_encoding(y.shape[1], self.key_dim, h))
        for layer in self.layers:
            h = layer(h, valid)
        return h[:, -1, :]


class TransformerEncoder(_StreamEncoder):
    """Per-stream transformer cores (2 layers, 4 heads, dff 128, dropout
    0.1; key_dim min(64, N * F_node) rounded down to a multiple of the
    heads, encoders.py:220-221) -> CensNet -> MLP head; in train mode with
    more than one sample the output is standardised over the batch, (out -
    mean) / max(std, 0.1), std without correction as numpy's."""

    def __init__(self, input_shape, edge_feature_shape, latent_dim: int,
                 adjacency: Optional[np.ndarray] = None, use_gnn: bool = True,
                 generator: Optional[torch.Generator] = None, angle_feature_shape=None):
        _, n, f_node = input_shape
        heads = 4
        key_dim = max((min(64, n * f_node) // heads) * heads, heads)
        super().__init__(input_shape, edge_feature_shape, latent_dim, adjacency, use_gnn, generator,
                         angle_feature_shape,
                         lambda f: TransformerCore(f, key_dim, 2, heads, 128, 0.1, generator),
                         key_dim, "mlp", lambda d: MLPHead(d, latent_dim, generator))

    def head(self, enc: torch.Tensor) -> torch.Tensor:
        out = self.mlp(enc)
        if self.training and out.shape[0] > 1:
            out = (out - out.mean(dim=0, keepdim=True)) / out.std(dim=0, correction=0, keepdim=True).clamp(min=0.1)
        return out


ENCODERS = {"recurrent": RecurrentEncoder, "TCN": TCNEncoder, "transformer": TransformerEncoder}
