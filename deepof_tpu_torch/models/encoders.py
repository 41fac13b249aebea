"""The recurrent sequence encoder, optionally fused with a CensNet graph
conv over the body graph (port of deepof_tpu/models/encoders.py:43
``RecurrentEncoder``), with its optional angle stream. The TCN and
transformer encoders wait for a later slice (ROADMAP queue 1, item 8).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from deepof_tpu_torch.models.blocks import Dense, RecurrentBlock, tf_style_group_reshape
from deepof_tpu_torch.models.gnn import CensNetConv


class RecurrentEncoder(nn.Module):
    """Conv1D -> stacked BiGRU per node / edge stream -> CensNet -> Dense.

    Call: x (B, T, N, F_node), a (B, T, E, F_edge), optional angles
    (B, T, A[, 1]) -> (B, latent_dim). Without the GNN the node features are
    flattened into one stream. With ``angle_feature_shape`` (T, A[, 1]) the
    bridge angles run through a RecurrentBlock of their own, concatenated
    before the final Dense (encoders.py:90-94). ``forward_streams`` takes
    the streams as the window kernel writes them.
    """

    def __init__(self, input_shape, edge_feature_shape, latent_dim: int,
                 adjacency: Optional[np.ndarray] = None, use_gnn: bool = True,
                 generator: Optional[torch.Generator] = None, angle_feature_shape=None):
        super().__init__()
        _, n, f_node = input_shape
        _, e, f_edge = edge_feature_shape
        self.n_nodes, self.n_edges = n, e
        self.use_gnn = use_gnn
        f_angle = int(np.prod(angle_feature_shape[1:])) if angle_feature_shape else 0
        if use_gnn:
            self.node_block = RecurrentBlock(f_node, latent_dim, generator)
            self.edge_block = RecurrentBlock(f_edge, latent_dim, generator)
            self.censnet = CensNetConv(
                2 * latent_dim, 2 * latent_dim, latent_dim, latent_dim,
                adjacency, generator,
            )
            enc_dim = (n + e) * latent_dim
        else:
            self.block = RecurrentBlock(n * f_node, latent_dim, generator)
            enc_dim = 2 * latent_dim
        self.dense = Dense(enc_dim + (2 * latent_dim if f_angle else 0), latent_dim, generator)
        self.angle_block = RecurrentBlock(f_angle, latent_dim, generator) if f_angle else None

    def forward(self, x: torch.Tensor, a: torch.Tensor, angles: Optional[torch.Tensor] = None) -> torch.Tensor:
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
        return self.dense(enc)
