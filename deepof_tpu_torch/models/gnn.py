"""CensNet graph convolution: co-embedding of nodes and edges
(port of deepof_tpu/models/gnn.py).

The graph operators (GCN-normalised laplacian, line-graph laplacian,
incidence matrix) are built once on the host in numpy; the per-batch
propagation is dense einsum.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn


def _degree_power(a: np.ndarray, k: float) -> np.ndarray:
    degrees = a.sum(axis=1)
    degrees[degrees == 0] = 1.0
    return np.diag(degrees**k)


def _normalized_adjacency(a: np.ndarray) -> np.ndarray:
    d = _degree_power(a, -0.5)
    return d @ a @ d


def gcn_filter(a: np.ndarray) -> np.ndarray:
    """Symmetric GCN normalisation of A + I."""
    return _normalized_adjacency(a + np.eye(a.shape[0]))


def incidence_matrix(adjacency: np.ndarray) -> np.ndarray:
    """(N, E) incidence, edges in upper-triangular row-major order."""
    rows, cols = np.nonzero(np.triu(adjacency))
    inc = np.zeros((adjacency.shape[0], len(rows)))
    for k, (i, j) in enumerate(zip(rows, cols)):
        inc[i, k] = 1.0
        inc[j, k] = 1.0
    return inc


def line_graph(incidence: np.ndarray) -> np.ndarray:
    """Line-graph adjacency: edges are joined iff they share a node."""
    l = incidence.T @ incidence
    return l - 2 * np.eye(l.shape[-1])


def censnet_operators(adjacency: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(laplacian (N,N), edge_laplacian (E,E), incidence (N,E)) float32."""
    adjacency = np.asarray(adjacency, dtype=np.float64)
    inc = incidence_matrix(adjacency)
    return (
        gcn_filter(adjacency).astype(np.float32),
        gcn_filter(line_graph(inc)).astype(np.float32),
        inc.astype(np.float32),
    )


def _xavier_uniform(fan_in: int, fan_out: int, generator) -> torch.Tensor:
    limit = (6.0 / (fan_in + fan_out)) ** 0.5
    return (torch.rand((fan_in, fan_out), generator=generator) * 2 - 1) * limit


class CensNetConv(nn.Module):
    """One CensNet layer: nodes propagate through an edge-weighted graph and
    edges through a node-weighted line graph; ReLU on both outputs.

    Call: nodes (B, N, F_n), edges (B, E, F_e) -> (B, N, C_n), (B, E, C_e).
    """

    def __init__(self, node_features: int, edge_features: int,
                 node_channels: int, edge_channels: int, adjacency: np.ndarray,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        lap, edge_lap, inc = censnet_operators(adjacency)
        self.register_buffer("laplacian", torch.as_tensor(lap), persistent=False)
        self.register_buffer("edge_laplacian", torch.as_tensor(edge_lap), persistent=False)
        self.register_buffer("incidence", torch.as_tensor(inc), persistent=False)
        self.node_kernel = nn.Parameter(_xavier_uniform(node_features, node_channels, generator))
        self.edge_kernel = nn.Parameter(_xavier_uniform(edge_features, edge_channels, generator))
        self.node_weights = nn.Parameter(_xavier_uniform(node_features, 1, generator))
        self.edge_weights = nn.Parameter(_xavier_uniform(edge_features, 1, generator))
        self.node_bias = nn.Parameter(torch.zeros(node_channels))
        self.edge_bias = nn.Parameter(torch.zeros(edge_channels))

    def forward(self, nodes: torch.Tensor, edges: torch.Tensor):
        inc = self.incidence
        # Node propagation: A_w = (inc diag(w_e) inc^T) * lap.
        w_edge = (edges @ self.edge_weights).squeeze(-1)                 # (B, E)
        node_adj = torch.einsum("bne,me->bnm", inc[None] * w_edge[:, None, :], inc)
        node_adj = node_adj * self.laplacian[None]
        node_out = torch.einsum("bnm,bmf->bnf", node_adj, nodes) @ self.node_kernel
        # Edge propagation: L_w = (inc^T diag(w_n) inc) * edge_lap.
        w_node = (nodes @ self.node_weights).squeeze(-1)                 # (B, N)
        edge_adj = torch.einsum("ben,nk->bek", inc.T[None] * w_node[:, None, :], inc)
        edge_adj = edge_adj * self.edge_laplacian[None]
        edge_out = torch.einsum("bek,bkf->bef", edge_adj, edges) @ self.edge_kernel
        return (
            torch.relu(node_out + self.node_bias),
            torch.relu(edge_out + self.edge_bias),
        )
