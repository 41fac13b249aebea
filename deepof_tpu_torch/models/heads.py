"""The VQ codebook head in its eval form (port of
deepof_tpu/models/heads.py:26 ``VectorQuantizer``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class VectorQuantizer(nn.Module):
    """L2 codebook quantisation.

    Call: x (B, D) -> (quantized (B, D), soft_counts (B, K)); soft counts
    are the normalised inverse squared distances to the K codes.
    """

    def __init__(self, n_components: int, embedding_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embedding_dim = embedding_dim
        self.codebook = nn.Parameter(torch.rand((embedding_dim, n_components), generator=generator))

    def forward(self, x: torch.Tensor):
        flat = x.reshape(-1, self.embedding_dim)
        distances = (
            (flat * flat).sum(dim=1, keepdim=True)
            + (self.codebook * self.codebook).sum(dim=0)
            - 2 * (flat @ self.codebook)
        )
        indices = distances.argmin(dim=1)
        inv_sq = (1.0 / distances) ** 2
        soft_counts = inv_sq / inv_sq.sum(dim=1, keepdim=True)
        quantized = self.codebook.T[indices].reshape(x.shape)
        return quantized, soft_counts
