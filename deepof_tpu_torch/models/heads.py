"""The VQ codebook head (port of deepof_tpu/models/heads.py:26
``VectorQuantizer``, with its training losses, and ``compute_kmeans_loss``
:16-23)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def compute_kmeans_loss(latent: torch.Tensor, weight: float) -> torch.Tensor:
    """Gram-matrix singular-value regulariser that favours orthogonal
    latents: weight * nanmean(sqrt(clip(svdvals(latent^T latent / B), 1e-9)))."""
    gram = (latent.T @ latent) / latent.shape[0]
    singular_values = torch.linalg.svdvals(gram.to(torch.float32))
    return weight * torch.nanmean(torch.sqrt(torch.clamp(singular_values, min=1e-9)))


class VectorQuantizer(nn.Module):
    """L2 codebook quantisation.

    Call: x (B, D) -> (quantized (B, D), soft_counts (B, K)); soft counts
    are the normalised inverse squared distances to the K codes. With
    ``return_losses`` (training): (quantized with straight-through
    gradients ``x + (q - x).detach()``, soft_counts, {"vq_loss":
    mean((q.detach() - x)^2) + mean((q - x.detach())^2)[, "kmeans_loss"]}):
    the commitment and codebook losses, the commitment weighted 1 as in the
    JAX package's VQ-VAE.
    """

    def __init__(self, n_components: int, embedding_dim: int,
                 generator: Optional[torch.Generator] = None, kmeans_loss: float = 0.0):
        super().__init__()
        self.embedding_dim = embedding_dim
        self.kmeans_loss = kmeans_loss
        self.codebook = nn.Parameter(torch.rand((embedding_dim, n_components), generator=generator))

    def forward(self, x: torch.Tensor, return_losses: bool = False):
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
        if not return_losses:
            return quantized, soft_counts
        losses = {
            "vq_loss": torch.mean((quantized.detach() - x) ** 2)
            + torch.mean((quantized - x.detach()) ** 2)
        }
        if self.kmeans_loss:
            losses["kmeans_loss"] = compute_kmeans_loss(flat, self.kmeans_loss)
        return x + (quantized - x).detach(), soft_counts, losses
