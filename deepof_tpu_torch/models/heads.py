"""The latent heads (port of deepof_tpu/models/heads.py): the VQ codebook
(``VectorQuantizer`` :26, with its training losses, and
``compute_kmeans_loss`` :16-23) and VaDE's Gaussian-mixture latent
(``cluster_metrics`` :80, ``GaussianMixtureLatent`` :92)."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from deepof_tpu_torch.models.blocks import Dense, xavier_normal


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


def cluster_metrics(z_cat: torch.Tensor) -> dict:
    """Populated-cluster count (clusters that are some row's argmax) and the
    mean confidence in each row's selected cluster: the JAX head's
    ``metrics``, computed from its ``categorical`` on request only."""
    hard = F.one_hot(z_cat.argmax(dim=1), z_cat.shape[1])
    return {
        "number_of_populated_clusters": hard.any(dim=0).sum().to(torch.float32),
        "confidence_in_selected_cluster": z_cat.max(dim=1).values.mean(),
    }


class GaussianMixtureLatent(nn.Module):
    """VaDE latent: a reparameterised diagonal Gaussian encoder and a
    learnable GMM prior (K components, uniform weights) with a softmax
    posterior.

    Call: x (B, input_dim) -> dict with z, categorical, kmeans_loss,
    z_mean, z_log_var, gmm_means, gmm_log_vars, prior. With ``train``, z =
    z_mean + exp(z_log_var / 2) * eps, eps given or drawn from
    ``generator`` on x's device; otherwise z = z_mean. The k-means
    regulariser of z is computed only when ``kmeans`` > 0.
    """

    def __init__(self, input_dim: int, n_components: int, latent_dim: int, kmeans: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_components = n_components
        self.kmeans = kmeans
        self.gmm_means = nn.Parameter(xavier_normal((n_components, latent_dim), generator))
        self.gmm_log_vars = nn.Parameter(xavier_normal((n_components, latent_dim), generator))
        self.encoder_mean = Dense(input_dim, latent_dim, generator)
        self.encoder_log_var = Dense(input_dim, latent_dim, generator)

    def forward(self, x: torch.Tensor, train: bool = False, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> dict:
        z_mean = self.encoder_mean(x)
        z_log_var = F.softplus(self.encoder_log_var(x))
        if train:
            if eps is None:
                eps = torch.randn(z_mean.shape, generator=generator, device=z_mean.device, dtype=z_mean.dtype)
            z = z_mean + torch.exp(0.5 * z_log_var) * eps
        else:
            z = z_mean
        prior = z.new_full((self.n_components,), 1.0 / self.n_components)
        # Posterior p(c | z) under the GMM prior.
        gmm_std = torch.exp(0.5 * self.gmm_log_vars).clamp(min=1e-3)
        diff = z[:, None, :] - self.gmm_means[None]
        log_p_z_given_c = -0.5 * torch.sum(
            torch.log(2 * math.pi * gmm_std[None] ** 2) + (diff / gmm_std[None]) ** 2, dim=-1
        )
        z_cat = torch.softmax(torch.log(prior + 1e-9)[None] + log_p_z_given_c, dim=-1)
        return {
            "z": z,
            "categorical": z_cat,
            "kmeans_loss": compute_kmeans_loss(z, self.kmeans) if self.kmeans > 0 else z.new_zeros(()),
            "z_mean": z_mean,
            "z_log_var": z_log_var,
            "gmm_means": self.gmm_means,
            "gmm_log_vars": self.gmm_log_vars,
            "prior": prior,
        }
