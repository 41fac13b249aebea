"""Serving-path models: the recurrent (+ CensNet) VQ-VAE encoder and head."""

from deepof_tpu_torch.models.zoo import VQVAE, build_model

__all__ = ["VQVAE", "build_model"]
