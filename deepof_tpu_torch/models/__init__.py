"""The port's models: VQ-VAE, VaDE and Contrastive, each with a recurrent, TCN or
transformer encoder (+ CensNet)."""

from deepof_tpu_torch.models.zoo import VQVAE, Contrastive, VaDE, build_model

__all__ = ["VQVAE", "VaDE", "Contrastive", "build_model"]
