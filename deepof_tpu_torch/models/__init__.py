"""The port's models: the recurrent (+ CensNet) VQ-VAE and VaDE."""

from deepof_tpu_torch.models.zoo import VQVAE, VaDE, build_model

__all__ = ["VQVAE", "VaDE", "build_model"]
