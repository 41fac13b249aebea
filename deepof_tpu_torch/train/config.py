"""Training configuration of the VQ-VAE fit (port of
deepof_tpu/train/config.py ``CommonFitCfg``): the fields that ``fit_vqvae``
reads, with the JAX package's names and defaults. The JAX package's other
common fields are ``train_deepof_model`` arguments (the output paths, the
run number, ``kmeans_loss``), raise there (``use_amp``), or are read by no
VQ-VAE code and raise there too (``UNREAD_COMMON_FIELDS``). The VaDE,
Contrastive and teacher configs come with those models (ROADMAP queue 1,
item 8)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

# The JAX package's CommonFitCfg fields that its VQ-VAE branch never reads,
# with their defaults: a keyword that sets one to another value raises.
UNREAD_COMMON_FIELDS = {"num_workers": 0, "prefetch_factor": 0,
                        "interaction_regularization": 0.0, "diag_max_batches": 4}


@dataclass
class CommonFitCfg:
    learning_rate: float = 3e-4
    encoder_type: str = "recurrent"

    batch_size: int = 1024
    latent_dim: int = 6
    epochs: int = 10
    n_components: int = 10

    seed: Optional[int] = None

    limit_train_batches: Optional[int] = 1000
    limit_val_batches: Optional[int] = 1000
