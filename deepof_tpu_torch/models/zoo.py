"""The models: VQ-VAE, VaDE and Contrastive, each with a recurrent, TCN or
transformer encoder (port of deepof_tpu/models/zoo.py: ``_make_encoder``
:31, ``_make_decoder`` :49, ``VQVAE`` :65, ``VaDE`` :122, ``Contrastive``
:183, ``build_model`` :224).

Serving reads the encoder and the head (``forward``, ``forward_streams``,
in the module's mode, which serving sets to eval); ``encode``, ``embed``
and ``group`` run in eval mode, as the JAX package runs them at
``train=False``. Training also runs the decoder (``training_forward``, in
the module's mode; VaDE's at ``train=False`` in eval mode). Contrastive is
an encoder alone over half windows. ``SERVING_KEYS`` names each model's
embedding and soft-count outputs (Contrastive has no soft counts of its
own).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from deepof_tpu_torch.device import resolve_device
from deepof_tpu_torch.models.blocks import run_mode
from deepof_tpu_torch.models.decoders import DECODERS
from deepof_tpu_torch.models.encoders import ENCODERS
from deepof_tpu_torch.models.heads import GaussianMixtureLatent, VectorQuantizer

# The outputs of each model's serving forward that ``embedding_per_video``
# returns: (embeddings, soft counts or None).
SERVING_KEYS = {"VQVAE": ("encoder_output", "soft_counts"), "VaDE": ("latent", "categorical"),
                "Contrastive": ("encoder_output", None)}


def _make_encoder(encoder_type, input_shape, edge_feature_shape, latent_dim, adjacency, use_gnn, generator,
                  angle_feature_shape):
    if encoder_type not in ENCODERS:
        raise NotImplementedError('invalid encoder type, try "recurrent", "TCN" or "transformer"')
    return ENCODERS[encoder_type](input_shape, edge_feature_shape, latent_dim, adjacency, use_gnn, generator,
                                  angle_feature_shape)


def _make_decoder(encoder_type, input_shape, latent_dim, generator):
    t, n, f = input_shape
    if encoder_type == "recurrent":
        return DECODERS["recurrent"](n * f, latent_dim, generator)
    return DECODERS[encoder_type](n * f, t, latent_dim, generator=generator)


class VQVAE(nn.Module):
    """Vector-quantised autoencoder over pose windows."""

    def __init__(self, input_shape, edge_feature_shape, adjacency: np.ndarray,
                 latent_dim: int, n_components: int, encoder_type: str = "recurrent",
                 use_gnn: bool = True, generator: Optional[torch.Generator] = None,
                 angle_feature_shape=None, kmeans_loss: float = 0.0):
        super().__init__()
        self.encoder = _make_encoder(encoder_type, input_shape, edge_feature_shape, latent_dim, adjacency, use_gnn,
                                     generator, angle_feature_shape)
        self.vq_layer = VectorQuantizer(n_components, latent_dim, generator, kmeans_loss)
        self.decoder = _make_decoder(encoder_type, input_shape, latent_dim, generator)

    def forward(self, x: torch.Tensor, a: torch.Tensor, angles: Optional[torch.Tensor] = None) -> dict:
        """x (B, T, N, F), a (B, T, E, 1), angles (B, T, A[, 1]) where the
        encoder has an angle stream -> encoder output, quantised code and
        soft counts, from one encoder pass."""
        return self._head(self.encoder(x, a, angles))

    def forward_streams(self, xg: torch.Tensor, ag: Optional[torch.Tensor],
                        ang: Optional[torch.Tensor] = None) -> dict:
        """The same from the encoder's streams (``encoders._StreamEncoder.forward_streams``)."""
        return self._head(self.encoder.forward_streams(xg, ag, ang))

    def training_forward(self, x: torch.Tensor, a: torch.Tensor,
                         angles: Optional[torch.Tensor] = None, train: bool = True) -> dict:
        """The training (and training-evaluation) forward, the JAX package's
        ``VQVAE.__call__`` (zoo.py:94-111): both reconstructions (the
        decoder on the quantised code, with straight-through gradients, and
        on the encoder output) as MaskedNormals over (B, T, N*F), the code,
        soft counts, encoder output and the VQ losses; in train mode, or in
        eval mode without ``train`` (as the evaluation step runs it)."""
        with run_mode(self, train):
            enc = self.encoder(x, a, angles)
            quantized, soft_counts, vq_losses = self.vq_layer(enc, return_losses=True)
            b, t, n, f = x.shape
            x_flat = x.reshape(b, t, n * f)
            return {
                "quantized_reconstruction": self.decoder(quantized, x_flat),
                "encoding_reconstruction": self.decoder(enc, x_flat),
                "quantized": quantized,
                "soft_counts": soft_counts,
                "encoder_output": enc,
                "vq_losses": vq_losses,
            }

    def _head(self, enc: torch.Tensor) -> dict:
        quantized, soft_counts = self.vq_layer(enc)
        return {"encoder_output": enc, "quantized": quantized, "soft_counts": soft_counts}

    def encode(self, x: torch.Tensor, a: torch.Tensor, angles: Optional[torch.Tensor] = None) -> torch.Tensor:
        with run_mode(self, False):
            return self.encoder(x, a, angles)

    def group(self, x: torch.Tensor, a: torch.Tensor, angles: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.vq_layer(self.encode(x, a, angles))[1]


class VaDE(nn.Module):
    """Variational deep embedding with a Gaussian-mixture latent."""

    def __init__(self, input_shape, edge_feature_shape, adjacency: np.ndarray,
                 latent_dim: int, n_components: int, encoder_type: str = "recurrent",
                 use_gnn: bool = True, generator: Optional[torch.Generator] = None,
                 angle_feature_shape=None, kmeans_loss: float = 0.0):
        super().__init__()
        self.encoder = _make_encoder(encoder_type, input_shape, edge_feature_shape, latent_dim, adjacency, use_gnn,
                                     generator, angle_feature_shape)
        self.decoder = _make_decoder(encoder_type, input_shape, latent_dim, generator)
        self.latent_space = GaussianMixtureLatent(latent_dim, n_components, latent_dim, kmeans_loss, generator)

    def forward(self, x: torch.Tensor, a: torch.Tensor, angles: Optional[torch.Tensor] = None) -> dict:
        """x (B, T, N, F), a (B, T, E, 1)[, angles] -> the latent (z_mean),
        the categorical posterior and the encoder output, from one encoder
        pass."""
        return self._head(self.encoder(x, a, angles))

    def forward_streams(self, xg: torch.Tensor, ag: Optional[torch.Tensor],
                        ang: Optional[torch.Tensor] = None) -> dict:
        """The same from the encoder's streams (``encoders._StreamEncoder.forward_streams``)."""
        return self._head(self.encoder.forward_streams(xg, ag, ang))

    def _head(self, enc: torch.Tensor) -> dict:
        latent = self.latent_space(enc)
        return {"latent": latent["z"], "categorical": latent["categorical"], "encoder_output": enc}

    def training_forward(self, x: torch.Tensor, a: torch.Tensor, angles: Optional[torch.Tensor] = None,
                         eps: Optional[torch.Tensor] = None, train: bool = True,
                         generator: Optional[torch.Generator] = None) -> dict:
        """The JAX package's ``VaDE.__call__`` (zoo.py:150-172): the decoder's
        reconstruction of z (a MaskedNormal over (B, T, N*F)), z, the
        categorical posterior, the k-means term, z_mean, z_log_var, the GMM
        parameters and the encoder output. With ``train`` it runs in train
        mode and z is sampled (``eps`` or a draw from ``generator``);
        otherwise in eval mode at z = z_mean, as the JAX package's
        evaluation step runs it."""
        with run_mode(self, train):
            enc = self.encoder(x, a, angles)
            latent = self.latent_space(enc, train=train, eps=eps, generator=generator)
            b, t, n, f = x.shape
            return {
                "reconstruction": self.decoder(latent["z"], x.reshape(b, t, n * f)),
                "latent": latent["z"],
                "categorical": latent["categorical"],
                "kmeans_loss": latent["kmeans_loss"],
                "z_mean": latent["z_mean"],
                "z_log_var": latent["z_log_var"],
                "gmm_params": {"means": latent["gmm_means"], "log_vars": latent["gmm_log_vars"],
                               "prior": latent["prior"]},
                "encoder_output": enc,
            }

    def encode(self, x: torch.Tensor, a: torch.Tensor, angles: Optional[torch.Tensor] = None) -> torch.Tensor:
        with run_mode(self, False):
            return self.encoder(x, a, angles)

    def embed(self, x: torch.Tensor, a: torch.Tensor, angles: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.latent_space(self.encode(x, a, angles))["z"]

    def group(self, x: torch.Tensor, a: torch.Tensor, angles: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.latent_space(self.encode(x, a, angles))["categorical"]


class Contrastive(nn.Module):
    """The encoder alone, trained contrastively on half windows:
    ``input_shape`` is the training window's (T, N, F) and the model
    encodes windows of ``window_size`` = T // 2 frames."""

    def __init__(self, input_shape, edge_feature_shape, adjacency: np.ndarray, latent_dim: int,
                 encoder_type: str = "TCN", use_gnn: bool = True, generator: Optional[torch.Generator] = None,
                 angle_feature_shape=None):
        super().__init__()
        self.window_size = input_shape[0] // 2
        self.encoder = _make_encoder(encoder_type, input_shape, edge_feature_shape, latent_dim, adjacency, use_gnn,
                                     generator, angle_feature_shape)

    def forward(self, x: torch.Tensor, a: torch.Tensor, angles: Optional[torch.Tensor] = None) -> dict:
        """Half windows x (B, T // 2, N, F), a (B, T // 2, E, 1) -> the
        embedding (B, latent_dim) as ``encoder_output``."""
        return {"encoder_output": self.encoder(x, a, angles)}

    def forward_streams(self, xg: torch.Tensor, ag: Optional[torch.Tensor],
                        ang: Optional[torch.Tensor] = None) -> dict:
        """The same from the encoder's streams (``encoders._StreamEncoder.forward_streams``)."""
        return {"encoder_output": self.encoder.forward_streams(xg, ag, ang)}

    def training_forward(self, x: torch.Tensor, a: torch.Tensor, angles: Optional[torch.Tensor] = None,
                         train: bool = True) -> torch.Tensor:
        """The JAX package's ``Contrastive.__call__``: the embedding of half
        windows, in train (or eval) mode."""
        with run_mode(self, train):
            return self.encoder(x, a, angles)

    def encode(self, x: torch.Tensor, a: torch.Tensor, angles: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.training_forward(x, a, angles, train=False)


_MODELS = {"VQVAE": VQVAE, "vqvae": VQVAE, "VaDE": VaDE, "vade": VaDE,
           "Contrastive": Contrastive, "contrastive": Contrastive}


def build_model(
    model: str,
    input_shape,
    edge_feature_shape,
    adjacency,
    latent_dim: int,
    n_components: int = 10,
    encoder_type: str = "recurrent",
    use_gnn: bool = True,
    generator: Optional[torch.Generator] = None,
    device="cuda",
    angle_feature_shape=None,
    kmeans_loss: float = 0.0,
) -> nn.Module:
    """Factory for the models ("VQVAE", "VaDE", "Contrastive"; encoder_type
    "recurrent", "TCN" or "transformer"), in train mode on ``device``.
    Weights are drawn on the CPU from ``generator`` (so one seed gives the
    same model on every device) and then moved. ``angle_feature_shape``
    (T, A[, 1]), the training harness's ``rebuild_spec`` key, adds the
    encoder's angle stream; ``kmeans_loss`` weighs the latent head's
    k-means regulariser in training (the JAX package's fits pass
    ``CommonFitCfg.kmeans_loss``, 0 by default). Contrastive reads neither
    ``n_components`` nor ``kmeans_loss``.

    Train and eval modes differ where the encoder or decoder holds
    BatchNorm (TCN, transformer) or dropout (transformer): give a model
    its dropout draws with ``blocks.use_dropout_draws`` before a train-mode
    forward, as the fits do from their seeded device generator."""
    if model not in _MODELS:
        raise ValueError(f"Unknown model: {model}")
    dev = resolve_device(device)
    args = (tuple(input_shape), tuple(edge_feature_shape), np.asarray(adjacency), latent_dim)
    angles = tuple(angle_feature_shape) if angle_feature_shape else None
    if _MODELS[model] is Contrastive:
        net = Contrastive(*args, encoder_type, use_gnn, generator, angles)
    else:
        net = _MODELS[model](*args, n_components, encoder_type, use_gnn, generator, angles, kmeans_loss)
    return net.to(dev).train()
