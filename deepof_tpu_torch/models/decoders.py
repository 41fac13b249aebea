"""Sequence decoders and their masked-Normal reconstruction head (port of
deepof_tpu/models/decoders.py: ``MaskedNormal`` :31-62, ``ProbabilisticHead``
:65-77, ``_validity_from_target`` :80-84, ``RecurrentDecoder`` :87-112,
``TCNDecoder`` :115, ``TransformerDecoder`` :154).

The decoders run only in training (and in the evaluation of a training
epoch). The recurrent decoder's two BiGRUs go through
``ops.gru_kernels.gru_scan`` like the encoder's, under the target's
frame-validity mask, which may be any mask, not a prefix; the TCN and
transformer decoders expand the latent to every step of the window.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from deepof_tpu_torch.models.blocks import (
    TCN,
    BatchNorm,
    BiGRU,
    CausalSelfAttentionLayer,
    Dense,
    frame_validity_mask,
    lecun_normal,
    positional_encoding,
    rms_stabilize,
)

_LOG_2PI = math.log(2.0 * math.pi)


@dataclass
class MaskedNormal:
    """Diagonal unit-variance Normal over frames with a validity mask.

    Attributes:
        loc: (B, T, D) means.
        mask: (B, T) frame validity, 1.0 where valid.
    """

    loc: torch.Tensor
    mask: torch.Tensor

    @property
    def mean(self) -> torch.Tensor:
        return self.loc * self.mask[..., None]

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T) log-probabilities; masked frames contribute 0."""
        per_dim = -0.5 * (_LOG_2PI + (x - self.loc) ** 2)
        return per_dim.sum(dim=-1) * self.mask


class ProbabilisticHead(nn.Module):
    """Dense projection to per-frame means, then a MaskedNormal. Non-finite
    means become 0 / +-1e6 (and pass no gradient, as ``jnp.nan_to_num``)."""

    def __init__(self, in_features: int, data_dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dense = Dense(in_features, data_dim, generator)

    def forward(self, hidden: torch.Tensor, validity_mask: torch.Tensor) -> MaskedNormal:
        loc = torch.nan_to_num(self.dense(hidden), nan=0.0, posinf=1e6, neginf=-1e6)
        return MaskedNormal(loc=loc, mask=validity_mask.to(loc.dtype))


def validity_from_target(x: torch.Tensor) -> torch.Tensor:
    """(B, T, D) or (B, T, N, F) target -> (B, T) frame validity."""
    if x.ndim == 4:
        x = x.reshape(x.shape[0], x.shape[1], -1)
    return frame_validity_mask(x)


class RecurrentDecoder(nn.Module):
    """RepeatVector -> BiGRU(latent) -> LN -> BiGRU(2 latent) -> LN ->
    Conv1D(k=5, SAME, no bias) -> ReLU -> LN -> masked Normal head
    (LayerNorm eps 1e-3, flax's).

    Call: g (B, latent), x_target (B, T, D) or (B, T, N, F) -> MaskedNormal
    over (B, T, output_dim).
    """

    def __init__(self, output_dim: int, latent_dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.gru1 = BiGRU(latent_dim, latent_dim, generator)
        self.norm1 = nn.LayerNorm(2 * latent_dim, eps=1e-3)
        self.gru2 = BiGRU(2 * latent_dim, 2 * latent_dim, generator)
        self.norm2 = nn.LayerNorm(4 * latent_dim, eps=1e-3)
        self.conv_weight = nn.Parameter(
            lecun_normal((2 * latent_dim, 4 * latent_dim, 5), 5 * 4 * latent_dim, generator)
        )
        self.norm3 = nn.LayerNorm(2 * latent_dim, eps=1e-3)
        self.head = ProbabilisticHead(2 * latent_dim, output_dim, generator)

    def forward(self, g: torch.Tensor, x_target: torch.Tensor) -> MaskedNormal:
        if x_target.ndim == 4:
            x_target = x_target.reshape(x_target.shape[0], x_target.shape[1], -1)
        t = x_target.shape[1]
        mask = validity_from_target(x_target)
        h = g[:, None, :].expand(-1, t, -1).contiguous()
        h, _ = self.gru1(h, mask)
        h, _ = self.gru2(self.norm1(h), mask)
        # The conv reads a standard (B, C, T) tensor: a channels-last view
        # sends cuDNN down an NHWC route with an output transpose.
        h = F.conv1d(self.norm2(h).transpose(1, 2).contiguous(), self.conv_weight, padding=2)
        h = self.norm3(F.relu(h).transpose(1, 2))
        return self.head(h, mask)


class TCNDecoder(nn.Module):
    """Dense(L) -> BN -> Dense(2L) -> ReLU -> BN -> Dense(4L) -> ReLU -> BN
    (on the RMS-guarded latent) -> repeated over the window -> causal TCN
    (64 filters, kernel 4, dilations (8, 4, 2, 1), every step) -> masked
    Normal head."""

    def __init__(self, output_dim: int, window_size: int, latent_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.window_size = window_size
        self.dense0 = Dense(latent_dim, latent_dim, generator)
        self.bn0 = BatchNorm(latent_dim)
        self.dense1 = Dense(latent_dim, 2 * latent_dim, generator)
        self.bn1 = BatchNorm(2 * latent_dim)
        self.dense2 = Dense(2 * latent_dim, 4 * latent_dim, generator)
        self.bn2 = BatchNorm(4 * latent_dim)
        self.tcn = TCN(4 * latent_dim, 64, 1, (8, 4, 2, 1), return_sequences=True, generator=generator)
        self.head = ProbabilisticHead(64, output_dim, generator)

    def forward(self, g: torch.Tensor, x_target: torch.Tensor) -> MaskedNormal:
        mask = validity_from_target(x_target)
        z = self.bn0(self.dense0(rms_stabilize(g)))
        z = self.bn1(F.relu(self.dense1(z)))
        z = self.bn2(F.relu(self.dense2(z)))
        h = self.tcn(z[:, None, :].expand(-1, self.window_size, -1))
        return self.head(h, mask)


class TransformerDecoder(nn.Module):
    """Dense(L) -> GELU -> Dense(2L) -> GELU -> Dense(d_model = 4L) -> GELU
    (exact GELUs) -> repeated over the window + positional encoding ->
    causal self-attention layers (2, dff 128, dropout 0.2; 8 heads halved
    until they divide d_model) -> Dense -> masked Normal head."""

    def __init__(self, output_dim: int, window_size: int, latent_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d_model, num_heads = 4 * latent_dim, 8
        while num_heads > 1 and d_model % num_heads:
            num_heads //= 2
        self.window_size, self.d_model = window_size, d_model
        self.dense0 = Dense(latent_dim, latent_dim, generator)
        self.dense1 = Dense(latent_dim, 2 * latent_dim, generator)
        self.dense2 = Dense(2 * latent_dim, d_model, generator)
        self.layers = nn.ModuleList(
            [CausalSelfAttentionLayer(d_model, num_heads, 128, 0.2, generator) for _ in range(2)])
        self.out = Dense(d_model, output_dim, generator)
        self.head = ProbabilisticHead(output_dim, output_dim, generator)

    def forward(self, g: torch.Tensor, x_target: torch.Tensor) -> MaskedNormal:
        mask = validity_from_target(x_target)
        z = F.gelu(self.dense0(g))
        z = F.gelu(self.dense1(z))
        z = F.gelu(self.dense2(z))
        h = z[:, None, :].expand(-1, self.window_size, -1)
        h = h + positional_encoding(self.window_size, self.d_model, h)
        for layer in self.layers:
            h = layer(h)
        return self.head(self.out(h), mask)


DECODERS = {"recurrent": RecurrentDecoder, "TCN": TCNDecoder, "transformer": TransformerDecoder}
