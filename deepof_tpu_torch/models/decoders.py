"""The recurrent sequence decoder and its masked-Normal reconstruction head
(port of deepof_tpu/models/decoders.py: ``MaskedNormal`` :31-62,
``ProbabilisticHead`` :65-77, ``_validity_from_target`` :80-84,
``RecurrentDecoder`` :87-112). The TCN and transformer decoders come with
their encoders (ROADMAP queue 1, item 8).

The decoder runs only in training (and in the evaluation of a training
epoch); its two BiGRUs go through ``ops.gru_kernels.gru_scan`` like the
encoder's, under the target's frame-validity mask, which may be any mask,
not a prefix.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from deepof_tpu_torch.models.blocks import BiGRU, Dense, frame_validity_mask, lecun_normal

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
