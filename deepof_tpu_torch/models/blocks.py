"""Recurrent building blocks (port of deepof_tpu/models/blocks.py).

Per-node streams are folded into the batch axis by the callers, so each GRU
sees one large batch. Each GRU layer (input projection, recurrence, and the
LayerNorm in front of the second BiGRU) runs in ``ops.gru_kernels.gru_scan``:
the CUDA kernel for tensors on the card, the plain loop on the CPU; in
training on the card its forward and backward kernels through
``GRULayerFunction`` (the prefix-length mask carries no gradient). GRU
weights keep the flax GRUCell form the kernel consumes: ``wi`` (F, 3H) and
``bi`` (3H,) for the input projection [r|z|n], ``wh`` (H, 3H) and ``bhn``
(H,) for the recurrent side.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from deepof_tpu_torch.ops.gru_kernels import gru_scan


# Standard deviation of a unit normal truncated at +-2: flax's variance
# scaling divides by it so that the truncated draw keeps the variance asked.
_TRUNC_STD = 0.87962566103423978


def lecun_normal(shape, fan_in: int, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Flax's ``lecun_normal``: a normal truncated at +-2 standard deviations
    and rescaled by 1 / 0.8796, std fan_in**-0.5. Drawn by inverse CDF, as
    ``jax.random.truncated_normal`` draws it: a uniform between erf(-2/sqrt2)
    and erf(2/sqrt2), mapped through sqrt(2) erfinv."""
    bound = math.erf(2.0 / math.sqrt(2.0))
    u = torch.rand(shape, generator=generator, dtype=torch.float64) * (2.0 * bound) - bound
    z = (math.sqrt(2.0) * torch.erfinv(u)).clamp(-2.0, 2.0)
    return (z * ((1.0 / max(fan_in, 1)) ** 0.5 / _TRUNC_STD)).float()


def xavier_normal(shape, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Flax's ``xavier_normal`` on a 2-D (fan_in, fan_out) parameter:
    ``variance_scaling(1, "fan_avg", "truncated_normal")``, the same
    truncated draw as :func:`lecun_normal` at variance 2 / (fan_in + fan_out)."""
    return lecun_normal(shape, (shape[0] + shape[1]) / 2.0, generator)


def orthogonal(rows: int, cols: int, generator: Optional[torch.Generator]) -> torch.Tensor:
    q, r = torch.linalg.qr(torch.randn(max(rows, cols), min(rows, cols), generator=generator))
    q = q * torch.sign(torch.diagonal(r))
    return q if rows >= cols else q.T


class Dense(nn.Module):
    """Affine layer with a seeded LeCun-normal weight (out, in) and zero bias."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(lecun_normal((out_features, in_features), in_features, generator))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


def frame_validity_mask(x: torch.Tensor) -> torch.Tensor:
    """(..., T, F) -> (..., T): True where the frame has any nonzero feature."""
    return (x != 0.0).any(dim=-1)


class MaskedGRU(nn.Module):
    """Unidirectional GRU with masked carry: invalid steps keep the hidden
    state and output zeros (packing with trailing padding)."""

    def __init__(self, in_features: int, hidden_size: int, reverse: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        h = hidden_size
        self.hidden_size = h
        self.reverse = reverse
        self.wi = nn.Parameter(lecun_normal((in_features, 3 * h), in_features, generator))
        self.bi = nn.Parameter(torch.zeros(3 * h))
        self.wh = nn.Parameter(torch.cat([orthogonal(h, h, generator) for _ in range(3)], dim=1))
        self.bhn = nn.Parameter(torch.zeros(h))

    def forward(self, x: torch.Tensor, mask: torch.Tensor):
        """x (B, T, F), mask (B, T) -> (outputs (B, T, H), final (B, H))."""
        return gru_scan(x, mask, self.wi[None], self.bi[None], self.wh[None], self.bhn[None], (self.reverse,))


class BiGRU(nn.Module):
    """Bidirectional masked GRU, concat merge. Both directions' input
    projections and recurrences run in one kernel launch."""

    def __init__(self, in_features: int, hidden_size: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fwd = MaskedGRU(in_features, hidden_size, False, generator)
        self.bwd = MaskedGRU(in_features, hidden_size, True, generator)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, norm=None, outputs: bool = True):
        """Returns (outputs (B, T, 2H) or None, final (B, 2H)); ``norm`` and
        ``outputs`` as in :func:`gru_scan`."""
        wi = torch.stack([self.fwd.wi, self.bwd.wi])
        bi = torch.stack([self.fwd.bi, self.bwd.bi])
        wh = torch.stack([self.fwd.wh, self.bwd.wh])
        bhn = torch.stack([self.fwd.bhn, self.bwd.bhn])
        return gru_scan(x, mask, wi, bi, wh, bhn, (False, True), norm, outputs)


class RecurrentBlock(nn.Module):
    """Conv1D(k=5) -> ReLU -> BiGRU(2d) -> LN -> BiGRU(d) final state -> LN
    [-> Dense(2*latent) when d != latent], d = min(64, latent).

    One temporal summary vector (B, 2*latent) per stream.
    """

    def __init__(self, in_features: int, latent_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d = min(64, latent_dim)
        self.latent_dim = latent_dim
        self.conv_weight = nn.Parameter(lecun_normal((2 * d, in_features, 5), 5 * in_features, generator))
        self.gru1 = BiGRU(2 * d, 2 * d, generator)
        # flax LayerNorm epsilon (blocks.py:141,143), not PyTorch's 1e-5.
        self.norm1 = nn.LayerNorm(4 * d, eps=1e-3)
        self.gru2 = BiGRU(4 * d, d, generator)
        self.norm2 = nn.LayerNorm(2 * d, eps=1e-3)
        self.proj = Dense(2 * d, 2 * latent_dim, generator) if d != latent_dim else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, T, F) -> (B, 2*latent)."""
        y = F.relu(F.conv1d(x.transpose(1, 2), self.conv_weight, padding=2)).transpose(1, 2)
        # The packed length counts steps whose post-ReLU conv channels are
        # not all zero, and packing keeps a PREFIX of that length wherever
        # the zeros fell (blocks.py:130-139). A length can be 0.
        lengths = (y > 0).any(dim=-1).sum(dim=1)
        mask = torch.arange(y.shape[1], device=y.device)[None, :] < lengths[:, None]
        y, _ = self.gru1(y.contiguous(), mask)
        # norm1 runs inside gru2's kernel, on the rows it stages; only the
        # final carries are written.
        norm1 = (self.norm1.weight, self.norm1.bias, self.norm1.eps)
        _, final = self.gru2(y, mask, norm=norm1, outputs=False)
        final = self.norm2(final)
        return final if self.proj is None else self.proj(final)


def rms_stabilize(x: torch.Tensor) -> torch.Tensor:
    """Per-sample RMS normalisation and clamp around encoder outputs."""
    rms = torch.sqrt((x * x).mean(dim=-1, keepdim=True))
    x = (x / rms.clamp(min=1.0)).clamp(-1e4, 1e4)
    return torch.nan_to_num(x, nan=0.0, posinf=1e4, neginf=-1e4)


def tf_style_group_reshape(x: torch.Tensor) -> torch.Tensor:
    """(B, T, G, F) -> (B, G, T, F) stream split used by the encoders."""
    return x.transpose(1, 2)
