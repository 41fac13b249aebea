"""Building blocks (port of deepof_tpu/models/blocks.py): the recurrent
block, the TCN, the transformer layers and their positional encoding, and
the flax semantics the JAX package's blocks carry: ``BatchNorm``,
``Dropout`` and ``MultiHeadAttention``.

Per-node streams are folded into the batch axis by the callers, so each GRU
sees one large batch. Each GRU layer (input projection, recurrence, and the
LayerNorm in front of the second BiGRU) runs in ``ops.gru_kernels.gru_scan``:
the CUDA kernel for tensors on the card, the plain loop on the CPU; in
training on the card its forward and backward kernels through
``GRULayerFunction`` (the prefix-length mask carries no gradient). GRU
weights keep the flax GRUCell form the kernel consumes: ``wi`` (F, 3H) and
``bi`` (3H,) for the input projection [r|z|n], ``wh`` (H, 3H) and ``bhn``
(H,) for the recurrent side.

The TCN's convolutions and the attention are plain PyTorch, as XLA computes
them outside any Pallas kernel in the JAX package. Train and eval modes
differ where the JAX package's ``train`` flag does: BatchNorm normalises by
the batch's statistics and moves its running ones in train mode, and
dropout draws its keep masks then, from the ``DropoutDraws`` that
:func:`use_dropout_draws` gives the model (never from torch's global RNG).
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import List, Optional, Sequence

import numpy as np

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
    and erf(2/sqrt2), mapped through sqrt(2) erfinv, on the generator's
    device."""
    bound = math.erf(2.0 / math.sqrt(2.0))
    device = None if generator is None else generator.device
    u = torch.rand(shape, generator=generator, dtype=torch.float64, device=device) * (2.0 * bound) - bound
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


@contextmanager
def run_mode(module: nn.Module, train: bool):
    """Run ``module`` in train (True) or eval mode inside the block, and
    put it back in the mode it had after."""
    was = module.training
    module.train(train)
    try:
        yield module
    finally:
        module.train(was)


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm(momentum=0.99, epsilon=1e-3)`` over the
    features on ``axis`` of its input (the last by default).

    Train mode normalises by the batch's statistics over every other axis,
    the mean and flax's fast variance E[x^2] - E[x]^2 (biased, clipped at 0),
    and moves the running ones: ``m * running + (1 - m) * batch``. Eval mode
    normalises by the running statistics. Either way y = (x - mean) *
    (rsqrt(var + eps) * weight) + bias."""

    def __init__(self, features: int, momentum: float = 0.99, eps: float = 1e-3):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, axis: int = -1) -> torch.Tensor:
        axis = axis % x.ndim
        shape = [1] * x.ndim
        shape[axis] = x.shape[axis]
        if self.training:
            dims = [d for d in range(x.ndim) if d != axis]
            mean = x.mean(dim=dims)
            var = ((x * x).mean(dim=dims) - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


class DropoutDraws:
    """The keep masks of a model's dropout layers in train mode, served in
    the order the layers run: drawn from ``generator`` (on the model's
    device) with ``torch.rand(...) < keep_prob``, or, with ``masks``, the
    masks given (another package's draws, or those an earlier forward
    recorded), each checked against the shape asked. With ``record`` every
    mask served is appended to ``recorded``."""

    def __init__(self, generator: Optional[torch.Generator] = None, masks: Optional[Sequence] = None,
                 record: bool = False):
        self.generator = generator
        self.masks = None if masks is None else list(masks)
        self.recorded: Optional[List[torch.Tensor]] = [] if record else None

    def keep(self, shape, keep_prob: float, device) -> torch.Tensor:
        if self.masks is not None:
            if not self.masks:
                raise ValueError("more dropout layers ran than masks were given")
            given = self.masks.pop(0)
            mask = torch.as_tensor(given if isinstance(given, torch.Tensor) else np.asarray(given),
                                   device=device).to(torch.bool)
            if tuple(mask.shape) != tuple(shape):
                raise ValueError(f"a given dropout mask has shape {tuple(mask.shape)}, not {tuple(shape)}")
        elif self.generator is None:
            raise RuntimeError("dropout in train mode needs a DropoutDraws with a generator "
                               "(models.blocks.use_dropout_draws)")
        else:
            mask = torch.rand(shape, generator=self.generator, device=device) < keep_prob
        if self.recorded is not None:
            self.recorded.append(mask)
        return mask


class Dropout(nn.Module):
    """flax's ``nn.Dropout(rate)``: in train mode x / (1 - rate) where the
    keep mask is set, else 0; the identity in eval mode or at rate 0. Its
    masks come from ``self.draws`` (:func:`use_dropout_draws`). With
    ``mask_shape`` one mask of that shape is broadcast over x and x is
    multiplied by keep / (1 - rate), as flax's attention applies its
    ``broadcast_dropout``."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.draws: Optional[DropoutDraws] = None

    def forward(self, x: torch.Tensor, mask_shape=None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep_prob = 1.0 - self.rate
        if self.draws is None:
            raise RuntimeError("dropout in train mode needs a DropoutDraws (models.blocks.use_dropout_draws)")
        if mask_shape is not None:
            keep = self.draws.keep(mask_shape, keep_prob, x.device)
            return x * (keep.to(x.dtype) / keep_prob)
        keep = self.draws.keep(x.shape, keep_prob, x.device)
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def use_dropout_draws(model: nn.Module, draws: Optional[DropoutDraws]) -> nn.Module:
    """Give every dropout layer of ``model`` the one source ``draws``."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.draws = draws
    return model


def set_dropout_rate(model: nn.Module, rate: float) -> nn.Module:
    """Set every dropout layer of ``model`` to ``rate`` (0 turns dropout
    off, as comparisons of two devices' train-mode steps need)."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = rate
    return model


# --------------------------------------------------------------------------- #
# The TCN
# --------------------------------------------------------------------------- #


class CausalConv(nn.Module):
    """flax's ``nn.Conv`` with a causal pad ((k - 1) * dilation, 0) over a
    (B, C, T) tensor: kernel (out, in, k) drawn normal(0.05), bias 0."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, dilation: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.pad = (kernel_size - 1) * dilation
        self.dilation = dilation
        self.weight = nn.Parameter(
            torch.randn((out_channels, in_channels, kernel_size), generator=generator) * 0.05)
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv1d(F.pad(x, (self.pad, 0)), self.weight, self.bias, dilation=self.dilation)


class TemporalBlock(nn.Module):
    """Residual TCN block over (B, C, T): (causal conv, kernel 4 -> BatchNorm
    -> ReLU) x 2, plus the input (through a 1x1 conv where the channel
    counts differ), then ReLU. Returns (out, skip), skip being the second
    ReLU's output. The models build their TCNs without dropout."""

    def __init__(self, in_channels: int, out_channels: int, dilation: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = CausalConv(in_channels, out_channels, 4, dilation, generator)
        self.bn1 = BatchNorm(out_channels)
        self.conv2 = CausalConv(out_channels, out_channels, 4, dilation, generator)
        self.bn2 = BatchNorm(out_channels)
        self.downsample = (CausalConv(in_channels, out_channels, 1, 1, generator)
                           if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor):
        y = F.relu(self.bn1(self.conv1(x), axis=1))
        y = F.relu(self.bn2(self.conv2(y), axis=1))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(y + res), y


class TCN(nn.Module):
    """Causal dilated TCN: conv_stacks x conv_dilations TemporalBlocks whose
    skips are summed, then ReLU.

    Call: x (B, T, C_in) -> (B, conv_filters), the last step, or with
    ``return_sequences`` (B, T, conv_filters)."""

    def __init__(self, in_channels: int, conv_filters: int = 32, conv_stacks: int = 2,
                 conv_dilations=(1, 2, 4, 8), return_sequences: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.return_sequences = return_sequences
        blocks, c = [], in_channels
        for _ in range(conv_stacks):
            for d in conv_dilations:
                blocks.append(TemporalBlock(c, conv_filters, int(d), generator))
                c = conv_filters
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.transpose(1, 2)
        skip_sum = None
        for block in self.blocks:
            y, skip = block(y)
            skip_sum = skip if skip_sum is None else skip_sum + skip
        out = F.relu(skip_sum)
        return out.transpose(1, 2) if self.return_sequences else out[:, :, -1]


# --------------------------------------------------------------------------- #
# Attention
# --------------------------------------------------------------------------- #


def sinusoidal_positional_encoding(max_len: int, d_model: int) -> np.ndarray:
    """Transformer positional encodings (1, max_len, d_model) float32; an odd
    d_model keeps the first d_model // 2 cosines."""
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float32) * (-np.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div_term)
    n_odd = pe[:, 1::2].shape[1]
    pe[:, 1::2] = np.cos(position * div_term)[:, :n_odd]
    return pe[None]


def positional_encoding(t: int, d_model: int, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(sinusoidal_positional_encoding(t, d_model), dtype=like.dtype, device=like.device)


class MultiHeadAttention(nn.Module):
    """flax's ``MultiHeadDotProductAttention`` as the JAX package's layers use
    it: self-attention without biases over ``features`` in and out, kernels
    ``query`` / ``key`` / ``value`` (features, heads, head_dim) and ``out``
    (heads, head_dim, features), LeCun-normal over their contracted axes;
    the query scaled by
    1 / sqrt(head_dim); logits where ``mask`` is False set to float32's
    most negative finite value (not -inf: a row with no key left attends
    uniformly); softmax; dropout of the weights with one (T, T) keep mask
    shared by the batch and the heads (flax's ``broadcast_dropout``)."""

    def __init__(self, features: int, num_heads: int, dropout_rate: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        h, d = num_heads, features // num_heads
        self.num_heads, self.head_dim = h, d
        self.query = nn.Parameter(lecun_normal((features, h, d), features, generator))
        self.key = nn.Parameter(lecun_normal((features, h, d), features, generator))
        self.value = nn.Parameter(lecun_normal((features, h, d), features, generator))
        self.out = nn.Parameter(lecun_normal((h, d, features), h * d, generator))
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x (B, T, features), mask broadcastable to (B, heads, T, T), True
        where a query may attend to a key -> (B, T, features)."""
        b, t, _ = x.shape
        h, d = self.num_heads, self.head_dim
        q = (x @ self.query.flatten(1)).view(b, t, h, d) / math.sqrt(d)
        k = (x @ self.key.flatten(1)).view(b, t, h, d)
        v = (x @ self.value.flatten(1)).view(b, t, h, d)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
        weights = self.dropout(torch.softmax(logits, dim=-1), mask_shape=(1, 1, t, t))
        y = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        return y.reshape(b, t, h * d) @ self.out.flatten(0, 1)


class TransformerEncoderLayer(nn.Module):
    """Post-norm encoder layer: x = LN(x + drop(attn(x))), then
    LN(x + drop(Dense(ReLU(Dense(x))))); LayerNorm eps 1e-6.

    Call: x (B, T, key_dim), valid (B, T) (False on padding frames, which no
    query attends to)."""

    def __init__(self, key_dim: int, num_heads: int, dff: int, rate: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.attn = MultiHeadAttention(key_dim, num_heads, rate, generator)
        self.drop1 = Dropout(rate)
        self.norm1 = nn.LayerNorm(key_dim, eps=1e-6)
        self.ff1 = Dense(key_dim, dff, generator)
        self.ff2 = Dense(dff, key_dim, generator)
        self.drop2 = Dropout(rate)
        self.norm2 = nn.LayerNorm(key_dim, eps=1e-6)

    def forward(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x + self.drop1(self.attn(x, valid[:, None, None, :])))
        return self.norm2(x + self.drop2(self.ff2(F.relu(self.ff1(x)))))


class CausalSelfAttentionLayer(nn.Module):
    """Pre-norm causal layer of the transformer decoder: x = x +
    drop(attn(LN(x))), then x + drop(Dense(drop(GELU(Dense(LN(x)))))), GELU
    exact, LayerNorm eps 1e-6."""

    def __init__(self, d_model: int, num_heads: int, dff: int, rate: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.norm1 = nn.LayerNorm(d_model, eps=1e-6)
        self.attn = MultiHeadAttention(d_model, num_heads, rate, generator)
        self.drop1 = Dropout(rate)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-6)
        self.ff1 = Dense(d_model, dff, generator)
        self.drop2 = Dropout(rate)
        self.ff2 = Dense(dff, d_model, generator)
        self.drop3 = Dropout(rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = x.shape[1]
        causal = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()[None, None]
        x = x + self.drop1(self.attn(self.norm1(x), causal))
        return x + self.drop3(self.ff2(self.drop2(F.gelu(self.ff1(self.norm2(x))))))
