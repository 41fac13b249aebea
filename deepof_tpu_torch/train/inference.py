"""Embeddings and soft counts for every stride-1 window of a recording
(port of deepof_tpu/train/inference.py:204 ``scanned_windowed_forward``).

Windows never exist on the host: the scaled (T, F) frame goes to the
device once, and for each block of ``block`` windows one launch of the
window kernel writes the encoder's node and edge streams straight from the
frame's rows, which ``forward_streams`` runs through the encoder.

The JAX version rounds the number of blocks up to a power of two so that
recordings of other lengths reuse one compiled program; PyTorch runs
eagerly, so this port runs exactly ceil(n_windows / block) blocks.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np
import torch
from torch import nn

from deepof_tpu_torch.device import resolve_device, to_device
from deepof_tpu_torch.ops.window_kernels import window_streams


@dataclass
class ModelBundle:
    """A model and the spec it was built from (``rebuild_spec["model"]``,
    ``["input_shape"]``, ...), the minimal counterpart of the JAX package's
    ModelBundle for serving."""

    model: nn.Module
    rebuild_spec: Dict = field(default_factory=dict)


def stream_tables(layout: Dict, use_gnn: bool = True):
    """The window kernel's column tables for the encoder's streams: node n's
    (x, y, speed) columns (N, 3) and edge e's column (E, 1); without the GNN
    the one flat stream's columns (1, 3N), node-major as
    ``x.reshape(b, t, n * 3)`` orders them."""
    node = np.asarray(layout["node"], np.int32).reshape(3, -1).T
    if not use_gnn:
        return [node.reshape(1, -1)]
    return [node, np.asarray(layout["edge"], np.int32)[:, None]]


def scanned_windowed_forward(
    bundle: ModelBundle,
    feats,
    layout: Dict,
    window: int,
    model_name: str,
    block: int = 1024,
    device="cuda",
):
    """Embeddings + soft counts for all stride-1 windows of one recording.

    Args:
        bundle: the model (on ``device``) and its rebuild spec.
        feats: (T, F) scaled per-frame features, numpy or tensor.
        layout: {"node": idx, "edge": idx, "angle": idx-or-None} column
            indices into F; node indices in x-block, y-block, speed-block
            order.
        window: model window size.
        model_name: "VQVAE" (the serving model of this slice).
        block: windows per encoder call (compute / memory granularity).

    Returns:
        (embeddings (W, D) float32 numpy, soft_counts (W, K) float32 numpy),
        W = T - window + 1.
    """
    if model_name != "VQVAE":
        raise NotImplementedError(
            f"model {model_name!r}: VaDE and Contrastive come with ROADMAP queue 1 item 8"
        )
    if layout.get("angle") is not None:
        raise NotImplementedError("the angle stream comes with ROADMAP queue 1 item 8")
    dev = resolve_device(device)
    model = bundle.model
    for p in model.parameters():
        if p.device != dev:
            raise ValueError(f"model parameters are on {p.device}, not on {dev}")

    feats = to_device(feats, dev, torch.float32)
    t, f = feats.shape
    n_windows = t - window + 1
    if n_windows <= 0:
        return np.zeros((0, 1), np.float32), None
    block = min(block, max(64, 1 << (n_windows - 1).bit_length()))
    n_blocks = -(-n_windows // block)
    rows_per_block = block + window - 1
    padded = feats.new_zeros((n_blocks * block + window - 1, f))
    padded[:t] = feats

    tables = stream_tables(layout, model.encoder.use_gnn)
    zeros = feats.new_zeros(f)
    ones = feats.new_ones(f)

    embs, scs = [], []
    with torch.inference_mode():
        for i in range(n_blocks):
            rows = padded[i * block:i * block + rows_per_block]
            # (block*N, W, 3) and (block*E, W, 1), from one launch.
            xg, *ag = window_streams(rows, tables, zeros, ones, window)
            out = model.forward_streams(xg, ag[0] if ag else None)
            embs.append(out["encoder_output"])
            scs.append(out["soft_counts"])
    embs = torch.cat(embs)[:n_windows]
    scs = torch.cat(scs)[:n_windows]
    return embs.cpu().numpy(), scs.cpu().numpy()
