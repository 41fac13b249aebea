"""The headless part of the visualisation layer: the embedding evaluation
table (port of ``deepof_tpu/visuals.py:1134-1216``,
``return_embedding_evaluation``). No plotting library is imported; the
plots stay with the JAX package.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from deepof_tpu_torch.core.storage import get_dt
from deepof_tpu_torch.device import fetch_together, resolve_device
from deepof_tpu_torch.evaluation import compute_compactness, compute_knn_agreement, compute_separability_logreg
from deepof_tpu_torch.posthoc import Labelled, _nan_extreme


def _aligned_tags(tags: torch.Tensor, window_size: int, alignment_mode: str, n_emb: int) -> torch.Tensor:
    """A recording's (T, C) tags aligned to its embedding windows:
    "center" takes each window's central frame; "any" takes, for a binary
    column (max <= 1.0001), the window's NaN-skipping max and otherwise its
    NaN-skipping mean."""
    if alignment_mode == "center":
        center = window_size // 2
        return tags[center:center + n_emb]
    windows = tags.unfold(0, max(window_size, 1), 1)  # (T - w + 1, C, w)
    is_binary = _nan_extreme(tags, largest=True, dim=0) <= 1.0001  # an all-NaN column is not binary
    return torch.where(is_binary[None, :], _nan_extreme(windows, largest=True, dim=-1),
                       torch.nanmean(windows, dim=-1))


def return_embedding_evaluation(
    coordinates=None,
    embeddings=None,
    supervised_annotations=None,
    include_behaviors: List[str] = None,
    window_size: int = None,
    alignment_mode: str = "any",
    minimum_number_of_positives: int = 200,
    normalize: bool = True,
    random_state: int = 0,
    behaviors: List[str] = None,
    device="cuda",
) -> Labelled:
    """Compactness, separability and kNN agreement of the embeddings for
    each binary behaviour of the supervised tags.

    Each recording's tags are aligned to its embedding windows
    (``alignment_mode`` "center": the central frame; "any": a binary tag
    positive where it occurs in any frame of the window, a continuous one
    averaged), the recordings concatenated. Behaviours with fewer than
    max(``minimum_number_of_positives``, 2) positive windows are skipped;
    by default every column whose label holds neither "speed" nor
    "distance" is scored (``behaviors`` is an alias of
    ``include_behaviors``). With ``normalize``, AP and kNN agreement are
    divided by the positive rate. The old layout (embeddings first, then
    the tags, then the behaviours) is recognised.

    Returns a :class:`posthoc.Labelled`: a row a behaviour, a column a
    metric key (``compute_compactness``, ``compute_separability_logreg``,
    ``compute_knn_agreement``)."""
    if coordinates is not None and hasattr(coordinates, "keys") and not hasattr(coordinates, "_tables"):
        coordinates, embeddings, supervised_annotations, include_behaviors = (
            None, coordinates, embeddings,
            supervised_annotations if isinstance(supervised_annotations, list) else include_behaviors,
        )
    include_behaviors = include_behaviors or behaviors
    if alignment_mode not in ("any", "center"):
        raise ValueError('alignment_mode must be "any" or "center"')
    dev = resolve_device(device)

    embs, sups, columns = [], [], None
    for key in embeddings.keys():
        emb = get_dt(embeddings, key)
        emb = emb.to(dev) if isinstance(emb, torch.Tensor) else torch.as_tensor(np.asarray(emb), device=dev)
        tags = get_dt(supervised_annotations, key)
        columns = list(get_dt(supervised_annotations, key, only_metainfo=True)["columns"]
                       or range(np.shape(tags)[1]))
        tags = torch.as_tensor(np.asarray(tags, np.float64), device=dev)
        if window_size is None:
            window_size = len(tags) - len(emb) + 1
        aligned = _aligned_tags(tags, window_size, alignment_mode, len(emb))
        m = min(len(emb), len(aligned))
        embs.append(emb[:m])
        sups.append(aligned[:m])
    z = torch.cat(embs)
    sup = torch.cat(sups)
    if include_behaviors is None:
        include_behaviors = [c for c in columns if not any(s in str(c) for s in ("speed", "distance"))]

    positive = fetch_together([sup > 0.5])[0]
    rows, names = [], []
    for b in include_behaviors:
        y = positive[:, columns.index(b)]
        if y.sum() < max(minimum_number_of_positives, 2):
            continue
        row = dict(compute_compactness(z[torch.as_tensor(y, device=dev)], z, device=dev))
        row.update(compute_separability_logreg(z, y, seed=random_state, device=dev))
        row.update(compute_knn_agreement(z, y, device=dev))
        if normalize:
            rate = float(y.mean())
            for k in list(row):
                if k.startswith("ap") or "knn" in k:
                    row[k] = row[k] / rate if rate > 0 else np.nan
        rows.append(row)
        names.append(b)
    keys = list(rows[0]) if rows else []
    return Labelled(np.array([[r[k] for k in keys] for r in rows], np.float64).reshape(len(rows), len(keys)),
                    names, keys)
