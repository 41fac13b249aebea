"""Training diagnostics: soft assignments, cluster-quality metrics, the
best-score rule's alignment score, console tables and TensorBoard logging
(port of deepof_tpu/train/diagnostics.py: ``get_q`` :24,
``compute_diagnostics`` :46, ``alignment_score`` :77,
``compute_gmm_diagnostics`` :115, ``format_loss_table`` :136,
``MetricsWriter`` :150 and ``label_separation_score`` :183).

``alignment_score`` runs in float64 on the device of its input (the fit's
validation posteriors stay on the card); the other metrics are host numpy,
as in the JAX package. ``MetricsWriter`` imports ``torch.utils.tensorboard``
only when given a log directory.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def get_q(bundle, x, a, angles=None) -> np.ndarray:
    """Soft cluster assignments (B, K) of a VaDE or VQ-VAE bundle, clipped
    at 1e-8 and renormalised."""
    if bundle.rebuild_spec["model"] not in ("VaDE", "VQVAE"):
        raise ValueError(
            "Contrastive models need a fitted GMM for assignments; use "
            "deepof_tpu_torch.train.inference.embedding_per_video."
        )
    q = np.clip(_np(bundle.group(x, a, angles)), 1e-8, None)
    return q / q.sum(-1, keepdims=True)


def compute_diagnostics(q, tau_star=None) -> Dict[str, float]:
    """Confidence, balance (usage entropy over log K), populated clusters
    and, with a teacher whose rows match q's, the share of rows whose hard
    assignment equals the teacher's."""
    q = _np(q)
    k = q.shape[1]
    hard = q.argmax(1)
    out = {
        "diag/confidence": float(q.max(1).mean()),
        "diag/populated_clusters": float(len(np.unique(hard))),
    }
    usage = np.clip(q.mean(0), 1e-9, None)
    out["diag/balance"] = float(-(usage * np.log(usage)).sum() / np.log(max(k, 2)))
    if tau_star is not None and len(tau_star) == len(q):
        out["diag/teacher_alignment"] = float((hard == _np(tau_star).argmax(1)).mean())
    return out


def alignment_score(q, tau_star=None) -> Dict[str, float]:
    """The balance-and-certainty score of the best-score rule, in float64:
    conf_norm = 1 - mean entropy of q over log K; bal_norm = 1 - KL(q's
    marginal || tau_star's marginal) / log K with a teacher, else q's
    marginal entropy over log K, each clipped to [0, 1]; alignment_score =
    conf_norm * bal_norm. Only tau_star's marginal is read, so its rows need
    not be q's."""
    q = torch.as_tensor(q).to(torch.float64).clamp(min=1e-8)
    q = q / q.sum(dim=1, keepdim=True)
    log_k = math.log(max(float(q.shape[1]), 2.0))
    mean_entropy = -(q * torch.log(q)).sum(dim=1).mean()
    q_marg = q.mean(dim=0).clamp(min=1e-9)
    conf_norm = (1.0 - mean_entropy / log_k).clamp(0.0, 1.0)
    if tau_star is not None:
        tau = torch.as_tensor(tau_star).to(device=q.device, dtype=torch.float64)
        tau_marg = tau.mean(dim=0).clamp(min=1e-9)
        kl = (q_marg * (torch.log(q_marg) - torch.log(tau_marg))).sum().clamp(min=0.0)
        bal_norm = (1.0 - kl / log_k).clamp(0.0, 1.0)
    else:
        bal_norm = (-(q_marg * torch.log(q_marg)).sum() / log_k).clamp(0.0, 1.0)
    conf, bal = torch.stack([conf_norm, bal_norm]).tolist()
    return {"conf_norm": conf, "bal_norm": bal, "alignment_score": conf * bal}


def compute_gmm_diagnostics(state: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The mixture prior's log-variance range and its closest pair of means,
    from a VaDE's state dict (``latent_space.gmm_*``)."""
    if "latent_space.gmm_log_vars" not in state:
        return {}
    glv = _np(state["latent_space.gmm_log_vars"])
    means = _np(state["latent_space.gmm_means"])
    d = np.linalg.norm(means[:, None] - means[None], axis=-1)
    np.fill_diagonal(d, np.inf)
    return {"diag/gmm_logvar_min": float(glv.min()), "diag/gmm_logvar_max": float(glv.max()),
            "diag/gmm_min_center_distance": float(d.min())}


def format_loss_table(history: Dict[str, List[float]], last_n: int = 1) -> str:
    """One line a key: the mean of its last ``last_n`` values."""
    rows = []
    width = max((len(k) for k in history), default=10)
    for key in sorted(history):
        values = history[key]
        if values:
            rows.append(f"  {key:<{width}}  {np.mean(values[-last_n:]):>12.5f}")
    return "\n".join(rows)


class MetricsWriter:
    """Scalars to a TensorBoard log directory, or nowhere without one."""

    def __init__(self, logdir: Optional[str] = None):
        self._writer = None
        if logdir:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as err:
                raise ImportError(
                    "MetricsWriter(logdir) needs the tensorboard package (torch.utils.tensorboard)"
                ) from err
            self._writer = SummaryWriter(logdir)

    def log_scalars(self, metrics: Dict[str, float], step: int) -> None:
        if self._writer is not None:
            for k, v in metrics.items():
                self._writer.add_scalar(k, float(v), step)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()


def label_separation_score(embeddings, labels, pos_thr: float = 0.5, neg_thr: float = 0.5,
                           min_pos: int = 2, min_neg: int = 2, normalize_embeddings: bool = True,
                           eps: float = 1e-8) -> float:
    """For each supervised label, the squared distance between its positive
    and negative centroids over the within-class dispersion, averaged over
    the labels with enough samples, weighted by their counts.

    Args:
        embeddings: (B, H).
        labels: (B, L) or (B, 1, L) in [0, 1].
    """
    x = _np(embeddings).astype(np.float64)
    y = _np(labels).astype(np.float64)
    if y.ndim == 3 and y.shape[1] == 1:
        y = y[:, 0]
    if normalize_embeddings:
        x = x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), eps)
    pos = (y >= pos_thr).astype(np.float64)
    neg = (y <= neg_thr).astype(np.float64)
    n_pos, n_neg = pos.sum(0), neg.sum(0)
    valid = (n_pos >= min_pos) & (n_neg >= min_neg)
    if not valid.any():
        return 0.0
    mu_pos = (pos.T @ x) / (n_pos[:, None] + eps)
    mu_neg = (neg.T @ x) / (n_neg[:, None] + eps)
    between = ((mu_pos - mu_neg) ** 2).sum(1)
    x2 = (x ** 2).sum(1)
    within = (np.clip(pos.T @ x2 - n_pos * (mu_pos ** 2).sum(1), 0, None)
              + np.clip(neg.T @ x2 - n_neg * (mu_neg ** 2).sum(1), 0, None)) / (n_pos + n_neg + eps)
    per_label = between / (within + eps)
    weights = n_pos + n_neg
    return float((per_label[valid] * weights[valid]).sum() / (weights[valid].sum() + eps))
