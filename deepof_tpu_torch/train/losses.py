"""The contrastive losses and the VaDE loss (port of
deepof_tpu/train/losses.py: the similarity matrices and the nce / dcl / fc /
hard-dcl losses with ``select_contrastive_loss`` :34-148;
``cluster_frequencies_regularizer``, ``VadeLossParams``, ``vade_loss`` and
``vade_params_from_cfg`` :162-450).

The composite loss: the masked-Normal reconstruction NLL; the KL to N(0, I)
in pretrain and a 32-sample Monte-Carlo KL to the GMM prior in the main
phase; k-means, activity L1, repel and non-empty terms; and in the main
phase the tf-cluster, prior, cluster-frequency, temporal-cohesion and
scatter terms, with the JAX package's clips and stop-gradients
(``.detach()``). ``torch.clamp`` passes no gradient below a clip, as
``jnp.clip``; the two differ only at exact ties.

The teacher-distillation term waits for the TURTLE teacher (ROADMAP queue 1
item 14): without a teacher the JAX package's step runs it on zero
assignments at weight 0, so it is exactly 0, and here ``distill_loss`` is 0.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

_LOG_2PI = math.log(2.0 * math.pi)


# --------------------------------------------------------------------------- #
# Similarities and contrastive losses
# --------------------------------------------------------------------------- #


def cosine_similarity_matrix(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    xn = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-8)
    yn = y / torch.linalg.vector_norm(y, dim=-1, keepdim=True).clamp(min=1e-8)
    return xn @ yn.T


def dot_similarity_matrix(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return x @ y.T


def euclidean_similarity_matrix(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    d2 = ((x[:, None] - y[None]) ** 2).sum(dim=-1)
    return 1.0 / (1.0 + torch.sqrt(d2.clamp(min=0.0)))


SIMILARITIES: Dict[str, Callable] = {
    "cosine": cosine_similarity_matrix,
    "dot": dot_similarity_matrix,
    "euclidean": euclidean_similarity_matrix,
    "edit": euclidean_similarity_matrix,
}


def _off_diagonal(sim: torch.Tensor) -> torch.Tensor:
    """Each row's off-diagonal entries, (N, N - 1)."""
    n = sim.shape[0]
    return sim.reshape(-1)[:-1].reshape(n - 1, n + 1)[:, 1:].reshape(n, n - 1)


def nce_loss(history, future, similarity, temperature=0.1):
    """InfoNCE with in-batch negatives. -> (loss, mean positive similarity,
    mean negative similarity)."""
    sim = similarity(history, future) / temperature
    loss = -torch.diagonal(torch.log_softmax(sim, dim=1)).mean()
    return loss, torch.diagonal(sim).mean() * temperature, _off_diagonal(sim * temperature).mean()


def dcl_loss(history, future, similarity, temperature=0.1, debiased=True, tau_plus=0.1):
    """Debiased contrastive loss (Chuang et al. 2020)."""
    n = history.shape[0]
    sim = similarity(history, future)
    pos = torch.exp(torch.diagonal(sim) / temperature)
    neg_raw = _off_diagonal(sim)
    neg = torch.exp(neg_raw / temperature)
    if debiased:
        n_eff = n - 1
        ng = (-tau_plus * n_eff * pos + neg.sum(-1)) / (1.0 - tau_plus)
        ng = ng.clamp(min=n_eff * math.e ** (-1.0 / temperature))
    else:
        ng = neg.sum(-1)
    loss = (-torch.log(pos / (pos + ng))).mean()
    return loss, torch.diagonal(sim).mean(), neg_raw.mean()


def fc_loss(history, future, similarity, temperature=0.1, elimination_topk=0.1):
    """False-negative elimination: each row's k most similar negatives
    dropped."""
    n = history.shape[0]
    k = max(1, int(math.ceil(min(elimination_topk, 0.5) * n)))
    sim = similarity(history, future) / temperature
    pos = torch.exp(torch.diagonal(sim))
    neg_raw = _off_diagonal(sim)
    keep = max((n - 1) - k, 0)
    trimmed = torch.sort(neg_raw, dim=1).values[:, :keep]
    neg_sum = torch.exp(trimmed).sum(-1) if keep > 0 else sim.new_zeros(n)
    loss = (-torch.log(pos / (pos + neg_sum))).mean()
    mean_neg = trimmed.mean() * temperature if keep > 0 else sim.new_zeros(())
    return loss, torch.diagonal(sim).mean() * temperature, mean_neg


def hard_loss(history, future, similarity, temperature=0.1, beta=0.0, debiased=True, tau_plus=0.1):
    """Hard-negative reweighted DCL (Robinson et al. 2021)."""
    n = history.shape[0]
    sim = similarity(history, future)
    pos = torch.exp(torch.diagonal(sim) / temperature)
    neg_raw = _off_diagonal(sim)
    neg = torch.exp(neg_raw / temperature)
    reweight = torch.ones_like(neg) if beta == 0.0 else (beta * neg) / neg.mean(dim=1, keepdim=True)
    if debiased:
        n_eff = n - 1
        ng = (-tau_plus * n_eff * pos + (reweight * neg).sum(-1)) / (1.0 - tau_plus)
        ng = ng.clamp(min=math.e ** (-1.0 / temperature))
    else:
        ng = neg.sum(-1)
    loss = (-torch.log(pos / (pos + ng))).mean()
    return loss, torch.diagonal(sim).mean(), neg_raw.mean()


def select_contrastive_loss(history, future, similarity: str = "cosine", loss_fn: str = "nce",
                            temperature: float = 0.1, tau: float = 0.1, beta: float = 0.1,
                            elimination_topk: float = 0.1):
    """(loss, mean positive, mean negative similarity) of ``loss_fn`` ("nce",
    "dcl", "fc", "hard_dcl") under ``similarity`` ("cosine", "dot",
    "euclidean" or "edit", the same)."""
    sim_fn = SIMILARITIES[similarity]
    if loss_fn == "nce":
        return nce_loss(history, future, sim_fn, temperature)
    if loss_fn == "dcl":
        return dcl_loss(history, future, sim_fn, temperature, True, tau)
    if loss_fn == "fc":
        return fc_loss(history, future, sim_fn, temperature, elimination_topk)
    if loss_fn == "hard_dcl":
        return hard_loss(history, future, sim_fn, temperature, beta, True, tau)
    raise ValueError(f"Unknown loss_fn: {loss_fn}")


def cluster_frequencies_regularizer(soft_counts: torch.Tensor) -> torch.Tensor:
    """KL(uniform || mean cluster usage)."""
    mean_freq = soft_counts.mean(dim=0)
    k = soft_counts.shape[1]
    return torch.sum((1.0 / k) * (math.log(1.0 / k) - torch.log(mean_freq + 1e-9)))


@dataclass(frozen=True)
class VadeLossParams:
    """Static weights of the VaDE loss for one phase (pretrain or main)."""

    n_components: int
    l1_activity_weight: float = 0.1
    tf_cluster_weight: float = 0.0
    reg_cat_clusters_weight: float = 0.0
    temporal_cohesion_weight: float = 0.0
    reg_scatter_weight: float = 0.0
    reg_scatter_beta: float = 1.0
    kmeans_loss_weight: float = 0.0
    repel_weight: float = 0.0
    repel_length_scale: float = 1.0
    nonempty_weight: float = 0.0
    nonempty_floor: float = 1e-4
    nonempty_p: int = 2
    pretrain_mode: bool = True
    distill_sharpen_T: float = 0.5
    distill_conf_weight: bool = False
    distill_conf_thresh: float = 0.3
    gmm_logvar_clamp: Tuple[float, float] = (-8.0, 8.0)
    mc_kl_samples: int = 32


def _log_normal_diag(x, mean, log_var):
    return -0.5 * torch.sum(_LOG_2PI + log_var + (x - mean) ** 2 * torch.exp(-log_var), dim=-1)


def kl_noise(z_mean: torch.Tensor, params: VadeLossParams,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The Monte-Carlo KL's standard-normal draws, (S, B, D)."""
    return torch.randn((params.mc_kl_samples,) + tuple(z_mean.shape), generator=generator,
                       device=z_mean.device, dtype=z_mean.dtype)


def _monte_carlo_kl(eps, z_mean, z_log_var, gmm_means, gmm_log_vars, prior, params):
    z_log_var = z_log_var.clamp(-4.0, 4.0)
    scale_q = torch.exp(0.5 * z_log_var)
    z = z_mean[None] + eps * scale_q[None]
    log_q = _log_normal_diag(z, z_mean[None], z_log_var[None])

    glv = gmm_log_vars.clamp(*params.gmm_logvar_clamp)
    log_prior = torch.log(prior.clamp(min=1e-8))
    log_p_zc = _log_normal_diag(z[:, :, None, :], gmm_means[None, None], glv[None, None])
    log_p = torch.logsumexp(log_prior[None, None] + log_p_zc, dim=-1)
    return (log_q - log_p).mean().clamp(min=0.0)


def vade_loss(
    outputs: Dict,
    x_original: torch.Tensor,
    params: VadeLossParams,
    kl_weight: float,
    eps: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, torch.Tensor]:
    """The composite VaDE loss of one batch.

    Args:
        outputs: ``VaDE.training_forward``'s dict.
        x_original: (B, T, N, F) input windows.
        params: the phase's static weights.
        kl_weight: the scheduled KL weight.
        eps: (S, B, D) standard-normal draws for the main phase's
            Monte-Carlo KL; drawn from ``generator`` when not given.

    Returns:
        {"total_loss", "reconstruct_loss", "kl_div", "kl_weight", ...}: the
        JAX package's keys.
    """
    q = outputs["categorical"]
    latent_z = outputs["latent"]
    z_mean = outputs["z_mean"]
    z_log_var = outputs["z_log_var"]
    gmm = outputs["gmm_params"]
    zero = z_mean.new_zeros(())

    b, t = x_original.shape[:2]
    reconstruction_loss = -outputs["reconstruction"].log_prob(x_original.reshape(b, t, -1)).mean()

    q = q.clamp(min=1e-8)
    q = q / q.sum(-1, keepdim=True)

    activity_l1 = params.l1_activity_weight * torch.abs(z_log_var).sum(-1).mean()
    z_log_var_c = z_log_var.clamp(-4.0, 2.0)

    if params.pretrain_mode:
        kl_vec = 0.5 * torch.sum(z_mean ** 2 + torch.exp(z_log_var_c) - 1.0 - z_log_var_c, dim=-1) / z_log_var_c.shape[-1]
        kl_batch = kl_weight * kl_vec.mean()
    else:
        if eps is None:
            eps = kl_noise(z_mean, params, generator)
        kl_batch = kl_weight * _monte_carlo_kl(eps, z_mean, z_log_var_c, gmm["means"], gmm["log_vars"],
                                               gmm["prior"], params)

    kmeans_term = params.kmeans_loss_weight * outputs["kmeans_loss"]

    # Repel: RBF kernel between soft centroids.
    repel_loss = zero
    if params.repel_weight > 0.0:
        qf = q.detach()
        pi_b = qf.sum(0).clamp(min=1e-8)
        means = (qf.T @ latent_z) / pi_b[:, None]
        d2 = torch.sum((means[:, None] - means[None]) ** 2, dim=-1)
        kmat = torch.exp(-d2 / max(1e-9, 2.0 * params.repel_length_scale ** 2))
        kmat = kmat - torch.diag(torch.diag(kmat))
        c = means.shape[0]
        repel_loss = params.repel_weight * kmat.sum() / max(1, c * c - c)

    # Non-empty: penalise clusters used less than the floor.
    nonempty_loss = zero
    if params.nonempty_weight > 0.0:
        underuse = (params.nonempty_floor - q.mean(0)).clamp(min=0.0)
        nonempty_loss = params.nonempty_weight * torch.sum(underuse ** params.nonempty_p)

    tf_cluster = prior_loss = cat_cluster_loss = temporal_loss = scatter_loss = zero
    if not params.pretrain_mode:
        glv = gmm["log_vars"].clamp(*params.gmm_logvar_clamp)
        scale = torch.exp(0.5 * glv).clamp(min=1e-3)
        diff = latent_z[:, None] - gmm["means"][None]
        logp = -0.5 * torch.sum(torch.log(2 * math.pi * scale[None] ** 2) + (diff / scale[None]) ** 2, dim=-1)
        post_like = torch.softmax(logp, dim=-1)
        tf_cluster = -torch.mean((q * post_like).sum(-1)) * params.tf_cluster_weight

        log_pi = math.log(1.0 / max(1, params.n_components))
        prior_loss = -torch.mean((q * log_pi).sum(-1))

        if params.reg_cat_clusters_weight > 0:
            cat_cluster_loss = params.reg_cat_clusters_weight * cluster_frequencies_regularizer(q)
        if params.temporal_cohesion_weight > 0.0 and q.shape[0] > 1:
            temporal_loss = params.temporal_cohesion_weight * torch.abs(q[1:] - q[:-1]).sum(-1).mean()
        if params.reg_scatter_weight > 0.0:
            pi_b = q.sum(0).clamp(min=1e-8)
            mu = (q.T @ z_mean) / pi_b[:, None]
            diff = z_mean[:, None] - mu[None]
            scat_c = (q[..., None] * diff ** 2).sum(0) / pi_b[:, None]
            w = ((pi_b / pi_b.mean()) ** (-params.reg_scatter_beta))[:, None]
            scatter_loss = params.reg_scatter_weight * torch.mean(w * scat_c)

    total = (
        reconstruction_loss
        + kl_batch
        + cat_cluster_loss
        + temporal_loss
        + nonempty_loss
        + tf_cluster
        + prior_loss
        + kmeans_term
        + activity_l1
        + scatter_loss
        + repel_loss
    )
    return {
        "total_loss": total,
        "reconstruct_loss": reconstruction_loss,
        "kl_div": kl_batch,
        "kl_weight": z_mean.new_full((), kl_weight),  # a fill: no host copy, no stream sync
        "tf_clust_loss": tf_cluster,
        "prior_loss": prior_loss,
        "kmeans_loss": kmeans_term,
        "activity_l1": activity_l1,
        "cat_clust_loss": cat_cluster_loss,
        "distill_loss": zero,
        "nonempty_loss": nonempty_loss,
        "temporal_loss": temporal_loss,
        "scatter_loss": scatter_loss,
        "repel_loss": repel_loss,
    }


def vade_params_from_cfg(common, vade_cfg, teacher_cfg, pretrain: bool) -> VadeLossParams:
    """The per-phase static weights from the config dataclasses."""
    sfx = "_pretrain" if pretrain else ""
    return VadeLossParams(
        n_components=common.n_components,
        tf_cluster_weight=vade_cfg.tf_cluster_weight,
        reg_cat_clusters_weight=vade_cfg.reg_cat_clusters,
        temporal_cohesion_weight=vade_cfg.temporal_cohesion_weight,
        reg_scatter_weight=vade_cfg.reg_scatter_weight,
        reg_scatter_beta=vade_cfg.reg_scatter_beta,
        kmeans_loss_weight=vade_cfg.kmeans_loss_pretrain if pretrain else common.kmeans_loss,
        repel_weight=getattr(vade_cfg, "repel_weight" + sfx),
        repel_length_scale=getattr(vade_cfg, "repel_length_scale" + sfx),
        nonempty_weight=getattr(vade_cfg, "nonempty_weight" + sfx),
        nonempty_floor=max(1e-4, getattr(vade_cfg, "nonempty_floor_percent" + sfx) / common.n_components),
        nonempty_p=int(getattr(vade_cfg, "nonempty_p" + sfx)),
        pretrain_mode=pretrain,
        distill_sharpen_T=teacher_cfg.distill_sharpen_T,
        distill_conf_weight=teacher_cfg.distill_conf_weight,
        distill_conf_thresh=teacher_cfg.distill_conf_thresh,
    )
