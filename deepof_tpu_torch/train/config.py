"""Training configuration (port of deepof_tpu/train/config.py
``CommonFitCfg`` :14, ``TurtleTeacherCfg`` :47, ``VaDECfg`` :93 and
``ContrastiveCfg`` :136), with the JAX package's names and defaults.

``CommonFitCfg`` keeps the fields that the fits read.
The JAX package's other common fields are ``train_deepof_model`` arguments
(the output paths, the run number), raise there (``use_amp``), or are read
by neither fit and raise there too (``UNREAD_COMMON_FIELDS``). The teacher
config is carried whole, since the VaDE loss reads its ``distill_*``
fields; the TURTLE teacher itself raises (ROADMAP queue 1 item 14).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

# The JAX package's CommonFitCfg fields that none of its fits reads, with
# their defaults: a keyword that sets one to another value raises.
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

    kmeans_loss: float = 0.0
    seed: Optional[int] = None

    limit_train_batches: Optional[int] = 1000
    limit_val_batches: Optional[int] = 1000


@dataclass
class TurtleTeacherCfg:
    use_turtle_teacher: bool = False
    teacher_gamma: float = 8.0
    teacher_outer_steps: int = 500
    teacher_inner_steps: int = 100
    teacher_normalize_feats: bool = True

    teacher_head_temp: float = 0.35
    teacher_task_temp: float = 0.35
    teacher_alpha_sample_entropy: float = 2.0

    lambda_distill: float = 4.0
    lambda_decay_start: int = 10
    lambda_end_weight: float = 0.2
    lambda_cooldown: int = 10
    distill_sharpen_T: float = 0.5
    distill_conf_weight: bool = False
    distill_conf_thresh: float = 0.3

    generic_lambda_distill: float = 2.0
    generic_distill_sharpen_T: float = 0.5
    generic_distill_conf_weight: bool = True
    generic_distill_conf_thresh: float = 0.6
    generic_distill_warmup_epochs: int = 1

    distill_class_reweight_beta: float = 1.0
    distill_class_reweight_cap: Optional[float] = 3.0

    include_latent_view: bool = True
    include_edges_view: bool = False
    include_nodes_view: bool = True
    include_angles_view: bool = False
    pca_nodes_dim: int = 32
    pca_edges_dim: int = 32
    pca_angles_dim: int = 32
    batch_size_nodes: int = 4096
    batch_size_edges: int = 8192
    batch_size_angles: int = 8192

    teacher_refresh_every: Optional[int] = None
    teacher_freeze_at: Optional[int] = 10
    reinit_gmm_on_refresh: bool = False
    teacher_batch_size: int = 2048


@dataclass
class VaDECfg:
    learning_rate_pretrain: float = 1e-3
    gmm_learning_rate: float = 1e-3
    pretrain_epochs: int = 10

    reg_cat_clusters: float = 0.0
    recluster: bool = False
    freeze_gmm_epochs: int = 0
    freeze_decoder_epochs: int = 0
    prior_loss_weight: float = 0.0

    reg_scatter_weight: float = 0.0
    temporal_cohesion_weight: float = 0.0
    reg_scatter_beta: float = 1.0
    repel_weight: float = 0.0
    repel_length_scale: float = 1.0

    tf_cluster_weight: float = 0.0
    nonempty_weight: float = 2e-2
    nonempty_p: float = 2.0
    nonempty_floor_percent: float = 0.05

    kmeans_loss_pretrain: float = 1.0
    repel_weight_pretrain: float = 0.5
    repel_length_scale_pretrain: float = 0.5
    nonempty_weight_pretrain: float = 2e-2
    nonempty_p_pretrain: float = 2.0
    nonempty_floor_percent_pretrain: float = 0.05

    kl_annealing_mode: str = "tf_sigmoid"
    kl_max_weight: float = 1.0
    kl_warmup: int = 5
    kl_end_weight: float = 0.2
    kl_cooldown: int = 5

    kl_annealing_mode_pretrain: str = "tf_sigmoid"
    kl_max_weight_pretrain: float = 0.2
    kl_warmup_pretrain: int = 15
    kl_end_weight_pretrain: float = 0.2
    kl_cooldown_pretrain: int = 10


@dataclass
class ContrastiveCfg:
    temperature: float = 0.1
    contrastive_similarity_function: str = "cosine"
    contrastive_loss_function: str = "nce"
    beta: float = 0.1
    tau: float = 0.1
    aug_min_shift: int = 1
    aug_max_shift: int = 6
    aug_p_shift: float = 0.8
    aug_max_rot: int = 30
    aug_n_rot: int = 4
    aug_p_rot: float = 0.0
    aug_max_interp: int = 8
    aug_min_interp: int = 3
    aug_p_interp: float = 0.3
    aug_noise_sigma: float = 0.03
    aug_p_noise: float = 0.0


TEACHER = (
    "the TURTLE teacher (use_turtle_teacher, teacher_refresh_every, reinit_gmm_on_refresh) "
    "comes with ROADMAP queue 1 item 14"
)


def raise_if_teacher(teacher_cfg: TurtleTeacherCfg) -> None:
    """The TURTLE teacher is not ported: asking for it, or for its
    refreshes, raises."""
    if (teacher_cfg.use_turtle_teacher or teacher_cfg.teacher_refresh_every is not None
            or teacher_cfg.reinit_gmm_on_refresh):
        raise NotImplementedError(TEACHER)
