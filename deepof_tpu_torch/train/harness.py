"""Training harness of the VQ-VAE, VaDE and Contrastive models: the model
bundle, the optimisers, the train and evaluation steps, the epoch loop,
``fit_vqvae``, ``fit_vade``, ``extract_latents``, ``fit_contrastive``,
``train_deepof_model`` and ``deep_unsupervised_embedding`` (port of
deepof_tpu/train/harness.py: ``ModelBundle`` :75-166, ``_make_optimizer``
:187 and ``_make_vade_main_optimizer`` :210 (``ClippedAdam``),
``make_vqvae_step``, ``make_vqvae_eval_step``, ``make_vade_step``,
``make_vade_eval_step`` and ``make_contrastive_step`` :275-405,
``_epoch_mean``, ``_chain_hooks`` and ``_run_epochs`` :410-530,
``fit_vqvae`` :567-675, ``fit_vade`` :691-1006, ``extract_latents`` :1009,
``fit_contrastive`` :1031-1122, ``_dataset_from_preprocessed``
:1125-1144, ``train_deepof_model`` :1147-1324 and
``deep_unsupervised_embedding`` :1327-1367).

The JAX package jits one train step over a device mesh; here the step runs
eagerly on one device, its GRU layers (recurrent encoders) through the
fused GRU kernel and its backward kernel
(``ops.gru_kernels.GRULayerFunction``). A train step runs the model in
train mode (BatchNorm on the batch's statistics, moving the running ones;
dropout on); evaluation and latent extraction run it in eval mode, as the
JAX package runs them at ``train=False``. Every random draw of a fit
(VaDE's sampling noise, dropout's keep masks, the contrastive
augmentations) comes from one ``torch.Generator`` on the fit's device,
seeded with the fit's seed; VaDE's GMM init (``train.gmm``, or from the
TURTLE teacher's assignments, ``train.teacher``) runs there too.

With a ``checkpoint_dir`` every fit saves its model and optimiser state at
the end of every ``checkpoint_every``-th epoch (VaDE: of its main phase;
``train.checkpoint``) and a later call resumes after the latest saved
epoch: the schedules' iteration restarts at ``start_epoch * n_batches``,
the batch order and the fit's generator start from the seed again (the
JAX package draws each call's batches from ``np.random.default_rng(seed)``
and derives its key from ``PRNGKey(seed)``), so a resumed run does not draw
what an uninterrupted one would. Mixed precision and the JAX package's
flax checkpoint files raise, naming their ROADMAP queue 1 items. Bundles
are saved with ``torch.save`` (state dict with the BatchNorm running
statistics, rebuild spec, history).
"""

from __future__ import annotations

import contextlib
import os
import time
import zipfile
from dataclasses import dataclass, field, fields
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from deepof_tpu_torch.core.storage import get_dt
from deepof_tpu_torch.device import resolve_device
from deepof_tpu_torch.graph_dataset import reorder_and_reshape
from deepof_tpu_torch.models.blocks import DropoutDraws, use_dropout_draws
from deepof_tpu_torch.models.zoo import build_model
from deepof_tpu_torch.train.augment import (
    RotationPrecomp,
    build_rotation_precomp,
    make_augmented_view,
    recompute_edges,
    slice_time_per_sample,
)
from deepof_tpu_torch.train.checkpoint import TrainCheckpointer, make_epoch_checkpoint_hook, maybe_resume
from deepof_tpu_torch.train.config import (
    UNREAD_COMMON_FIELDS,
    CommonFitCfg,
    ContrastiveCfg,
    TurtleTeacherCfg,
    VaDECfg,
)
from deepof_tpu_torch.train.dataset import WindowDataset, prefetch
from deepof_tpu_torch.train.diagnostics import alignment_score
from deepof_tpu_torch.train.gmm import fit_gmm_init
from deepof_tpu_torch.train.losses import (
    VadeLossParams,
    select_contrastive_loss,
    vade_loss,
    vade_params_from_cfg,
)
from deepof_tpu_torch.train.schedules import WeightSchedule
from deepof_tpu_torch.train.teacher import fit_turtle_teacher, initialize_gmm_from_teacher

# --------------------------------------------------------------------------- #
# Model bundle (the rebuild_spec checkpoint contract)
# --------------------------------------------------------------------------- #


def _model_from_spec(spec: Dict, device) -> nn.Module:
    return build_model(
        spec["model"], spec["input_shape"], spec["edge_feature_shape"], np.asarray(spec["adjacency"]),
        spec["latent_dim"], spec.get("n_components", 10), spec.get("encoder_type", "recurrent"),
        spec.get("use_gnn", True), device=device,
        angle_feature_shape=spec.get("angle_feature_shape") if spec.get("use_angles") else None,
    )


@dataclass
class ModelBundle:
    """A model and the spec it is rebuilt from (``rebuild_spec["model"]``,
    ``["input_shape"]``, ...), its training history and, where validation
    ran, the state with the best validation loss; where a teacher drove
    VaDE's distillation, the state with the best alignment score."""

    model: nn.Module
    rebuild_spec: Dict = field(default_factory=dict)
    history: Dict[str, List[float]] = field(default_factory=dict)
    best_state: Optional[Dict[str, torch.Tensor]] = None
    best_val: Optional[float] = None
    best_score_state: Optional[Dict[str, torch.Tensor]] = None
    best_score: Optional[float] = None

    def save(self, path: str, state: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """``torch.save`` of the state dict (the model's, or ``state``), the
        rebuild spec and the history."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        state = self.model.state_dict() if state is None else state
        torch.save({
            "rebuild_spec": self.rebuild_spec,
            "state_dict": {k: v.detach().cpu() for k, v in state.items()},
            "history": self.history,
        }, path)

    @classmethod
    def load(cls, path: str, device="cuda") -> "ModelBundle":
        """The bundle a :meth:`save` wrote, its model rebuilt from the spec
        on ``device``, in eval mode."""
        if not zipfile.is_zipfile(path):
            raise NotImplementedError(
                f"{path} is not a checkpoint of this package (torch.save): the JAX package's "
                "flax checkpoints come with their converter, ROADMAP queue 1 item 9"
            )
        payload = torch.load(path, map_location="cpu", weights_only=True)
        spec = payload["rebuild_spec"]
        model = _model_from_spec(spec, device)
        model.load_state_dict(payload["state_dict"])
        return cls(model.eval(), spec, payload.get("history", {}))

    def _inputs(self, x, a, angles):
        dev = next(self.model.parameters()).device
        return (torch.as_tensor(x, dtype=torch.float32, device=dev),
                torch.as_tensor(a, dtype=torch.float32, device=dev),
                None if angles is None else torch.as_tensor(angles, dtype=torch.float32, device=dev))

    @torch.no_grad()
    def encode(self, x, a, angles=None) -> torch.Tensor:
        """The encoder's output for windows (numpy or tensors), on the
        model's device."""
        return self.model.encode(*self._inputs(x, a, angles))

    @torch.no_grad()
    def embed(self, x, a, angles=None) -> torch.Tensor:
        """The served embedding: VaDE's z_mean, else the encoder's output."""
        if hasattr(self.model, "embed"):
            return self.model.embed(*self._inputs(x, a, angles))
        return self.encode(x, a, angles)

    @torch.no_grad()
    def group(self, x, a, angles=None) -> torch.Tensor:
        """The soft cluster assignments (VaDE's categorical posterior, the
        VQ-VAE's soft counts)."""
        return self.model.group(*self._inputs(x, a, angles))


# --------------------------------------------------------------------------- #
# Optimiser and steps
# --------------------------------------------------------------------------- #


class ClippedAdam(torch.optim.Adam):
    """The JAX package's ``optax.chain(optax.clip(clip), optax.adam(lr))``:
    each gradient element clipped to [-clip, clip], then Adam (b1 0.9, b2
    0.999, eps 1e-8 outside the root). PyTorch's Adam applies optax's
    formula, lr * m_hat / (sqrt(v_hat) + eps) with bias-corrected moments.

    A param group may carry a ``"schedule"``: update count -> lr, evaluated
    at the number of updates taken so far (from 0), as optax evaluates a
    learning-rate schedule. A group at lr 0 keeps its parameters while its
    moments tick, as optax's do. The state dict holds the update count and
    not the schedules, which loading keeps from the optimiser loaded into."""

    def __init__(self, params, lr: float, clip: float = 0.75):
        super().__init__(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
        self.clip = clip
        self.updates = 0

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            nn.utils.clip_grad_value_([p for p in group["params"] if p.grad is not None], self.clip)
            if "schedule" in group:
                group["lr"] = group["schedule"](self.updates)
        self.updates += 1
        return super().step(closure)

    def state_dict(self):
        state = super().state_dict()
        state["param_groups"] = [{k: v for k, v in g.items() if k != "schedule"} for g in state["param_groups"]]
        return {**state, "updates": self.updates}

    def load_state_dict(self, state_dict) -> None:
        schedules = [g.get("schedule") for g in self.param_groups]
        state = dict(state_dict)
        self.updates = int(state.pop("updates"))
        super().load_state_dict(state)
        for group, schedule in zip(self.param_groups, schedules):
            if schedule is not None:
                group["schedule"] = schedule


def _grouped_adam(named_parameters, label, schedules: Dict[str, Callable[[int], float]],
                  clip: float) -> ClippedAdam:
    """A ClippedAdam whose group g holds the parameters ``label(name)``
    names g, at lr ``schedules[g]``."""
    params: Dict[str, list] = {g: [] for g in schedules}
    for name, p in named_parameters:
        params[label(name)].append(p)
    groups = [{"params": params[g], "schedule": schedules[g], "lr": schedules[g](0)}
              for g in schedules if params[g]]
    return ClippedAdam(groups, groups[0]["lr"], clip)


def _make_optimizer(named_parameters, learning_rate: float, clip: float = 0.75,
                    gmm_lr: Optional[float] = None) -> ClippedAdam:
    """Clipped Adam over a model's ``named_parameters()``; with ``gmm_lr``
    the parameters whose name holds "gmm" (the mixture prior) form a group
    of their own at that rate, as the JAX package's ``optax.multi_transform``
    labels them."""
    if gmm_lr is None:
        return ClippedAdam([p for _, p in named_parameters], learning_rate, clip)
    return _grouped_adam(named_parameters, lambda name: "gmm" if "gmm" in name else "base",
                         {"base": lambda t: learning_rate, "gmm": lambda t: gmm_lr}, clip)


def _piecewise(segments) -> Callable[[int], float]:
    """[(start update, lr), ...] -> the lr of the last segment started."""
    def schedule(t: int) -> float:
        lr = segments[0][1]
        for start, value in segments[1:]:
            if t >= start:
                lr = value
        return lr
    return schedule


def _make_vade_main_optimizer(named_parameters, learning_rate: float, gmm_lr: Optional[float],
                              n_batches: int, freeze_gmm_epochs: int = 0, freeze_decoder_epochs: int = 0,
                              clip: float = 0.75) -> ClippedAdam:
    """The main phase's optimiser with epoch-scheduled freezes: the GMM
    prior ("gmm" in the name) and the decoder ("decoder.*") train at lr 0
    during their freeze windows; once the GMM unfreezes the rates drop to
    5e-4 (base, decoder) and 2e-4 (GMM), the JAX package's piecewise
    schedules over update counts."""
    fg = max(0, int(freeze_gmm_epochs)) * n_batches
    fd = max(0, int(freeze_decoder_epochs)) * n_batches
    g_lr = gmm_lr if gmm_lr is not None else learning_rate
    schedules = {
        "base": _piecewise([(0, learning_rate)] + ([(fg, 5e-4)] if fg else [])),
        "gmm": _piecewise([(0, 0.0 if fg else g_lr)] + ([(fg, 2e-4)] if fg else [])),
        "decoder": _piecewise([(0, 0.0 if fd else learning_rate)] + ([(fd, learning_rate)] if fd else [])
                              + ([(fg, 5e-4)] if fg else [])),
    }

    def label(name: str) -> str:
        if "gmm" in name:
            return "gmm"
        return "decoder" if name.split(".")[0] == "decoder" else "base"

    return _grouped_adam(named_parameters, label, schedules, clip)


def vqvae_loss(model: nn.Module, x: torch.Tensor, a: torch.Tensor,
               ang: Optional[torch.Tensor] = None, train: bool = True):
    """(total, logs) of one batch, in train mode (or eval mode without
    ``train``): total = enc_rec + rec + vq + kmeans, each rec the negative
    mean log-probability over all (B, T) frames (masked frames count as
    0)."""
    out = model.training_forward(x, a, ang, train=train)
    b, t = x.shape[:2]
    x_flat = x.reshape(b, t, -1)
    enc_rec = -out["encoding_reconstruction"].log_prob(x_flat).mean()
    rec = -out["quantized_reconstruction"].log_prob(x_flat).mean()
    zero = x.new_zeros(())
    vq = out["vq_losses"].get("vq_loss", zero)
    km = out["vq_losses"].get("kmeans_loss", zero)
    total = enc_rec + rec + vq + km
    logs = {"total_loss": total, "enc_rec_loss": enc_rec, "reconstruct_loss": rec,
            "vq_loss": vq, "kmeans_loss": km}
    return total, logs


def make_vqvae_step(model: nn.Module, optimizer: torch.optim.Optimizer) -> Callable:
    """step(x, a, ang=None) -> logs: loss, backward, clip + Adam update."""

    def step(x, a, ang=None):
        total, logs = vqvae_loss(model, x, a, ang)
        optimizer.zero_grad(set_to_none=False)
        total.backward()
        optimizer.step()
        return {k: v.detach() for k, v in logs.items()}

    return step


def make_vqvae_eval_step(model: nn.Module) -> Callable:
    """step(x, a, ang=None) -> {"total_loss": enc_rec + rec + vq,
    "reconstruct_loss": rec}, in eval mode, without gradients."""

    @torch.no_grad()
    def step(x, a, ang=None):
        _, logs = vqvae_loss(model, x, a, ang, train=False)
        return {"total_loss": logs["enc_rec_loss"] + logs["reconstruct_loss"] + logs["vq_loss"],
                "reconstruct_loss": logs["reconstruct_loss"]}

    return step


def vade_step_loss(model: nn.Module, x: torch.Tensor, a: torch.Tensor, ang: Optional[torch.Tensor],
                   loss_params: VadeLossParams, kl_weight: float, eps_z: Optional[torch.Tensor] = None,
                   eps_kl: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
                   train: bool = True, tau_star_batch: Optional[torch.Tensor] = None,
                   lambda_distill: float = 0.0, class_weight: Optional[torch.Tensor] = None):
    """(total, logs) of one batch through VaDE's training forward (z
    sampled with ``train``) and ``vade_loss`` (with the distillation term
    where the teacher's ``tau_star_batch`` is given). ``eps_z`` (B, D) and
    ``eps_kl`` (S, B, D) are the two standard-normal draws the JAX step
    takes from its split key; each not given is drawn from ``generator``,
    z's first."""
    out = model.training_forward(x, a, ang, eps=eps_z, train=train, generator=generator)
    logs = vade_loss(out, x, loss_params, kl_weight, eps=eps_kl, generator=generator,
                     tau_star_batch=tau_star_batch, lambda_distill=lambda_distill, class_weight=class_weight)
    return logs["total_loss"], logs


def make_vade_step(model: nn.Module, optimizer: torch.optim.Optimizer, loss_params: VadeLossParams,
                   generator: Optional[torch.Generator] = None) -> Callable:
    """step(x, a, ang=None, kl_weight=0.0, tau_star_batch=None,
    lambda_distill=0.0, class_weight=None) -> logs: loss (its noise drawn
    from ``generator``), backward, clip + Adam update. Without the teacher's
    assignments the JAX step's distillation term is exactly 0 and is not
    computed."""

    def step(x, a, ang=None, kl_weight=0.0, tau_star_batch=None, lambda_distill=0.0, class_weight=None):
        total, logs = vade_step_loss(model, x, a, ang, loss_params, kl_weight, generator=generator,
                                     tau_star_batch=tau_star_batch, lambda_distill=lambda_distill,
                                     class_weight=class_weight)
        optimizer.zero_grad(set_to_none=False)
        total.backward()
        optimizer.step()
        return {k: v.detach() for k, v in logs.items()}

    return step


def make_vade_eval_step(model: nn.Module, loss_params: VadeLossParams,
                        generator: Optional[torch.Generator] = None) -> Callable:
    """step(x, a, ang=None, kl_weight=0.0) -> every loss of the batch in
    eval mode at z = z_mean (the KL's noise drawn from ``generator``),
    without gradients."""

    @torch.no_grad()
    def step(x, a, ang=None, kl_weight=0.0):
        return vade_step_loss(model, x, a, ang, loss_params, kl_weight, generator=generator, train=False)[1]

    return step


def contrastive_step_loss(model: nn.Module, x_full: torch.Tensor, edge_index: np.ndarray,
                          precomp: RotationPrecomp, cfg: ContrastiveCfg, draws: Optional[Dict] = None,
                          generator: Optional[torch.Generator] = None, dropout_masks=None):
    """(loss, logs) of one contrastive batch of full windows x_full (B, T, N,
    F): the centred half window and the augmented view (``draws`` as
    ``augment.draw_augmentations`` makes them, drawn from ``generator`` when
    not given), each with its edges recomputed from the coordinates, through
    two train-mode forwards, the second seeing the running statistics the
    first moved and the same dropout masks (``dropout_masks`` given, or
    drawn from ``generator`` in the first); the loss of
    ``cfg.contrastive_loss_function`` under its similarity on the
    L2-normalised embeddings. Logs: total_loss, pos_similarity,
    neg_similarity."""
    a_full = recompute_edges(x_full, edge_index)
    x_aug, a_aug = make_augmented_view(x_full, edge_index, precomp, cfg, draws, generator)
    half = x_full.shape[1] // 2
    starts = torch.full((x_full.shape[0],), half // 2, dtype=torch.long, device=x_full.device)
    x = slice_time_per_sample(x_full, starts, half)
    a = slice_time_per_sample(a_full, starts, half)
    first = DropoutDraws(generator, dropout_masks, record=True)
    use_dropout_draws(model, first)
    z = model.training_forward(x, a)
    use_dropout_draws(model, DropoutDraws(masks=first.recorded))
    z_aug = model.training_forward(x_aug, a_aug)
    use_dropout_draws(model, DropoutDraws(generator))
    zn = z / torch.linalg.vector_norm(z, dim=1, keepdim=True).clamp(min=1e-8)
    zan = z_aug / torch.linalg.vector_norm(z_aug, dim=1, keepdim=True).clamp(min=1e-8)
    loss, pos, neg = select_contrastive_loss(
        zn, zan, similarity=cfg.contrastive_similarity_function, loss_fn=cfg.contrastive_loss_function,
        temperature=cfg.temperature, tau=cfg.tau, beta=cfg.beta)
    return loss, {"total_loss": loss, "pos_similarity": pos, "neg_similarity": neg}


def make_contrastive_step(model: nn.Module, optimizer: torch.optim.Optimizer, cfg: ContrastiveCfg,
                          edge_index: np.ndarray, precomp: RotationPrecomp,
                          generator: torch.Generator) -> Callable:
    """step(x_full) -> logs: ``contrastive_step_loss`` (its draws from
    ``generator``), backward, clip + Adam update."""

    def step(x_full):
        loss, logs = contrastive_step_loss(model, x_full, edge_index, precomp, cfg, generator=generator)
        optimizer.zero_grad(set_to_none=False)
        loss.backward()
        optimizer.step()
        return {k: v.detach() for k, v in logs.items()}

    return step


# --------------------------------------------------------------------------- #
# Fit loops
# --------------------------------------------------------------------------- #


def _epoch_mean(logs_list: List[Dict], weights: List[int] = None) -> Dict[str, float]:
    """Per-key average over batch logs, weighted by batch sizes."""
    if not logs_list:
        return {}
    keys = logs_list[0].keys()
    w = np.asarray(weights if weights is not None else [1] * len(logs_list), float)
    w = w / w.sum()
    return {k: float(np.sum([float(l[k]) * wi for l, wi in zip(logs_list, w)])) for k in keys}


def _chain_hooks(*hooks):
    """The epoch-end hooks given (Nones dropped) run in order as one; it
    returns True, which stops training, when any of them does."""
    hooks = [h for h in hooks if h is not None]
    if not hooks:
        return None

    def combined(epoch, train_logs, val_logs):
        stop = False
        for h in hooks:
            if h(epoch, train_logs, val_logs) is True:
                stop = True
        return stop

    return combined


def _run_epochs(
    *,
    n_epochs: int,
    train_ds: WindowDataset,
    val_ds: Optional[WindowDataset],
    batch_size: int,
    rng_seed: int,
    train_fn,
    eval_fn,
    history: Dict[str, List[float]],
    on_epoch_end=None,
    bootstrap: bool = False,
    bootstrap_block_len: int = 250,
    limit_train_batches: Optional[int] = None,
    limit_val_batches: Optional[int] = None,
    verbose: bool = True,
    phase: str = "",
    start_epoch: int = 0,
    on_best=None,
    score_fn=None,
    on_best_score=None,
):
    """Epoch loop from ``start_epoch`` with best-validation tracking;
    returns the best validation loss. ``on_best(epoch, val_loss)`` fires
    whenever it improves; an ``on_epoch_end(epoch, train_logs, val_logs)``
    returning True stops training. Batches come from one
    ``np.random.default_rng(rng_seed)``, drawn as the JAX package draws
    them. History keys are ``f"{phase}{key}"`` and ``f"{phase}val_{key}"``.

    With ``score_fn(epoch) -> float`` its value goes into the validation
    logs as ``alignment_score``, and ``on_best_score(epoch, score,
    val_loss)`` fires under the reference's rule: the score improves, or ties
    within 0.01 at a lower validation loss, after more than max(3, ceil(0.1
    * n_epochs)) epochs."""
    best_val = np.inf
    best_score, best_score_val = -np.inf, np.inf
    score_start_epoch = max(3, int(np.ceil(0.1 * n_epochs)))
    score_tol = 0.01
    np_rng = np.random.default_rng(rng_seed)
    for epoch in range(start_epoch, n_epochs):
        t0 = time.time()
        logs_list = []
        batches = prefetch(train_ds.batches(
            batch_size, rng=np_rng, shuffle=True, bootstrap=bootstrap, block_size=bootstrap_block_len,
        ))
        try:
            for bi, (x, a, ang, idx) in enumerate(batches):
                if limit_train_batches and bi >= limit_train_batches:
                    break
                logs_list.append((train_fn(x, a, ang, idx, epoch), len(idx)))
        finally:
            batches.close()
        train_logs = _epoch_mean([l for l, _ in logs_list], [n for _, n in logs_list])

        val_logs = {}
        if val_ds is not None and len(val_ds) > 0 and eval_fn is not None:
            vlist = []
            for bi, (x, a, ang, idx) in enumerate(val_ds.batches(batch_size, rng=np_rng, shuffle=False)):
                if limit_val_batches and bi >= limit_val_batches:
                    break
                vlist.append((eval_fn(x, a, ang, idx, epoch), len(idx)))
            val_logs = _epoch_mean([v for v, _ in vlist], [n for _, n in vlist])
            epoch_val = val_logs.get("total_loss", np.inf)
            if epoch_val < best_val:
                best_val = epoch_val
                if on_best is not None:
                    on_best(epoch, float(epoch_val))
            if score_fn is not None:
                score_value = float(score_fn(epoch))
                val_logs["alignment_score"] = score_value
                improved = np.isfinite(score_value) and (
                    score_value > best_score
                    or (abs(score_value - best_score) <= score_tol and epoch_val < best_score_val)
                )
                if improved and epoch > score_start_epoch:
                    best_score, best_score_val = score_value, epoch_val
                    if on_best_score is not None:
                        on_best_score(epoch, score_value, float(epoch_val))

        for k, v in train_logs.items():
            history.setdefault(f"{phase}{k}", []).append(v)
        for k, v in val_logs.items():
            history.setdefault(f"{phase}val_{k}", []).append(v)
        if verbose:
            msg = ", ".join(f"{k}={v:.4f}" for k, v in list(train_logs.items())[:4])
            vmsg = f" | val={val_logs.get('total_loss', float('nan')):.4f}" if val_logs else ""
            print(f"[{phase or 'train'}] epoch {epoch + 1}/{n_epochs} ({time.time() - t0:.1f}s): {msg}{vmsg}")
        if on_epoch_end is not None and on_epoch_end(epoch, train_logs, val_logs) is True:
            break
    return best_val


def raise_if_flat(x0):
    if x0.ndim != 4:
        raise ValueError(
            "Expected (B, W, N, F) node tensors; got flat features. Use "
            "deepof_tpu_torch.graph_dataset.reorder_and_reshape on (B, W, 3N) stacks."
        )


def _batch_to(dev: torch.device, use_angles: bool, x, a, ang):
    """One host batch (x, a, angles) -> tensors on ``dev``; angles only when
    the model reads them."""
    return (torch.as_tensor(x, device=dev), torch.as_tensor(a, device=dev),
            torch.as_tensor(ang, device=dev) if use_angles else None)


def _first_batch(train_ds: WindowDataset, common: CommonFitCfg, use_angles: bool):
    """(x0, a0, ang0, use_angles) of the first unshuffled batch, which gives
    the model its shapes; the angle stream only where the data has one."""
    x0, a0, ang0, _ = next(train_ds.batches(min(common.batch_size, max(len(train_ds), 1)), shuffle=False))
    raise_if_flat(x0)
    return x0, a0, ang0, bool(use_angles) and ang0.size > 0


def _new_model(name: str, x0, a0, ang0, adjacency, common: CommonFitCfg, use_gnn: bool,
               use_angles: bool, kmeans_loss: float, dev: torch.device) -> nn.Module:
    return build_model(
        name, x0.shape[1:], a0.shape[1:], adjacency, common.latent_dim, common.n_components,
        common.encoder_type, use_gnn, generator=torch.Generator().manual_seed(common.seed or 0), device=dev,
        angle_feature_shape=ang0.shape[1:] if use_angles else None, kmeans_loss=kmeans_loss,
    )


def _rebuild_spec(name: str, x0, a0, ang0, adjacency, common: CommonFitCfg, use_gnn: bool,
                  use_angles: bool) -> Dict:
    return {
        "model": name,
        "input_shape": list(x0.shape[1:]),
        "edge_feature_shape": list(a0.shape[1:]),
        "adjacency": np.asarray(adjacency).tolist(),
        "latent_dim": common.latent_dim,
        "n_components": common.n_components,
        "encoder_type": common.encoder_type,
        "use_gnn": use_gnn,
        "use_angles": use_angles,
        "angle_feature_shape": list(ang0.shape[1:]) if use_angles else None,
    }


def _cpu_state(model: nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def _best_tracker(model: nn.Module):
    """(best, on_best): ``on_best`` keeps a CPU copy of the model's state in
    ``best["state"]`` and its validation loss in ``best["val"]``."""
    best: Dict = {}

    def on_best(epoch, val_loss):
        best["state"] = _cpu_state(model)
        best["val"] = val_loss

    return best, on_best


def _fit_state(model: nn.Module, optimizer: torch.optim.Optimizer) -> Callable[[], Dict]:
    """The state a checkpoint holds: the model's parameters and buffers and
    the optimiser's state."""
    return lambda: {"model": model.state_dict(), "optimizer": optimizer.state_dict()}


def _resume(checkpointer: Optional[TrainCheckpointer], model: nn.Module,
            optimizer: torch.optim.Optimizer) -> int:
    """Load the latest checkpoint's model and optimiser state, if any; ->
    the epoch to start from."""
    start_epoch, state = maybe_resume(checkpointer)
    if state is not None:
        model.load_state_dict(state["model"])
        optimizer.load_state_dict(state["optimizer"])
    return start_epoch


def fit_vqvae(
    train_ds: WindowDataset,
    val_ds: Optional[WindowDataset],
    adjacency: np.ndarray,
    common: CommonFitCfg,
    use_gnn: bool = True,
    kmeans_loss: float = 0.0,
    use_angles: bool = False,
    bootstrap: bool = False,
    bootstrap_block_len: int = 250,
    verbose: bool = True,
    checkpointer=None,
    epoch_callback=None,
    device="cuda",
) -> ModelBundle:
    """Train a VQ-VAE on ``train_ds`` (validated on ``val_ds`` after every
    epoch) on ``device``. Weights are drawn from ``common.seed`` on the CPU,
    dropout's masks from a generator of that seed on ``device``. With a
    ``checkpointer`` it resumes after its latest epoch and saves at epoch
    ends. Returns its bundle, in eval mode."""
    dev = resolve_device(device)
    x0, a0, ang0, use_angles = _first_batch(train_ds, common, use_angles)
    model = _new_model("VQVAE", x0, a0, ang0, adjacency, common, use_gnn, use_angles, kmeans_loss, dev)
    use_dropout_draws(model, DropoutDraws(torch.Generator(device=dev).manual_seed(common.seed or 0)))
    optimizer = _make_optimizer(model.named_parameters(), common.learning_rate)
    step = make_vqvae_step(model, optimizer)
    eval_step = make_vqvae_eval_step(model)
    start_epoch = _resume(checkpointer, model, optimizer)

    def train_fn(x, a, ang, idx, epoch):
        return step(*_batch_to(dev, use_angles, x, a, ang))

    def eval_fn(x, a, ang, idx, epoch):
        return eval_step(*_batch_to(dev, use_angles, x, a, ang))

    best, on_best = _best_tracker(model)
    history: Dict[str, List[float]] = {}
    _run_epochs(
        n_epochs=common.epochs, train_ds=train_ds, val_ds=val_ds, batch_size=common.batch_size,
        rng_seed=common.seed or 0, train_fn=train_fn, eval_fn=eval_fn, history=history,
        bootstrap=bootstrap, bootstrap_block_len=bootstrap_block_len,
        limit_train_batches=common.limit_train_batches, limit_val_batches=common.limit_val_batches,
        verbose=verbose, start_epoch=start_epoch, on_best=on_best,
        on_epoch_end=_chain_hooks(make_epoch_checkpoint_hook(checkpointer, _fit_state(model, optimizer)),
                                  epoch_callback),
    )
    spec = _rebuild_spec("VQVAE", x0, a0, ang0, adjacency, common, use_gnn, use_angles)
    return ModelBundle(model.eval(), spec, history, best.get("state"), best.get("val"))


@torch.no_grad()
def extract_latents(model: nn.Module, ds: WindowDataset, batch_size: int,
                    use_angles: bool = False) -> torch.Tensor:
    """Encoder-mean latents (N, D) of the whole dataset, unshuffled, on the
    model's device, in eval mode (``embed``)."""
    dev = next(model.parameters()).device
    outs = []
    batches = prefetch(ds.batches(batch_size, shuffle=False))
    try:
        for x, a, ang, _ in batches:
            outs.append(model.embed(*_batch_to(dev, use_angles, x, a, ang)))
    finally:
        batches.close()
    return torch.cat(outs) if outs else torch.zeros((0, 1), device=dev)


def fit_vade(
    train_ds: WindowDataset,
    val_ds: Optional[WindowDataset],
    adjacency: np.ndarray,
    common: CommonFitCfg,
    vade_cfg: VaDECfg,
    teacher_cfg: TurtleTeacherCfg,
    use_gnn: bool = True,
    use_angles: bool = False,
    bootstrap: bool = False,
    bootstrap_block_len: int = 250,
    verbose: bool = True,
    checkpointer=None,
    epoch_callback=None,
    device="cuda",
) -> ModelBundle:
    """Train a VaDE on ``device`` in the JAX package's phases: pretrain
    (history keys ``"pretrain/..."``, KL to N(0, I), lr
    ``learning_rate_pretrain``); with ``use_turtle_teacher`` the TURTLE
    teacher on the pretrained latents; the GMM init of the mixture prior
    (from the teacher's assignments, else a GMM fitted to the latents); then
    the main phase against that prior (its KL schedule from
    ``vade_cfg.kl_annealing_mode`` / ``kl_warmup``, with best-validation
    tracking and ``epoch_callback``). Each phase gets a fresh optimiser. The
    sampling noise and dropout's masks come from one generator of
    ``common.seed`` on ``device``.

    With a teacher the main phase adds the distillation term (its weight
    from ``lambda_distill``'s linear schedule), refits the teacher every
    ``teacher_refresh_every`` epochs up to ``teacher_freeze_at`` (and with
    ``reinit_gmm_on_refresh`` re-initialises the prior from it), and, given
    validation data, keeps the state of the best alignment score. With a
    ``checkpointer`` the main phase resumes after its latest epoch and saves
    at epoch ends, and the state after the GMM init is written beside the
    epochs as ``teacher_init.pkl`` (a ``torch.save`` file); pretrain and the
    teacher run again on a resumed call, as in the JAX package. Returns the
    bundle, in eval mode."""
    dev = resolve_device(device)
    x0, a0, ang0, use_angles = _first_batch(train_ds, common, use_angles)
    seed = common.seed or 0
    model = _new_model("VaDE", x0, a0, ang0, adjacency, common, use_gnn, use_angles, common.kmeans_loss, dev)
    generator = torch.Generator(device=dev).manual_seed(seed)
    use_dropout_draws(model, DropoutDraws(generator))
    n_batches = max(1, train_ds.n_batches(common.batch_size))
    history: Dict[str, List[float]] = {}
    best, on_best = _best_tracker(model)
    tau_star = class_weight = None

    def set_prior(means, log_vars):
        with torch.no_grad():
            model.latent_space.gmm_means.copy_(means)
            model.latent_space.gmm_log_vars.copy_(log_vars)

    def teacher_refresh_hook(epoch, train_logs, val_logs):
        """Refit the teacher on the current latents (and re-initialise the
        prior from it) every ``teacher_refresh_every`` epochs."""
        nonlocal tau_star, class_weight
        every, freeze = teacher_cfg.teacher_refresh_every, teacher_cfg.teacher_freeze_at
        if not (teacher_cfg.use_turtle_teacher and every and epoch > 0 and (epoch + 1) % every == 0
                and (freeze is None or epoch + 1 <= freeze)):
            return
        if verbose:
            print(f"--- Refreshing TURTLE teacher at epoch {epoch + 1} ---")
        z = extract_latents(model, train_ds, common.batch_size, use_angles)
        tau_star, class_weight = fit_turtle_teacher(z, train_ds, common, teacher_cfg, verbose=verbose)
        if teacher_cfg.reinit_gmm_on_refresh:
            set_prior(*initialize_gmm_from_teacher(z, tau_star)[:2])

    @torch.no_grad()
    def score_fn(epoch):
        """The alignment score of the posteriors of up to 4 validation
        batches against the teacher's marginal."""
        qs = []
        for bi, (x, a, ang, _) in enumerate(val_ds.batches(common.batch_size, shuffle=False)):
            if bi >= 4:
                break
            qs.append(model.group(*_batch_to(dev, use_angles, x, a, ang)))
        return alignment_score(torch.cat(qs), tau_star)["alignment_score"] if qs else float("nan")

    def on_best_score(epoch, score, val_loss):
        best["score_state"] = _cpu_state(model)
        best["score"] = score

    def run_phase(phase, n_epochs, lr, pretrain, kl_schedule, lambda_schedule=None, optimizer=None,
                  ckpt=None, track_best=False):
        loss_params = vade_params_from_cfg(common, vade_cfg, teacher_cfg, pretrain)
        if optimizer is None:
            optimizer = _make_optimizer(model.named_parameters(), lr, gmm_lr=vade_cfg.gmm_learning_rate)
        step = make_vade_step(model, optimizer, loss_params, generator)
        eval_step = make_vade_eval_step(model, loss_params, generator)
        start_epoch = _resume(ckpt, model, optimizer)
        iteration = {"t": start_epoch * n_batches}

        def train_fn(x, a, ang, idx, epoch):
            kl_weight = kl_schedule.weight_at(iteration["t"])
            lam = lambda_schedule.weight_at(iteration["t"]) if lambda_schedule else 0.0
            iteration["t"] += 1
            distill = {}
            if tau_star is not None and lam > 0.0:
                distill = dict(tau_star_batch=tau_star[torch.as_tensor(idx, device=dev)], lambda_distill=lam,
                               class_weight=class_weight)
            return step(*_batch_to(dev, use_angles, x, a, ang), kl_weight=kl_weight, **distill)

        def eval_fn(x, a, ang, idx, epoch):
            return eval_step(*_batch_to(dev, use_angles, x, a, ang), kl_weight=kl_schedule.weight_at(iteration["t"]))

        # Score tracking only where a teacher drives distillation, as the
        # reference's apply_distill gate.
        track_score = track_best and tau_star is not None and val_ds is not None and len(val_ds) > 0
        _run_epochs(
            n_epochs=n_epochs, train_ds=train_ds, val_ds=val_ds, batch_size=common.batch_size,
            rng_seed=seed, train_fn=train_fn, eval_fn=eval_fn, history=history,
            bootstrap=bootstrap, bootstrap_block_len=bootstrap_block_len,
            limit_train_batches=common.limit_train_batches, limit_val_batches=common.limit_val_batches,
            verbose=verbose, phase=phase, start_epoch=start_epoch,
            on_epoch_end=_chain_hooks(make_epoch_checkpoint_hook(ckpt, _fit_state(model, optimizer)),
                                      teacher_refresh_hook if track_best else None,
                                      epoch_callback if track_best else None),
            on_best=on_best if track_best else None,
            score_fn=score_fn if track_score else None,
            on_best_score=on_best_score if track_score else None,
        )

    # Pretrain: VAE mode, KL to N(0, I).
    if vade_cfg.pretrain_epochs > 0:
        kl_schedule = WeightSchedule(
            n_batches_per_epoch=n_batches, mode=vade_cfg.kl_annealing_mode_pretrain,
            warmup_epochs=vade_cfg.kl_warmup_pretrain, max_weight=vade_cfg.kl_max_weight_pretrain,
            cooldown_epochs=vade_cfg.kl_cooldown_pretrain, end_weight=vade_cfg.kl_end_weight_pretrain,
        )
        run_phase("pretrain/", vade_cfg.pretrain_epochs, vade_cfg.learning_rate_pretrain, True, kl_schedule)

    # The teacher on the pretrained latents, then the GMM init of the
    # mixture prior: from the teacher's assignments, else a GMM fit.
    latents = extract_latents(model, train_ds, common.batch_size, use_angles)
    if teacher_cfg.use_turtle_teacher:
        tau_star, class_weight = fit_turtle_teacher(latents, train_ds, common, teacher_cfg, verbose=verbose)
    if tau_star is not None and latents.shape[0] == tau_star.shape[0]:
        set_prior(*initialize_gmm_from_teacher(latents, tau_star)[:2])
    elif latents.shape[0] >= common.n_components:
        set_prior(*fit_gmm_init(latents, common.n_components, seed))
    if checkpointer is not None:
        path = os.path.join(checkpointer.directory, "teacher_init.pkl")
        torch.save({"model": model.state_dict()}, path + ".tmp")
        os.replace(path + ".tmp", path)

    # Main phase against the GMM prior, distilled from the teacher.
    kl_schedule = WeightSchedule(
        n_batches_per_epoch=n_batches, mode=vade_cfg.kl_annealing_mode, warmup_epochs=vade_cfg.kl_warmup,
        max_weight=vade_cfg.kl_max_weight, cooldown_epochs=vade_cfg.kl_cooldown,
        end_weight=vade_cfg.kl_end_weight,
    )
    lambda_schedule = None
    if tau_star is not None:
        lambda_schedule = WeightSchedule(
            n_batches_per_epoch=n_batches, mode="linear", warmup_epochs=0, max_weight=teacher_cfg.lambda_distill,
            at_max_epochs=teacher_cfg.lambda_decay_start, cooldown_epochs=teacher_cfg.lambda_cooldown,
            end_weight=teacher_cfg.lambda_end_weight,
        )
    optimizer = None
    if vade_cfg.freeze_gmm_epochs or vade_cfg.freeze_decoder_epochs:
        optimizer = _make_vade_main_optimizer(
            model.named_parameters(), common.learning_rate, vade_cfg.gmm_learning_rate, n_batches,
            vade_cfg.freeze_gmm_epochs, vade_cfg.freeze_decoder_epochs,
        )
    run_phase("", common.epochs, common.learning_rate, False, kl_schedule, lambda_schedule, optimizer,
              ckpt=checkpointer, track_best=True)

    spec = _rebuild_spec("VaDE", x0, a0, ang0, adjacency, common, use_gnn, use_angles)
    return ModelBundle(model.eval(), spec, history, best.get("state"), best.get("val"),
                       best.get("score_state"), best.get("score"))


def graph_edges(adjacency: np.ndarray) -> np.ndarray:
    """(E, 2) node pairs of the graph's edges, upper-triangular row-major
    (the order of the edge features)."""
    rows, cols = np.nonzero(np.triu(np.asarray(adjacency)))
    return np.stack([rows, cols], axis=1).astype(np.int64)


def fit_contrastive(
    train_ds: WindowDataset,
    val_ds: Optional[WindowDataset],
    adjacency: np.ndarray,
    common: CommonFitCfg,
    contrastive_cfg: ContrastiveCfg,
    use_gnn: bool = True,
    bootstrap: bool = False,
    bootstrap_block_len: int = 250,
    verbose: bool = True,
    checkpointer=None,
    epoch_callback=None,
    device="cuda",
) -> ModelBundle:
    """Train a Contrastive model (``common.encoder_type``'s encoder over
    half windows) on ``device``: each step contrasts the centred half
    window of every training window with an augmented view of it
    (``make_contrastive_step``); there is no validation, as in the JAX
    package, so ``val_ds`` is not read. Weights are drawn from
    ``common.seed`` on the CPU, the augmentations and dropout's masks from a
    generator of that seed on ``device``. With a ``checkpointer`` it resumes
    after its latest epoch and saves at epoch ends. Returns the bundle, in
    eval mode."""
    dev = resolve_device(device)
    x0, a0, ang0, _ = _first_batch(train_ds, common, False)
    model = _new_model("Contrastive", x0, a0, ang0, adjacency, common, use_gnn, False, 0.0, dev)
    edge_index = graph_edges(adjacency)
    precomp = build_rotation_precomp(edge_index, np.asarray(adjacency).shape[0])
    generator = torch.Generator(device=dev).manual_seed(common.seed or 0)
    optimizer = _make_optimizer(model.named_parameters(), common.learning_rate)
    step = make_contrastive_step(model, optimizer, contrastive_cfg, edge_index, precomp, generator)
    start_epoch = _resume(checkpointer, model, optimizer)

    def train_fn(x, a, ang, idx, epoch):
        return step(torch.as_tensor(x, device=dev))

    history: Dict[str, List[float]] = {}
    _run_epochs(
        n_epochs=common.epochs, train_ds=train_ds, val_ds=None, batch_size=common.batch_size,
        rng_seed=common.seed or 0, train_fn=train_fn, eval_fn=None, history=history,
        bootstrap=bootstrap, bootstrap_block_len=bootstrap_block_len,
        limit_train_batches=common.limit_train_batches, limit_val_batches=common.limit_val_batches,
        verbose=verbose, start_epoch=start_epoch,
        on_epoch_end=_chain_hooks(make_epoch_checkpoint_hook(checkpointer, _fit_state(model, optimizer)),
                                  epoch_callback),
    )
    spec = {
        "model": "Contrastive",
        "input_shape": list(x0.shape[1:]),
        "edge_feature_shape": list(a0.shape[1:]),
        "adjacency": np.asarray(adjacency).tolist(),
        "latent_dim": common.latent_dim,
        "encoder_type": common.encoder_type,
        "use_gnn": use_gnn,
    }
    return ModelBundle(model.eval(), spec, history)


# --------------------------------------------------------------------------- #
# Dispatcher
# --------------------------------------------------------------------------- #


def _dataset_from_preprocessed(part, reorder: bool = True) -> WindowDataset:
    """A WindowDataset from a graph-dataset part whose values are (nodes
    (B, W, 3N), edges (B, W, E), angles (B, W, A)) windows: nodes
    (B, W, N, 3), edges (B, W, E, 1), angles (B, W, A, 1)."""
    shaped = {}
    for key in part.keys():
        nodes, edges, angles = (np.asarray(v, np.float32) for v in get_dt(part, key))
        if reorder and nodes.ndim == 3:
            nodes = reorder_and_reshape(nodes)
        if edges.ndim == 3:
            edges = edges[..., None]
        if angles.ndim == 3:
            angles = angles[..., None]
        shaped[key] = (nodes, edges, angles)
    return WindowDataset(shaped)


def train_deepof_model(
    preprocessed_object,
    adjacency_matrix: np.ndarray = None,
    model_name: str = "VaDE",
    encoder_type: str = "recurrent",
    batch_size: int = 64,
    latent_dim: int = 4,
    epochs: int = 10,
    log_history: bool = True,
    n_clusters: int = 10,
    kmeans_loss: float = 0.0,
    temperature: float = 0.1,
    contrastive_similarity_function: str = "cosine",
    contrastive_loss_function: str = "nce",
    beta: float = 0.1,
    tau: float = 0.1,
    output_path: str = ".",
    data_path: str = ".",
    pretrained: Optional[str] = None,
    save_weights: bool = True,
    run: int = 0,
    kl_annealing_mode: str = "linear",
    kl_warmup: int = 15,
    reg_cat_clusters: float = 0.0,
    recluster: bool = False,
    bootstrap_training: bool = False,
    bootstrap_block_len: int = 250,
    random_seed: int = 0,
    use_gnn: bool = True,
    use_angles: bool = False,
    use_amp: bool = False,
    pretrain_epochs: Optional[int] = None,
    use_turtle_teacher: bool = False,
    verbose: bool = True,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 1,
    epoch_callback=None,
    device="cuda",
    **kwargs,
):
    """Train a VaDE (the default), a VQ-VAE or a Contrastive model, with
    ``encoder_type``'s encoder, on a graph dataset ``(dataset (train,
    test), metainfo, adjacency)``.

    Returns (model_bundle, model_score, None, log_summary), as the JAX
    package does: model_score is the bundle of the best alignment score
    where the TURTLE teacher drove a VaDE's distillation and validation ran,
    else None. ``CommonFitCfg`` fields
    given as keywords (``learning_rate``, ``limit_train_batches``,
    ``limit_val_batches``) set the fit's configuration; for a VaDE so do
    ``VaDECfg`` and ``TurtleTeacherCfg`` fields (``kl_annealing_mode`` and
    ``kl_warmup`` set its main phase's KL schedule, ``pretrain_epochs`` its
    pretrain), and for a Contrastive model ``ContrastiveCfg`` fields (the
    loss, its similarity and temperature, the augmentations' ``aug_*``).
    The JAX package's common fields that no fit reads raise when set to
    another value than their default; other keywords are accepted and
    unused, as in the JAX package. With ``checkpoint_dir`` the fit saves
    every ``checkpoint_every``-th epoch there (``train.checkpoint``, the
    newest 3 kept) and a later call with the same directory resumes after
    the latest. With ``save_weights`` the bundle (its best-validation twin,
    ``_best.ckpt``, and its best-score twin, ``_best_score.ckpt``) is
    written under ``output_path/models`` as
    ``{model_name}_{encoder_type}_latent{L}_k{K}_run{run}.ckpt``.
    """
    if pretrained:  # before any raise, as the JAX package returns it
        return ModelBundle.load(pretrained, device), None, None, {}
    if model_name not in ("VaDE", "vade", "VQVAE", "vqvae") and model_name.lower() != "contrastive":
        raise ValueError(f"Unknown model_name: {model_name}")
    if use_amp:
        raise NotImplementedError(
            "use_amp: the GRU kernels take float32; mixed precision comes with ROADMAP queue 1 item 9"
        )
    unread = sorted(k for k, default in UNREAD_COMMON_FIELDS.items() if kwargs.get(k, default) != default)
    if unread:
        raise ValueError(f"{unread}: no fit reads such a setting")
    vade = model_name in ("VaDE", "vade")
    if vade:
        vade_cfg = VaDECfg(reg_cat_clusters=reg_cat_clusters, recluster=recluster,
                           kl_annealing_mode=kl_annealing_mode, kl_warmup=kl_warmup)
        if pretrain_epochs is not None:
            vade_cfg.pretrain_epochs = pretrain_epochs
        teacher_cfg = TurtleTeacherCfg(use_turtle_teacher=use_turtle_teacher)
        for cfg in (vade_cfg, teacher_cfg):
            for k, v in kwargs.items():
                if hasattr(cfg, k):
                    setattr(cfg, k, v)

    train_part, test_part = preprocessed_object[0], preprocessed_object[1]
    if isinstance(preprocessed_object, tuple) and len(preprocessed_object) >= 2 and \
            isinstance(preprocessed_object[0], tuple):
        train_part, test_part = preprocessed_object[0]
    train_ds = _dataset_from_preprocessed(train_part)
    val_ds = _dataset_from_preprocessed(test_part) if test_part is not None and len(test_part) else None
    common = CommonFitCfg(
        encoder_type=encoder_type, batch_size=batch_size, latent_dim=latent_dim, epochs=epochs,
        n_components=n_clusters, kmeans_loss=kmeans_loss, seed=random_seed,
    )
    for f in fields(common):
        if f.name in kwargs:
            setattr(common, f.name, kwargs[f.name])
    checkpointer = TrainCheckpointer(checkpoint_dir, save_interval_epochs=checkpoint_every) if checkpoint_dir else None
    fit_kw = dict(use_gnn=use_gnn, use_angles=use_angles, bootstrap=bootstrap_training,
                  bootstrap_block_len=bootstrap_block_len, verbose=verbose, checkpointer=checkpointer,
                  epoch_callback=epoch_callback, device=device)
    with checkpointer or contextlib.nullcontext():
        if vade:
            bundle = fit_vade(train_ds, val_ds, adjacency_matrix, common, vade_cfg, teacher_cfg, **fit_kw)
        elif model_name.lower() == "contrastive":
            ccfg = ContrastiveCfg(temperature=temperature,
                                  contrastive_similarity_function=contrastive_similarity_function,
                                  contrastive_loss_function=contrastive_loss_function, beta=beta, tau=tau)
            for k, v in kwargs.items():
                if hasattr(ccfg, k):
                    setattr(ccfg, k, v)
            fit_kw.pop("use_angles")
            bundle = fit_contrastive(train_ds, val_ds, adjacency_matrix, common, ccfg, **fit_kw)
        else:
            bundle = fit_vqvae(train_ds, val_ds, adjacency_matrix, common, kmeans_loss=kmeans_loss, **fit_kw)
    log_summary = {k: v[-1] if v else None for k, v in bundle.history.items()}
    score_bundle = None
    if bundle.best_score_state is not None:
        score_model = _model_from_spec(bundle.rebuild_spec, next(bundle.model.parameters()).device)
        score_model.load_state_dict(bundle.best_score_state)
        score_bundle = ModelBundle(score_model.eval(), bundle.rebuild_spec, bundle.history,
                                   best_score=bundle.best_score)
    if save_weights:
        name = f"{model_name}_{encoder_type}_latent{latent_dim}_k{n_clusters}_run{run}.ckpt"
        path = os.path.join(output_path, "models", name)
        bundle.save(path)
        if bundle.best_state is not None:
            bundle.save(path.replace(".ckpt", "_best.ckpt"), bundle.best_state)
        if score_bundle is not None:
            score_bundle.save(path.replace(".ckpt", "_best_score.ckpt"))
    return bundle, score_bundle, None, log_summary


def deep_unsupervised_embedding(
    coordinates,
    preprocessed_object,
    adjacency_matrix: np.ndarray = None,
    embedding_model: str = "VaDE",
    encoder_type: str = "recurrent",
    batch_size: int = 64,
    latent_dim: int = 4,
    epochs: int = 150,
    n_clusters: int = 10,
    output_path: str = "",
    pretrained=False,
    save_checkpoints: bool = False,
    device=None,
    **kwargs,
):
    """The Coordinates-level entry point: trains on the project's device
    (or ``device``), with outputs under the project's Trained_models, and
    loads ``pretrained`` from its Trained_models/models."""
    root = os.path.join(coordinates._project_path, coordinates._project_name)
    if pretrained:
        pretrained = os.path.join(root, "Trained_models", "models", pretrained)
    return train_deepof_model(
        preprocessed_object=preprocessed_object,
        adjacency_matrix=adjacency_matrix,
        model_name=embedding_model,
        encoder_type=encoder_type,
        batch_size=batch_size,
        latent_dim=latent_dim,
        epochs=epochs,
        n_clusters=n_clusters,
        output_path=os.path.join(root, output_path, "Trained_models"),
        data_path=os.path.join(root, "Tables"),
        pretrained=pretrained,
        save_weights=save_checkpoints,
        device=coordinates._device if device is None else device,
        **kwargs,
    )
