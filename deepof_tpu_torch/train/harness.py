"""Training harness of the VQ-VAE: the model bundle, the optimiser, the train
and evaluation steps, the epoch loop, ``fit_vqvae``, ``train_deepof_model``
and ``deep_unsupervised_embedding`` (port of deepof_tpu/train/harness.py:
``ModelBundle`` :75-166, ``_make_optimizer`` :187-207 (``ClippedAdam``), ``make_vqvae_step``
and ``make_vqvae_eval_step`` :275-319, ``_epoch_mean`` and ``_run_epochs``
:410-550, ``fit_vqvae`` :567-675, ``_dataset_from_preprocessed``
:1125-1144, ``train_deepof_model`` :1147-1324 and
``deep_unsupervised_embedding`` :1327-1367).

The JAX package jits one train step over a device mesh; here the step runs
eagerly on one device, its GRU layers through the fused GRU kernel and its
backward kernel (``ops.gru_kernels.GRULayerFunction``). VaDE and
Contrastive, Orbax checkpoints, mixed precision and the JAX package's flax
checkpoint files raise, naming their ROADMAP queue 1 items. Bundles are
saved with ``torch.save`` (state dict, rebuild spec, history).
"""

from __future__ import annotations

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
from deepof_tpu_torch.models.zoo import build_model
from deepof_tpu_torch.train.config import UNREAD_COMMON_FIELDS, CommonFitCfg
from deepof_tpu_torch.train.dataset import WindowDataset, prefetch

# --------------------------------------------------------------------------- #
# Model bundle (the rebuild_spec checkpoint contract)
# --------------------------------------------------------------------------- #


def _model_from_spec(spec: Dict, device) -> nn.Module:
    return build_model(
        spec["model"], spec["input_shape"], spec["edge_feature_shape"], np.asarray(spec["adjacency"]),
        spec["latent_dim"], spec["n_components"], spec.get("encoder_type", "recurrent"),
        spec.get("use_gnn", True), device=device,
        angle_feature_shape=spec.get("angle_feature_shape") if spec.get("use_angles") else None,
    )


@dataclass
class ModelBundle:
    """A model and the spec it is rebuilt from (``rebuild_spec["model"]``,
    ``["input_shape"]``, ...), its training history and, where validation
    ran, the state with the best validation loss."""

    model: nn.Module
    rebuild_spec: Dict = field(default_factory=dict)
    history: Dict[str, List[float]] = field(default_factory=dict)
    best_state: Optional[Dict[str, torch.Tensor]] = None
    best_val: Optional[float] = None

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
                "flax checkpoints come with the checkpoint port, ROADMAP queue 1 item 9"
            )
        payload = torch.load(path, map_location="cpu", weights_only=True)
        spec = payload["rebuild_spec"]
        model = _model_from_spec(spec, device)
        model.load_state_dict(payload["state_dict"])
        return cls(model.eval(), spec, payload.get("history", {}))


# --------------------------------------------------------------------------- #
# Optimiser and steps
# --------------------------------------------------------------------------- #


class ClippedAdam(torch.optim.Adam):
    """The JAX package's ``_make_optimizer`` without a GMM learning rate,
    ``optax.chain(optax.clip(clip), optax.adam(lr))``: each gradient
    element clipped to [-clip, clip], then Adam (b1 0.9, b2 0.999, eps 1e-8
    outside the root). PyTorch's Adam applies optax's formula,
    lr * m_hat / (sqrt(v_hat) + eps) with bias-corrected moments."""

    def __init__(self, params, lr: float, clip: float = 0.75):
        super().__init__(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
        self.clip = clip

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            nn.utils.clip_grad_value_([p for p in group["params"] if p.grad is not None], self.clip)
        return super().step(closure)


def vqvae_loss(model: nn.Module, x: torch.Tensor, a: torch.Tensor,
               ang: Optional[torch.Tensor] = None):
    """(total, logs) of one batch: total = enc_rec + rec + vq + kmeans, each
    rec the negative mean log-probability over all (B, T) frames (masked
    frames count as 0)."""
    out = model.training_forward(x, a, ang)
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
    "reconstruct_loss": rec}, without gradients."""

    @torch.no_grad()
    def step(x, a, ang=None):
        _, logs = vqvae_loss(model, x, a, ang)
        return {"total_loss": logs["enc_rec_loss"] + logs["reconstruct_loss"] + logs["vq_loss"],
                "reconstruct_loss": logs["reconstruct_loss"]}

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
    on_best=None,
):
    """Epoch loop with best-validation tracking; returns the best validation
    loss. ``on_best(epoch, val_loss)`` fires whenever it improves; an
    ``on_epoch_end(epoch, train_logs, val_logs)`` returning True stops
    training. Batches come from one ``np.random.default_rng(rng_seed)``,
    drawn as the JAX package draws them."""
    best_val = np.inf
    np_rng = np.random.default_rng(rng_seed)
    for epoch in range(n_epochs):
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

        for k, v in train_logs.items():
            history.setdefault(k, []).append(v)
        for k, v in val_logs.items():
            history.setdefault(f"val_{k}", []).append(v)
        if verbose:
            msg = ", ".join(f"{k}={v:.4f}" for k, v in list(train_logs.items())[:4])
            vmsg = f" | val={val_logs.get('total_loss', float('nan')):.4f}" if val_logs else ""
            print(f"[train] epoch {epoch + 1}/{n_epochs} ({time.time() - t0:.1f}s): {msg}{vmsg}")
        if on_epoch_end is not None and on_epoch_end(epoch, train_logs, val_logs) is True:
            break
    return best_val


def raise_if_flat(x0):
    if x0.ndim != 4:
        raise ValueError(
            "Expected (B, W, N, F) node tensors; got flat features. Use "
            "deepof_tpu_torch.graph_dataset.reorder_and_reshape on (B, W, 3N) stacks."
        )


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
    epoch) on ``device``. Weights are drawn from ``common.seed`` on the CPU.
    Returns its bundle, in eval mode."""
    if checkpointer is not None:
        raise NotImplementedError("resumable checkpoints (Orbax in the JAX package) come with ROADMAP queue 1 item 9")
    dev = resolve_device(device)
    x0, a0, ang0, _ = next(train_ds.batches(min(common.batch_size, max(len(train_ds), 1)), shuffle=False))
    raise_if_flat(x0)
    use_angles = bool(use_angles) and ang0.size > 0
    seed = common.seed or 0
    model = build_model(
        "VQVAE", x0.shape[1:], a0.shape[1:], adjacency, common.latent_dim, common.n_components,
        common.encoder_type, use_gnn, generator=torch.Generator().manual_seed(seed), device=dev,
        angle_feature_shape=ang0.shape[1:] if use_angles else None, kmeans_loss=kmeans_loss,
    )
    step = make_vqvae_step(model, ClippedAdam(model.parameters(), common.learning_rate))
    eval_step = make_vqvae_eval_step(model)

    def batch_on_device(x, a, ang):
        return (torch.as_tensor(x, device=dev), torch.as_tensor(a, device=dev),
                torch.as_tensor(ang, device=dev) if use_angles else None)

    def train_fn(x, a, ang, idx, epoch):
        return step(*batch_on_device(x, a, ang))

    def eval_fn(x, a, ang, idx, epoch):
        return eval_step(*batch_on_device(x, a, ang))

    best = {}

    def on_best(epoch, val_loss):
        best["state"] = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        best["val"] = val_loss

    history: Dict[str, List[float]] = {}
    _run_epochs(
        n_epochs=common.epochs, train_ds=train_ds, val_ds=val_ds, batch_size=common.batch_size,
        rng_seed=seed, train_fn=train_fn, eval_fn=eval_fn, history=history,
        bootstrap=bootstrap, bootstrap_block_len=bootstrap_block_len,
        limit_train_batches=common.limit_train_batches, limit_val_batches=common.limit_val_batches,
        verbose=verbose, on_epoch_end=epoch_callback, on_best=on_best,
    )
    rebuild_spec = {
        "model": "VQVAE",
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
    return ModelBundle(model.eval(), rebuild_spec, history, best.get("state"), best.get("val"))


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
    output_path: str = ".",
    data_path: str = ".",
    pretrained: Optional[str] = None,
    save_weights: bool = True,
    run: int = 0,
    bootstrap_training: bool = False,
    bootstrap_block_len: int = 250,
    random_seed: int = 0,
    use_gnn: bool = True,
    use_angles: bool = False,
    use_amp: bool = False,
    verbose: bool = True,
    checkpoint_dir: Optional[str] = None,
    epoch_callback=None,
    device="cuda",
    **kwargs,
):
    """Train a model on a graph dataset ``(dataset (train, test), metainfo,
    adjacency)``.

    Returns (model_bundle, model_score (None for the VQ-VAE), None,
    log_summary), as the JAX package does. ``CommonFitCfg`` fields given as
    keywords (``learning_rate``, ``limit_train_batches``,
    ``limit_val_batches``) set the fit's configuration; the JAX package's
    common fields that its VQ-VAE branch never reads raise when set to
    another value than their default, and the other families' keywords are
    accepted and unused, as in the JAX package's VQ-VAE branch. With
    ``save_weights`` the bundle (and its best-validation twin,
    ``_best.ckpt``) is written under ``output_path/models``.
    """
    if pretrained:  # before any raise, as the JAX package returns it
        return ModelBundle.load(pretrained, device), None, None, {}
    if model_name not in ("VQVAE", "vqvae"):
        raise NotImplementedError(f"model {model_name!r}: VaDE and Contrastive come with ROADMAP queue 1 item 8")
    if use_amp:
        raise NotImplementedError(
            "use_amp: the GRU kernels take float32; mixed precision comes with ROADMAP queue 1 item 9"
        )
    unread = sorted(k for k, default in UNREAD_COMMON_FIELDS.items() if kwargs.get(k, default) != default)
    if unread:
        raise ValueError(f"{unread}: the VQ-VAE fit reads no such setting")
    train_part, test_part = preprocessed_object[0], preprocessed_object[1]
    if isinstance(preprocessed_object, tuple) and len(preprocessed_object) >= 2 and \
            isinstance(preprocessed_object[0], tuple):
        train_part, test_part = preprocessed_object[0]
    if checkpoint_dir:
        raise NotImplementedError("checkpoint_dir: resumable checkpoints (Orbax in the JAX package) come with "
                                  "ROADMAP queue 1 item 9")

    train_ds = _dataset_from_preprocessed(train_part)
    val_ds = _dataset_from_preprocessed(test_part) if test_part is not None and len(test_part) else None
    common = CommonFitCfg(
        encoder_type=encoder_type, batch_size=batch_size, latent_dim=latent_dim, epochs=epochs,
        n_components=n_clusters, seed=random_seed,
    )
    for f in fields(common):
        if f.name in kwargs:
            setattr(common, f.name, kwargs[f.name])
    bundle = fit_vqvae(
        train_ds, val_ds, adjacency_matrix, common, use_gnn=use_gnn, kmeans_loss=kmeans_loss,
        use_angles=use_angles, bootstrap=bootstrap_training, bootstrap_block_len=bootstrap_block_len,
        verbose=verbose, epoch_callback=epoch_callback, device=device,
    )
    log_summary = {k: v[-1] if v else None for k, v in bundle.history.items()}
    if save_weights:
        name = f"{model_name}_{encoder_type}_latent{latent_dim}_k{n_clusters}_run{run}.ckpt"
        path = os.path.join(output_path, "models", name)
        bundle.save(path)
        if bundle.best_state is not None:
            bundle.save(path.replace(".ckpt", "_best.ckpt"), bundle.best_state)
    return bundle, None, None, log_summary


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
