"""The TURTLE teacher: soft cluster assignments tau over several views of
the training windows, fitted so that a linear head on each view recovers
them, which initialise VaDE's mixture prior and drive its distillation term
(port of deepof_tpu/train/teacher.py: ``soft_ce``, ``_entropy``,
``_normalize`` :29-41, ``make_turtle_step`` :51-171, ``build_views``
:174-210, ``fit_turtle_teacher`` :213-289 and
``initialize_gmm_from_teacher`` :292-317).

The JAX package compiles an outer step (the heads' inner fit, the outer
loss, its gradient and the Adam update) into one program. Here it runs
eagerly on the fit's device:
- the inner fit sees tau and the features detached, as the JAX package's
  does, so it runs under ``torch.no_grad()`` with the closed-form gradient
  of ``soft_ce``: (softmax * sum(t) - t) / B over the logits, t the targets
  clipped to [1e-8, 1] (not renormalised), divided by the head temperature;
  SGD with decoupled weight decay on w and b (``soft_ce_grad``). All views' heads step
  together in one batched product, each view's features zero-padded to the
  widest view (padded rows of a head never reach a logit);
- the outer loss (the refit cross-entropy, the sample entropy, the
  marginal gap, the dead-cluster barrier, the odd steps' smoothness term)
  runs under autograd, with Adam at optax's defaults (b1 0.9, b2 0.999, eps
  1e-8 after the square root).

The LeCun-normal initialisations of the task encoder and of each outer
step's heads come from a ``TeacherDraws``: a ``torch.Generator`` on the
fit's device, or arrays handed in (the JAX package's draws, in tests). The
minibatches are ``np.random.default_rng(seed).choice`` draws, as in the
JAX package. PCA is computed exactly (float64 covariance, ``eigh``,
sklearn's sign rule); sklearn takes a randomized solver for wide views
(ROADMAP §3).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepof_tpu_torch.device import resolve_device, working_dtype
from deepof_tpu_torch.models.blocks import lecun_normal

_CHUNK = 65_536  # rows a float64 PCA pass takes at once
_TAU_CHUNK = 8_192  # rows of tau_star a forward takes, as in the JAX package


def soft_ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of soft targets (clipped to [1e-8, 1], not
    renormalised) against softmax(logits) over the last axis."""
    return -(targets.clamp(1e-8, 1.0) * torch.log_softmax(logits, dim=-1)).sum(-1).mean()


def ce_grad_terms(targets: torch.Tensor, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum(t) * scale, -t * scale) of the clipped targets t: the constant
    terms of ``soft_ce``'s logit gradient, for ``soft_ce_grad``."""
    t = targets.clamp(1e-8, 1.0)
    return t.sum(-1, keepdim=True) * scale, t * -scale


def soft_ce_grad(logits: torch.Tensor, terms: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """(softmax(logits) * sum(t) - t) * scale from ``terms =
    ce_grad_terms(targets, scale)``: at scale 1 / B the gradient of
    ``soft_ce(logits, targets)`` over the logits."""
    tsum, neg_t = terms
    return torch.addcmul(neg_t, torch.softmax(logits, dim=-1), tsum)


def _entropy(p: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    p = p.clamp(min=eps)
    return -(p * torch.log(p)).sum(-1)


def _normalize(f: torch.Tensor) -> torch.Tensor:
    return f / torch.linalg.vector_norm(f, dim=-1, keepdim=True).clamp(min=1e-8)


class TeacherDraws:
    """The LeCun-normal draws of a teacher fit: the task encoder's weights,
    then each outer step's head weights, one (d_v, K) matrix a view. Drawn
    from ``generator`` (on the fit's device), or served from ``task``
    ([view] arrays) and ``heads`` ([step][view] arrays), each checked against
    the shape asked."""

    def __init__(self, generator: Optional[torch.Generator] = None, task: Optional[Sequence] = None,
                 heads: Optional[Sequence] = None):
        self.generator = generator
        self.task = task
        self.heads = heads

    def _weights(self, given, dims, k, device, dtype) -> List[torch.Tensor]:
        if given is None:
            if self.generator is None:
                raise RuntimeError("TeacherDraws needs a generator or the draws")
            return [lecun_normal((d, k), d, self.generator).to(device=device, dtype=dtype) for d in dims]
        out = [torch.tensor(np.asarray(w), device=device, dtype=dtype) for w in given]
        if [tuple(w.shape) for w in out] != [(d, k) for d in dims]:
            raise ValueError(f"given teacher draws have shapes {[tuple(w.shape) for w in out]}, "
                             f"not {[(d, k) for d in dims]}")
        return out

    def task_weights(self, dims, k, device, dtype) -> List[torch.Tensor]:
        return self._weights(self.task, dims, k, device, dtype)

    def head_weights(self, step: int, dims, k, device, dtype) -> List[torch.Tensor]:
        return self._weights(None if self.heads is None else self.heads[step], dims, k, device, dtype)


class TaskEncoder(nn.Module):
    """One linear map a view (``w.{v}`` (d_v, K), ``b.{v}`` (K,)): tau =
    softmax(sum_v ((f_v @ w_v + b_v) / task_temp) / n_views)."""

    def __init__(self, weights: Sequence[torch.Tensor], task_temp: float):
        super().__init__()
        self.w = nn.ParameterList([nn.Parameter(w.detach().clone()) for w in weights])
        self.b = nn.ParameterList([nn.Parameter(w.new_zeros(w.shape[1])) for w in weights])
        self.task_temp = task_temp

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        logits = None
        for w, b, f in zip(self.w, self.b, feats):
            out = (f @ w + b) / self.task_temp
            logits = out if logits is None else logits + out
        return torch.softmax(logits / max(len(self.w), 1), dim=-1)


def _pad_views(feats: Sequence[torch.Tensor], width: int) -> torch.Tensor:
    """[(B, d_v)] -> (V, B, width), each view zero-padded on the right."""
    return torch.stack([F.pad(f, (0, width - f.shape[-1])) for f in feats])


def make_turtle_step(
    feature_dims: Sequence[int],
    n_components: int,
    outer_steps: int,
    inner_steps: int = 100,
    inner_lr: float = 0.1,
    head_wd: float = 1e-4,
    head_temp: float = 0.5,
    task_temp: float = 0.5,
    gamma: float = 10.0,
    alpha_sample_entropy: float = 0.1,
    delta_death_barrier: float = 40.0,
    lr_theta: float = 5e-3,
    rho: float = 0.04,
    normalize_feats: bool = True,
):
    """(init_fn, step_fn) of the bi-level outer step.

    ``init_fn(task_weights)`` -> (task encoder, its Adam); ``step_fn(task,
    opt, feats, head_weights, step_frac, step_is_odd)`` fits a head a view
    to tau over ``inner_steps`` SGD steps from ``head_weights``, then takes
    one Adam step on the outer loss and returns it (a 0-d tensor, not
    synchronised). ``step_frac`` enters as float32, as the JAX package
    passes it.
    """
    n_views = len(feature_dims)
    width = max(feature_dims)
    log_k = float(np.log(n_components))
    dead_floor = max(1e-4, 0.1 / n_components)

    def init_fn(task_weights):
        task = TaskEncoder(task_weights, task_temp)
        return task, torch.optim.Adam(task.parameters(), lr=lr_theta, betas=(0.9, 0.999), eps=1e-8)

    @torch.no_grad()
    def fit_heads(feats_n: torch.Tensor, tau: torch.Tensor, head_weights) -> Tuple[torch.Tensor, torch.Tensor]:
        """``inner_steps`` SGD steps of every view's head (w (V, width, K),
        b (V, 1, K)) on soft_ce((f @ w + b) / head_temp, tau)."""
        w = torch.stack([F.pad(h, (0, 0, 0, width - h.shape[0])) for h in head_weights])
        b = w.new_zeros((n_views, 1, n_components))
        terms = ce_grad_terms(tau, 1.0 / (tau.shape[0] * head_temp))
        feats_t = feats_n.transpose(1, 2)
        for _ in range(inner_steps):
            g = soft_ce_grad(torch.baddbmm(b, feats_n, w, beta=1.0 / head_temp, alpha=1.0 / head_temp), terms)
            w.sub_(torch.add(torch.bmm(feats_t, g), w, alpha=head_wd), alpha=inner_lr)
            b.sub_(torch.add(g.sum(1, keepdim=True), b, alpha=head_wd), alpha=inner_lr)
        return w, b

    def step_fn(task, opt, feats, head_weights, step_frac, step_is_odd: bool) -> torch.Tensor:
        frac = np.float32(step_frac)
        gamma_t = float(np.float32(gamma) * (np.float32(1.0) - frac))
        delta_t = float(np.float32(delta_death_barrier)
                        * max(np.float32(0.5), np.float32(0.6) + np.float32(0.4) * (np.float32(1.0) - frac)))
        feats_n = _pad_views([_normalize(f) if normalize_feats else f for f in feats], width)
        tau = task(feats)
        w, b = fit_heads(feats_n, tau.detach(), head_weights)
        with torch.no_grad():
            log_probs = torch.log_softmax(torch.baddbmm(b, feats_n, w) / head_temp, dim=-1)
        ce = -(tau.clamp(1e-8, 1.0) * log_probs).sum(-1).mean(-1).sum() / max(n_views, 1)

        sample_entropy = _entropy(tau).mean()
        h_marg = _entropy(tau.mean(0)[None]).mean()
        marg_gap = torch.relu(log_k - h_marg)
        usage = (tau.clamp(min=1e-8) ** 2).mean(0)
        dead_pen = torch.relu(dead_floor - usage).sum() / (dead_floor * n_components)
        loss = ce + alpha_sample_entropy * sample_entropy + gamma_t * marg_gap + delta_t * dead_pen
        if step_is_odd and rho > 0.0:
            loss = loss + rho * torch.abs(tau[1:] - tau[:-1]).sum(-1).mean()
        opt.zero_grad(set_to_none=False)
        loss.backward()
        opt.step()
        return loss.detach()

    return init_fn, step_fn


def _pca_view(flat: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """sklearn's ``PCA(n_components=dim).fit_transform`` computed exactly:
    the centred covariance in float64, its ``eigh``, the components in
    descending order with sklearn's sign rule (``svd_flip``,
    ``u_based_decision=False``: each component's largest |entry| positive),
    the centred rows projected. -> (n, dim) float32."""
    dim = min(dim, flat.shape[1], max(2, n - 1))
    chunks = range(0, n, _CHUNK)
    mean = sum(flat[s:s + _CHUNK].double().sum(0) for s in chunks) / n
    cov = flat.new_zeros((flat.shape[1], flat.shape[1]), dtype=torch.float64)
    for s in chunks:
        xc = flat[s:s + _CHUNK].double() - mean
        cov += xc.T @ xc
    comps = torch.linalg.eigh(cov)[1][:, -dim:].flip(-1).T
    comps = comps * torch.sign(comps.gather(1, comps.abs().argmax(1, keepdim=True)))
    return torch.cat([((flat[s:s + _CHUNK].double() - mean) @ comps.T).float() for s in chunks])


def build_views(
    x_all,
    latents,
    edges_all=None,
    angles_all=None,
    pca_nodes_dim: int = 32,
    pca_edges_dim: int = 32,
    pca_angles_dim: int = 32,
    include_nodes: bool = True,
    include_latent: bool = True,
    include_edges: bool = False,
    include_angles: bool = False,
    device="cuda",
) -> List[torch.Tensor]:
    """The teacher's views on ``device``, float32 (N, d_v) each: the PCA of
    the positions (x's first two features), of the speeds (its third),
    optionally of the edges and the angles, and the latents."""
    dev = resolve_device(device)
    n = x_all.shape[0]
    views: List[torch.Tensor] = []
    x = torch.as_tensor(x_all, device=dev)
    if include_nodes:
        views.append(_pca_view(x[..., :2].reshape(n, -1), pca_nodes_dim, n))
        if x.shape[-1] > 2:
            views.append(_pca_view(x[..., 2:3].reshape(n, -1), pca_nodes_dim, n))
    del x
    for include, arr, dim in ((include_edges, edges_all, pca_edges_dim), (include_angles, angles_all, pca_angles_dim)):
        if include and arr is not None and arr.size:
            views.append(_pca_view(torch.as_tensor(arr, device=dev).reshape(n, -1), dim, n))
    if include_latent and latents is not None:
        views.append(torch.as_tensor(latents, device=dev).float())
    return views


def fit_turtle_teacher(
    latents,
    train_ds,
    common,
    teacher_cfg,
    verbose: bool = True,
    device=None,
    draws: Optional[TeacherDraws] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Fit the teacher on the views of ``train_ds`` and ``latents`` (N, D);
    -> (tau_star (N, K) float32, class_weight (K,) float32 or None), on
    ``device`` (default: the latents' device if they are a tensor, else the
    card). ``draws`` defaults to a generator of ``common.seed`` on that
    device. The fit runs in float32, or in float64 on the CPU when the
    latents are float64 (the views stay float32 values, as the JAX
    package's). The class weights are the inverse marginal of tau_star to
    the power ``distill_class_reweight_beta``, normalised to mean 1 and
    capped."""
    if device is None:
        device = latents.device if isinstance(latents, torch.Tensor) else "cuda"
    dev = resolve_device(device)
    dtype = working_dtype(dev, latents.dtype)
    n = len(train_ds)
    views = build_views(
        train_ds.x, latents, edges_all=train_ds.a, angles_all=train_ds.angles,
        pca_nodes_dim=teacher_cfg.pca_nodes_dim, pca_edges_dim=teacher_cfg.pca_edges_dim,
        pca_angles_dim=teacher_cfg.pca_angles_dim, include_nodes=bool(teacher_cfg.include_nodes_view),
        include_latent=bool(teacher_cfg.include_latent_view), include_edges=bool(teacher_cfg.include_edges_view),
        include_angles=bool(teacher_cfg.include_angles_view), device=dev,
    )
    views = [v.to(dtype) for v in views]
    dims = [v.shape[1] for v in views]
    k = common.n_components
    outer_steps = teacher_cfg.teacher_outer_steps
    init_fn, step_fn = make_turtle_step(
        dims, k, outer_steps=outer_steps, inner_steps=teacher_cfg.teacher_inner_steps,
        head_temp=teacher_cfg.teacher_head_temp, task_temp=teacher_cfg.teacher_task_temp,
        gamma=teacher_cfg.teacher_gamma, alpha_sample_entropy=teacher_cfg.teacher_alpha_sample_entropy,
        normalize_feats=bool(teacher_cfg.teacher_normalize_feats),
    )
    seed = common.seed or 0
    draws = draws or TeacherDraws(torch.Generator(device=dev).manual_seed(seed))
    task, opt = init_fn(draws.task_weights(dims, k, dev, dtype))

    batch_size = min(teacher_cfg.teacher_batch_size, n)
    np_rng = np.random.default_rng(seed)
    picks = torch.as_tensor(np.asarray([np_rng.choice(n, size=batch_size, replace=False)
                                        for _ in range(outer_steps)], np.int64).reshape(outer_steps, batch_size),
                            device=dev)
    for step in range(outer_steps):
        loss = step_fn(task, opt, [v[picks[step]] for v in views], draws.head_weights(step, dims, k, dev, dtype),
                       step / max(1, outer_steps), bool(step % 2))
        if verbose and (step % 50 == 0 or step == outer_steps - 1):
            print(f"[Teacher] step {step:03d} | loss {float(loss):.4f}")

    with torch.no_grad():
        tau_star = torch.cat([task([v[s:s + _TAU_CHUNK] for v in views]) for s in range(0, n, _TAU_CHUNK)])
    class_weight = None
    beta = teacher_cfg.distill_class_reweight_beta
    if beta:
        pi = tau_star.double().mean(0).clamp(min=1e-8)
        w = pi ** (-beta)
        w = w / w.mean()
        if teacher_cfg.distill_class_reweight_cap is not None:
            w = w.clamp(max=teacher_cfg.distill_class_reweight_cap)
        class_weight = w.float()
    return tau_star.float(), class_weight


def initialize_gmm_from_teacher(z_all, tau_star, min_var: float = 1e-4,
                                min_mass: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The mixture prior's weighted moments under tau_star, in float64 on
    z_all's device: (means (K, D), log_vars (K, D), prior (K,)), float32. A
    component of mass <= 1e-4 takes the data's mean and log-variance."""
    z = torch.as_tensor(z_all).to(torch.float64)
    tau = torch.as_tensor(tau_star).to(device=z.device, dtype=torch.float64)
    mass = tau.sum(0) + min_mass
    prior = (mass / mass.sum()).clamp(1e-8, 1.0)
    means = (tau.T @ z) / mass[:, None]
    sq = sum((tau[s:s + _CHUNK, :, None] * (z[s:s + _CHUNK, None, :] - means[None]) ** 2).sum(0)
             for s in range(0, z.shape[0], _CHUNK))
    log_vars = torch.log((sq / mass[:, None]).clamp(min=min_var))
    tiny = (mass <= 1e-4)[:, None]
    means = torch.where(tiny, z.mean(0), means)
    log_vars = torch.where(tiny, torch.log(z.var(0, unbiased=False).clamp(min=min_var)), log_vars)
    return means.float(), log_vars.float(), prior.float()
