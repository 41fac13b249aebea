"""Contrastive augmentations (port of deepof_tpu/train/augment.py:23-232):
edges recomputed from the coordinates, per-sample time slices, the
time-shifted half window, articulated branch rotations, linear
interpolation of a segment and per-node axis noise, and the cascade
``make_augmented_view`` that makes a batch's positive view.

Each augmentation takes its random draws as tensors, so that one input and
one set of draws give one output on any device, and the JAX package's draws
can be passed in. ``draw_augmentations`` draws them from a
``torch.Generator`` on the batch's device in the JAX package's order (its
keys k1..k4 and their splits), skipping, as it does, an augmentation that
is off.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch


def recompute_edges(x: torch.Tensor, edge_index: np.ndarray) -> torch.Tensor:
    """x (B, T, N, >=2) with (x, y, ...) per node, edge_index (E, 2) -> the
    (B, T, E, 1) Euclidean lengths of the edges."""
    idx = torch.as_tensor(np.asarray(edge_index), dtype=torch.long, device=x.device)
    coords = x[..., 0:2]
    return torch.linalg.vector_norm(coords[:, :, idx[:, 0]] - coords[:, :, idx[:, 1]], dim=-1, keepdim=True)


def slice_time_per_sample(x: torch.Tensor, starts: torch.Tensor, length: int) -> torch.Tensor:
    """x (B, T, ...), starts (B,) -> (B, length, ...), each start clamped to
    [0, T - length] as ``lax.dynamic_slice`` clamps it."""
    starts = starts.to(torch.long).clamp(0, x.shape[1] - length)
    idx = starts[:, None] + torch.arange(length, device=x.device)[None, :]
    idx = idx.reshape(idx.shape + (1,) * (x.ndim - 2)).expand((-1, -1) + tuple(x.shape[2:]))
    return torch.gather(x, 1, idx)


def augment_time_shift(x: torch.Tensor, draws: Dict[str, torch.Tensor], min_shift: int, max_shift: int,
                       p: float) -> torch.Tensor:
    """The half window at the centre, each sample's start moved by +-mag
    where its ``u`` < p. Draws: ``u`` (B,) uniform, ``mag`` (B,) integers
    in [min_shift, max_shift], ``sign`` (B,) integers in {0, 1}."""
    t = x.shape[1]
    half = t // 2
    base = (t - half) // 2
    shift = torch.where(draws["u"] < p, draws["mag"] * (draws["sign"] * 2 - 1), torch.zeros_like(draws["mag"]))
    starts = (base + shift).clamp(0, t - half)
    return slice_time_per_sample(x, starts, half)


@dataclass(frozen=True)
class RotationPrecomp:
    """The body graph's articulated rotations: for every 3-node bridge
    (a, b, c) with centre b, the nodes reachable from a (resp. c) without
    passing b, as boolean masks over the nodes."""

    centers: np.ndarray          # (M,)
    branch_a_masks: np.ndarray   # (M, N) bool
    branch_c_masks: np.ndarray   # (M, N) bool


def build_rotation_precomp(edge_index: np.ndarray, n_nodes: int) -> RotationPrecomp:
    """The rotation branches of the graph, built on the host."""
    adj: List[set] = [set() for _ in range(n_nodes)]
    for i, j in edge_index:
        adj[int(i)].add(int(j))
        adj[int(j)].add(int(i))

    def component_from(start: int, forbidden: int) -> set:
        seen = {start}
        stack = [start]
        while stack:
            u = stack.pop()
            for v in adj[u]:
                if v != forbidden and v not in seen:
                    seen.add(v)
                    stack.append(v)
        return seen

    centers, a_masks, c_masks = [], [], []
    for b in range(n_nodes):
        neigh = sorted(adj[b])
        for ai in range(len(neigh)):
            for ci in range(ai + 1, len(neigh)):
                comp_a = component_from(neigh[ai], b)
                comp_c = component_from(neigh[ci], b)
                if b in comp_a or b in comp_c:
                    continue  # a cycle through b: the rotation would move the pivot
                ma = np.zeros(n_nodes, dtype=bool)
                ma[list(comp_a)] = True
                mc = np.zeros(n_nodes, dtype=bool)
                mc[list(comp_c)] = True
                centers.append(b)
                a_masks.append(ma)
                c_masks.append(mc)
    if not centers:
        return RotationPrecomp(np.zeros(0, np.int32), np.zeros((0, n_nodes), bool), np.zeros((0, n_nodes), bool))
    return RotationPrecomp(np.asarray(centers, np.int32), np.stack(a_masks), np.stack(c_masks))


def _rotations_on(precomp: RotationPrecomp, n_rot: int, max_rot: float, p: float) -> bool:
    return n_rot > 0 and max_rot > 0.0 and p > 0.0 and precomp.centers.shape[0] > 0


def augment_angle_rotations(x: torch.Tensor, draws: Dict[str, torch.Tensor], precomp: RotationPrecomp,
                            n_rot: int, max_rot: float, p: float) -> torch.Tensor:
    """n_rot rotations of an articulated branch around its joint, the same
    bridges for the batch, each sample's angle uniform in +-max_rot degrees
    where its ``u`` < p (else 0). Draws: ``u`` (B,), ``which`` (n_rot,)
    bridge indices, ``side`` (n_rot,) booleans (branch a, else c), ``theta``
    (n_rot, B) uniform in [0, 1)."""
    if not _rotations_on(precomp, n_rot, max_rot, p):
        return x
    max_rad = float(max_rot) * np.pi / 180.0
    apply = (draws["u"] < p).to(x.dtype)
    dev = x.device
    centers = torch.as_tensor(precomp.centers, dtype=torch.long, device=dev)
    a_masks = torch.as_tensor(precomp.branch_a_masks, device=dev)
    c_masks = torch.as_tensor(precomp.branch_c_masks, device=dev)
    coords = x[..., 0:2]
    for r in range(n_rot):
        idx = draws["which"][r]
        mask = torch.where(draws["side"][r], a_masks[idx], c_masks[idx])            # (N,)
        theta = (draws["theta"][r] * 2 - 1) * max_rad * apply
        cos_t, sin_t = torch.cos(theta)[:, None, None], torch.sin(theta)[:, None, None]
        pivot = coords[:, :, centers[idx]][:, :, None, :]                         # (B, T, 1, 2)
        rel = coords - pivot
        rotated = torch.stack([rel[..., 0] * cos_t - rel[..., 1] * sin_t,
                               rel[..., 0] * sin_t + rel[..., 1] * cos_t], dim=-1) + pivot
        coords = torch.where(mask[None, None, :, None], rotated, coords)
    return torch.cat([coords, x[..., 2:]], dim=-1)


def augment_noise_xys(x: torch.Tensor, draws: Dict[str, torch.Tensor], sigma: float, p: float) -> torch.Tensor:
    """A constant offset sigma * ``offset`` per (sample, node) on the axis
    ``axis`` names (0: x, 1: y) and sigma * ``speed`` on the third channel,
    where the sample's ``u`` < p. Draws: ``u`` (B,), ``axis`` (B, N)
    integers in {0, 1}, ``offset`` and ``speed`` (B, N) standard normal."""
    if sigma <= 0.0 or p <= 0.0:
        return x
    apply = (draws["u"] < p).to(x.dtype)[:, None]
    offset = sigma * draws["offset"] * apply
    shifts = [offset * (draws["axis"] == 0), offset * (draws["axis"] == 1)]
    if x.shape[-1] > 2:
        shifts.append(sigma * draws["speed"] * apply)
    shifts += [torch.zeros_like(offset)] * (x.shape[-1] - len(shifts))
    return x + torch.stack(shifts, dim=-1)[:, None]


def augment_linear_interpolate_segments(x: torch.Tensor, draws: Dict[str, torch.Tensor], min_len: int,
                                        max_len: int, p: float) -> torch.Tensor:
    """Where the sample's ``u`` < p, frames [t0, t0 + len) become the line
    between frames t0 - 1 and t0 + len (t0 moved back so that the segment
    fits). Draws: ``u`` (B,), ``length`` (B,) integers in [min_len,
    max_len], ``t0`` (B,) integers in [1, T - 2]."""
    t = x.shape[1]
    if max_len <= 0 or p <= 0.0 or t < 3:
        return x
    seg_len = draws["length"]
    t0 = torch.minimum(draws["t0"], (t - seg_len - 1).clamp(min=1))
    rows = torch.arange(x.shape[0], device=x.device)
    start = x[rows, t0 - 1]                                           # (B, N, F)
    end = x[rows, (t0 + seg_len).clamp(0, t - 1)]
    tt = torch.arange(t, device=x.device)[None, :]
    mask = (tt >= t0[:, None]) & (tt < (t0 + seg_len)[:, None]) & (draws["u"] < p)[:, None]
    alpha = ((tt.to(x.dtype) - (t0[:, None] - 1)) / (seg_len[:, None] + 1)).clamp(0.0, 1.0)
    interp = (1.0 - alpha[..., None, None]) * start[:, None] + alpha[..., None, None] * end[:, None]
    return torch.where(mask[..., None, None], interp, x)


def draw_augmentations(generator: torch.Generator, shape, precomp: RotationPrecomp, cfg) -> Dict[str, dict]:
    """The draws of ``make_augmented_view`` for a batch of windows of
    ``shape`` (B, T, N, F), from ``generator`` (on the batch's device):
    "shift", "rotate", "interp", "noise", each drawn only where its
    augmentation is on (``cfg``'s ContrastiveCfg fields)."""
    b, t, n = shape[0], shape[1], shape[2]
    dev = generator.device

    def uniform(*size):
        return torch.rand(size, generator=generator, device=dev)

    def integers(low, high, *size):
        return torch.randint(low, high, size, generator=generator, device=dev)

    draws: Dict[str, dict] = {"shift": {"u": uniform(b), "mag": integers(cfg.aug_min_shift, cfg.aug_max_shift + 1, b),
                                        "sign": integers(0, 2, b)}}
    if _rotations_on(precomp, cfg.aug_n_rot, cfg.aug_max_rot, cfg.aug_p_rot):
        draws["rotate"] = {"u": uniform(b), "which": integers(0, precomp.centers.shape[0], cfg.aug_n_rot),
                           "side": uniform(cfg.aug_n_rot) < 0.5, "theta": uniform(cfg.aug_n_rot, b)}
    if cfg.aug_max_interp > 0 and cfg.aug_p_interp > 0.0 and t // 2 >= 3:
        draws["interp"] = {"u": uniform(b), "length": integers(cfg.aug_min_interp, cfg.aug_max_interp + 1, b),
                           "t0": integers(1, t // 2 - 1, b)}
    if cfg.aug_noise_sigma > 0.0 and cfg.aug_p_noise > 0.0:
        draws["noise"] = {"u": uniform(b), "axis": integers(0, 2, b, n),
                          "offset": torch.randn((b, n), generator=generator, device=dev),
                          "speed": torch.randn((b, n), generator=generator, device=dev)}
    return draws


def make_augmented_view(x: torch.Tensor, edge_index: np.ndarray, precomp: RotationPrecomp, cfg,
                        draws: Optional[Dict[str, dict]] = None, generator: Optional[torch.Generator] = None):
    """The positive view of a batch of full windows x (B, T, N, F): the
    time-shifted half window -> rotations -> segment interpolation -> noise,
    and its edges recomputed. ``draws`` as ``draw_augmentations`` makes
    them (drawn from ``generator`` when not given). -> (x_aug (B, T // 2,
    N, F), a_aug (B, T // 2, E, 1))."""
    if draws is None:
        draws = draw_augmentations(generator, x.shape, precomp, cfg)
    x_aug = augment_time_shift(x, draws["shift"], cfg.aug_min_shift, cfg.aug_max_shift, cfg.aug_p_shift)
    if "rotate" in draws:
        x_aug = augment_angle_rotations(x_aug, draws["rotate"], precomp, cfg.aug_n_rot, cfg.aug_max_rot,
                                        cfg.aug_p_rot)
    if "interp" in draws:
        x_aug = augment_linear_interpolate_segments(x_aug, draws["interp"], cfg.aug_min_interp, cfg.aug_max_interp,
                                                    cfg.aug_p_interp)
    if "noise" in draws:
        x_aug = augment_noise_xys(x_aug, draws["noise"], cfg.aug_noise_sigma, cfg.aug_p_noise)
    return x_aug, recompute_edges(x_aug, edge_index)
