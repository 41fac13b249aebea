"""The three kernels of the gradient-boosted tree fit (``deepof_tpu_torch.gbm``):
per-node histograms, the best split of each node, and the ensemble's raw
predictions.

No TPU kernel is replaced: the JAX package fits sklearn's
``HistGradientBoostingClassifier`` on the host (``deepof_tpu/posthoc.py:932``).
The port restates that estimator, and its three hot loops run here. Built
from library calls, one tree of 31 leaves takes tens of small launches a
node and, with ``index_add_``, float sums whose order changes from run to
run on CUDA. Each kernel keeps sklearn's order of additions, so that a fit
gives sklearn's trees and two fits on the card give the same bits:

- :func:`gbm_histograms`: for each (tree, node, slot, parent) task, the
  float64 sums of the float32 gradients and hessians and the row count in
  every (feature, bin), each bin's rows added in ascending row order
  (sklearn's ``_build_histogram``); where the task names a parent slot, the
  parent's histograms then become parent minus this child (sklearn's
  ``_subtract_histograms``: the larger sibling). A row belongs to the node
  its tree's ``node_ids`` entry names. A CTA is a task and
  ``HIST_FEATURES`` features: it walks the tree's node ids once, stages the
  node's rows (their g, h and the group's bins, one 16-byte slice of a
  row-major bin row) in shared memory, and a warp a feature adds them.
  Bound: the node rows' bins, g and h read once and the histograms written
  once, the parent's read and written once (bytes).
- :func:`gbm_best_split`: for each task, every feature's bins scanned left
  to right (and right to left when the feature has missing values) with
  sklearn's gain and its ``min_samples_leaf`` / ``min_hessian_to_split``
  rules (``splitting.pyx``), the first feature of the largest gain. A root
  task forms the node's sums from its first feature's bins in numpy's
  pairwise order, as sklearn's ``histogram_array["sum_gradients"].sum()``
  does. A CTA stages ``SPLIT_FEATURES`` histograms in shared memory and a
  thread scans each (feature, direction) from there. Bound: one read of
  the tasks' histograms (bytes).
- :func:`gbm_predict`: each row through every tree of the given iterations,
  the leaf values added into float64 raw predictions in iteration order
  (sklearn's ``_raw_predict``). Bound: the rows' features read once
  (bytes).

On a CUDA tensor each wrapper launches ``csrc/gbm.cu`` (or raises); on a
CPU tensor it runs the plain version beside it, which the CPU tests hold
against sklearn. There is no fallback from a CUDA tensor.
"""

from __future__ import annotations

import torch

from deepof_tpu_torch.ops import cuda_build

N_BINS = 256
MISSING_BIN = N_BINS - 1
# Columns of a split record (float64, one row a task).
RECORD = ("gain", "feature", "bin", "missing_left", "sum_g_left", "sum_h_left", "n_left",
          "sum_g_right", "sum_h_right", "n_right", "value_left", "value_right", "sum_g", "sum_h")
RECORD_WIDTH = len(RECORD)
# Columns of a task's node description (float64): rows, sum of g, sum of h,
# value, and 1 for a root (whose sums the split search forms itself).
NODE_WIDTH = 5
# Columns of a histogram task (int32): tree, node, slot, and the parent's
# slot to subtract the histograms from (-1: none).
TASK_WIDTH = 4
# Features a CTA of gbm_histograms (csrc/gbm.cu kHistFeatures): the bins'
# rows are padded to a multiple of it.
HIST_FEATURES = 16
# sklearn's defaults, at which the JAX package fits: a child needs this many
# rows and this sum of hessians; no L2 penalty on the leaf values.
MIN_SAMPLES_LEAF = 20
MIN_HESSIAN = 1e-3
L2 = 0.0


def _pairwise_sum_256(x: torch.Tensor) -> torch.Tensor:
    """numpy's pairwise sum of 256 values along the last axis: two halves
    of 128, each summed by eight strided accumulators combined as
    ((r0 + r1) + (r2 + r3)) + ((r4 + r5) + (r6 + r7))."""
    blocks = x.reshape(*x.shape[:-1], 2, 16, 8)
    r = blocks[..., 0, :]
    for i in range(1, 16):
        r = r + blocks[..., i, :]
    halves = ((r[..., 0] + r[..., 1]) + (r[..., 2] + r[..., 3])) + ((r[..., 4] + r[..., 5]) + (r[..., 6] + r[..., 7]))
    return halves[..., 0] + halves[..., 1]


# --------------------------------------------------------------------------- #
# Plain versions
# --------------------------------------------------------------------------- #


def padded_width(f: int) -> int:
    """The row width of the bins that :func:`gbm_histograms` takes for
    ``f`` features: a multiple of ``HIST_FEATURES``."""
    return -(-f // HIST_FEATURES) * HIST_FEATURES


def gbm_histograms_plain(bins: torch.Tensor, g: torch.Tensor, h: torch.Tensor, node_ids: torch.Tensor,
                         tasks: torch.Tensor, pool: torch.Tensor) -> torch.Tensor:
    """The arguments and result of :func:`gbm_histograms`: every task's
    (feature, bin) sums by one 1-d ``index_add_`` a component, which adds
    in index order on the CPU (on CUDA it adds by atomics, in no fixed
    order). The entries run task by task and row by row (ascending), so
    each bin's rows are added in ascending order. Then each task with a
    parent slot subtracts its histograms from the parent's."""
    f = pool.shape[1]
    dev = bins.device
    tasks = tasks.to(dev, torch.int64)
    t = tasks.shape[0]
    if t == 0:
        return pool
    member = node_ids[tasks[:, 0]] == tasks[:, 1:2].to(node_ids.dtype)  # (T, n)
    t_idx, rows = torch.nonzero(member, as_tuple=True)  # task-major, rows ascending
    trees = tasks[t_idx, 0]
    flat = ((t_idx[:, None] * f + torch.arange(f, device=dev)[None, :]) * N_BINS + bins[rows, :f].long()).flatten()
    out = torch.empty((t * f * N_BINS, 3), dtype=torch.float64, device=dev)
    for c, src in enumerate((g[trees, rows], h[trees, rows], torch.ones(len(rows), dtype=torch.float32, device=dev))):
        col = torch.zeros(t * f * N_BINS, dtype=torch.float64, device=dev)
        col.index_add_(0, flat, src.to(torch.float64)[:, None].expand(-1, f).flatten())
        out[:, c] = col
    out = out.view(t, f, N_BINS, 3)
    pool[tasks[:, 2]] = out
    sub = tasks[:, 3] >= 0
    if bool(sub.any()):
        parents = tasks[sub, 3]
        pool[parents] = pool[parents] - out[sub]
    return pool


def _node_value(sum_g: torch.Tensor, sum_h: torch.Tensor) -> torch.Tensor:
    """sklearn's ``compute_node_value``: -G / ((H + L2) + 1e-15), where
    adding L2 = 0.0 changes no hessian sum's bits."""
    return -sum_g / (sum_h + 1e-15)


def _gains(gl, hl, gr, hr, loss_node):
    return (loss_node - gl * _node_value(gl, hl)) - gr * _node_value(gr, hr)


def _scan_best(gain: torch.Tensor, ok: torch.Tensor):
    """(the largest gain of each scan over its valid bins, -inf where none;
    the first bin of it in scan order)."""
    return torch.where(ok, gain, -torch.inf).max(dim=-1)


def gbm_best_split_plain(pool: torch.Tensor, slots: torch.Tensor, nodes: torch.Tensor, n_bins_non_missing: torch.Tensor,
                         has_missing: torch.Tensor) -> torch.Tensor:
    """The arguments and result of :func:`gbm_best_split`: the scans as
    sequential cumulative sums over the bins (a CPU ``cumsum``), sklearn's
    ``continue`` / ``break`` rules as masks (a break holds for every later
    bin of the scan), each direction's best apart, the right-to-left one
    taken where its gain is strictly larger."""
    hist = pool[slots.long()]  # (T, F, 256, 3)
    dev = pool.device
    nodes = nodes.clone()
    root = nodes[:, 4] > 0
    if bool(root.any()):
        nodes[root, 1:3] = _pairwise_sum_256(hist[root, 0, :, :2].transpose(-1, -2))
    # Bins from the largest feature's count of non-missing bins on are empty
    # (0 in every sum), so the scans stop there.
    width = max(2, int(n_bins_non_missing.max()))
    hist = hist[..., :width, :]
    n, sg, sh = (nodes[:, i][:, None, None] for i in range(3))
    loss_node = sg * nodes[:, 3][:, None, None]
    nbnm = n_bins_non_missing.to(dev, torch.int64)[None, :, None]
    miss = has_missing.to(dev, torch.bool)[None, :, None]
    bins = torch.arange(width, device=dev)[None, None, :]
    msl, mh = MIN_SAMPLES_LEAF, MIN_HESSIAN

    # Left to right over bins [0, nbnm - 1 + has_missing), missing values right.
    gl, hl, nl = torch.cumsum(hist, dim=2).unbind(-1)
    gr, hr, nr = sg - gl, sh - hl, n - nl
    enough_l, enough_r = nl >= msl, nr >= msl
    brk = enough_l & (~enough_r | ((hl >= mh) & (hr < mh)))
    ok = (bins < nbnm - 1 + miss.long()) & enough_l & enough_r & (hl >= mh) & (hr >= mh)
    ok &= torch.cumsum(brk & (bins < nbnm - 1 + miss.long()), dim=-1) == 0
    gain, bin_ = _scan_best(_gains(gl, hl, gr, hr, loss_node), ok)
    found = gain > 0  # else the kernel's empty best: gain -1, bin 0, sums 0
    best = {"gain": torch.where(found, gain, -1.0), "bin": torch.where(found, bin_, 0),
            "missing_left": torch.zeros_like(found),
            **{key: torch.where(found, v.gather(-1, bin_[..., None])[..., 0], 0.0)
               for key, v in (("gl", gl), ("hl", hl), ("nl", nl))}}

    # Right to left over bins nbnm - 2 .. 0, missing values left (features
    # with missing values only): the right side of a split after bin b sums
    # bins nbnm - 1 .. b + 1, added from the top (bins past nbnm hold 0).
    if bool(miss.any()):
        top = torch.cumsum(hist[..., 1:, :].flip(2), dim=2).flip(2)  # [b] = bins b + 1 .. width - 1
        gr2, hr2, nr2 = torch.cat([top, torch.zeros_like(top[..., :1, :])], dim=2).unbind(-1)  # after bin b
        gl2, hl2, nl2 = sg - gr2, sh - hr2, n - nr2
        inside = (bins <= nbnm - 2) & miss
        enough_r, enough_l = nr2 >= msl, nl2 >= msl
        brk = inside & enough_r & (~enough_l | ((hr2 >= mh) & (hl2 < mh)))
        ok = inside & enough_l & enough_r & (hl2 >= mh) & (hr2 >= mh)
        ok &= torch.cumsum(brk.flip(-1), dim=-1).flip(-1) == 0
        gain, rev = _scan_best(_gains(gl2, hl2, gr2, hr2, loss_node).flip(-1), ok.flip(-1))
        bin2 = width - 1 - rev
        take = (gain > best["gain"]) & (gain > 0)
        for key, value in (("gain", gain), ("bin", bin2), ("missing_left", torch.ones_like(take)),
                           ("gl", gl2.gather(-1, bin2[..., None])[..., 0]),
                           ("hl", hl2.gather(-1, bin2[..., None])[..., 0]),
                           ("nl", nl2.gather(-1, bin2[..., None])[..., 0])):
            best[key] = torch.where(take, value, best[key])

    feat = best["gain"].max(dim=1).indices  # the first feature of the largest gain
    rec = {k: v.gather(1, feat[:, None])[:, 0] for k, v in best.items()}
    sg1, sh1, n1 = nodes[:, 1], nodes[:, 2], nodes[:, 0]
    gl_b, hl_b = rec["gl"], rec["hl"]
    return torch.stack([
        rec["gain"], feat.to(torch.float64), rec["bin"].to(torch.float64), rec["missing_left"].to(torch.float64),
        gl_b, hl_b, rec["nl"], sg1 - gl_b, sh1 - hl_b, n1 - rec["nl"],
        _node_value(gl_b, hl_b), _node_value(sg1 - gl_b, sh1 - hl_b), sg1, sh1,
    ], dim=1)


def gbm_predict_plain(x: torch.Tensor, feature: torch.Tensor, threshold: torch.Tensor, missing_left: torch.Tensor,
                      left: torch.Tensor, right: torch.Tensor, value: torch.Tensor, roots: torch.Tensor,
                      raw: torch.Tensor) -> torch.Tensor:
    """The arguments and result of :func:`gbm_predict`: every (row, tree)
    stepped down together, then the leaf values added to ``raw`` one
    iteration at a time."""
    m, k = raw.shape
    n_trees = roots.shape[0]
    if m == 0 or n_trees == 0:
        return raw
    node = roots.long()[None, :].expand(m, n_trees).clone()
    rows = torch.arange(m, device=x.device)[:, None]
    nan = torch.isnan(x)
    while True:
        lft = left[node].long()
        inner = lft >= 0
        if not bool(inner.any()):
            break
        f = feature[node].long().clamp(min=0)
        go_left = torch.where(nan[rows, f], missing_left[node] > 0, x[rows, f] <= threshold[node])
        node = torch.where(inner, torch.where(go_left, lft, right[node].long()), node)
    leaf = value[node].view(m, n_trees // k, k)
    for it in range(leaf.shape[1]):
        raw += leaf[:, it]
    return raw


# --------------------------------------------------------------------------- #
# The wrappers
# --------------------------------------------------------------------------- #


# Features a CTA of the split search scans (csrc/gbm.cu kSplitFeatures).
SPLIT_FEATURES = 8
_COUNTERS = {}


def _counters(dev: torch.device, t: int) -> torch.Tensor:
    """The split search's per-task tickets on ``dev``: zeros, which every
    launch leaves at zero."""
    have = _COUNTERS.get(dev)
    if have is None or have.numel() < t:
        have = torch.zeros(max(t, 256), dtype=torch.int32, device=dev)
        _COUNTERS[dev] = have
    return have


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_cuda(name: str, tensors) -> None:
    dev = tensors[0].device
    for x in tensors:
        if x.device != dev:
            raise ValueError(f"{name}: every tensor must lie on one device")
        if not x.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel takes contiguous tensors")


def gbm_histograms(bins: torch.Tensor, g: torch.Tensor, h: torch.Tensor, node_ids: torch.Tensor,
                   tasks: torch.Tensor, pool: torch.Tensor) -> torch.Tensor:
    """Histograms of (tree, node) tasks into slots of ``pool``, and the
    larger siblings' by subtraction.

    Args:
        bins: (n, Fp) uint8, the binned features, row-major, Fp =
            ``padded_width(F)`` (columns past F unread).
        g, h: (K, n) float32 gradients and hessians, a row a tree.
        node_ids: (K, n) int32, each row's node in each tree.
        tasks: (T, TASK_WIDTH) int32 (tree, node, slot, parent slot or -1)
            on the host or the device.
        pool: (S, F, 256, 3) float64; slot ``slot`` receives the task's
            (sum g, sum h, count) of every (feature, bin); then, where the
            task has a parent slot, that slot becomes itself minus them.

    Returns ``pool``."""
    if bins.dtype != torch.uint8 or g.dtype != torch.float32 or h.dtype != torch.float32:
        raise TypeError("gbm_histograms takes uint8 bins and float32 g, h")
    if node_ids.dtype != torch.int32 or pool.dtype != torch.float64:
        raise TypeError("gbm_histograms takes int32 node ids and a float64 pool")
    n, fp = bins.shape
    f = pool.shape[1]
    k = g.shape[0]
    if g.shape != (k, n) or h.shape != (k, n) or node_ids.shape != (k, n) or pool.shape[2:] != (N_BINS, 3) \
            or fp != padded_width(f) or tasks.shape[1:] != (TASK_WIDTH,):
        raise ValueError(f"gbm_histograms: shapes bins {tuple(bins.shape)}, g {tuple(g.shape)}, "
                         f"node_ids {tuple(node_ids.shape)}, tasks {tuple(tasks.shape)}, pool {tuple(pool.shape)}")
    if bins.device.type == "cpu":
        return gbm_histograms_plain(bins, g, h, node_ids, tasks.cpu(), pool)
    if bins.device.type != "cuda":
        raise ValueError(f"unsupported device {bins.device}")
    tasks = tasks.to(bins.device, torch.int32).contiguous()
    _check_cuda("gbm_histograms", (bins, g, h, node_ids, tasks, pool))
    t = tasks.shape[0]
    if t == 0 or n == 0:
        return pool
    with torch.cuda.device(bins.device):
        err = cuda_build.load("gbm").gbm_histograms_launch(
            bins.data_ptr(), g.data_ptr(), h.data_ptr(), node_ids.data_ptr(), tasks.data_ptr(), pool.data_ptr(),
            n, f, fp, t, _stream(bins))
    if err != 0:
        raise RuntimeError(f"gbm_histograms launch failed with CUDA error {err} (n={n}, F={f}, K={k}, T={t})")
    gbm_histograms.launches += 1
    return pool


def gbm_best_split(pool: torch.Tensor, slots: torch.Tensor, nodes: torch.Tensor, n_bins_non_missing: torch.Tensor,
                   has_missing: torch.Tensor) -> torch.Tensor:
    """The best split of each task's node.

    Args:
        pool: (S, F, 256, 3) float64 histograms.
        slots: (T,) int32, each task's slot of ``pool``.
        nodes: (T, NODE_WIDTH) float64: rows, sum g, sum h, value, root flag.
        n_bins_non_missing: (F,) int32; has_missing: (F,) uint8.

    Returns (T, RECORD_WIDTH) float64 records (``RECORD``); a gain of -1
    where no bin of any feature satisfies the rules (``MIN_SAMPLES_LEAF``,
    ``MIN_HESSIAN``)."""
    if pool.dtype != torch.float64 or nodes.dtype != torch.float64:
        raise TypeError("gbm_best_split takes float64 histograms and nodes")
    t = slots.shape[0]
    if nodes.shape != (t, NODE_WIDTH) or n_bins_non_missing.shape != (pool.shape[1],):
        raise ValueError(f"gbm_best_split: shapes slots {tuple(slots.shape)}, nodes {tuple(nodes.shape)}")
    if pool.device.type == "cpu":
        return gbm_best_split_plain(pool, slots, nodes, n_bins_non_missing, has_missing)
    if pool.device.type != "cuda":
        raise ValueError(f"unsupported device {pool.device}")
    dev = pool.device
    slots = slots.to(dev, torch.int32).contiguous()
    nodes = nodes.to(dev).contiguous()
    nbnm = n_bins_non_missing.to(dev, torch.int32).contiguous()
    miss = has_missing.to(dev, torch.uint8).contiguous()
    _check_cuda("gbm_best_split", (pool, slots, nodes, nbnm, miss))
    out = torch.empty((t, RECORD_WIDTH), dtype=torch.float64, device=dev)
    if t == 0:
        return out
    blocks = -(-pool.shape[1] // SPLIT_FEATURES)
    scratch = torch.empty(t * blocks * 7, dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        err = cuda_build.load("gbm").gbm_best_split_launch(
            pool.data_ptr(), slots.data_ptr(), nodes.data_ptr(), nbnm.data_ptr(), miss.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), _counters(dev, t).data_ptr(), pool.shape[1], t, MIN_SAMPLES_LEAF, MIN_HESSIAN, L2,
            _stream(pool))
    if err != 0:
        raise RuntimeError(f"gbm_best_split launch failed with CUDA error {err} (F={pool.shape[1]}, T={t})")
    gbm_best_split.launches += 1
    return out


def gbm_predict(x: torch.Tensor, feature: torch.Tensor, threshold: torch.Tensor, missing_left: torch.Tensor,
                left: torch.Tensor, right: torch.Tensor, value: torch.Tensor, roots: torch.Tensor,
                raw: torch.Tensor) -> torch.Tensor:
    """Add the trees' leaf values to ``raw`` in place.

    Args:
        x: (m, F) float64 rows.
        feature (int32), threshold (float64), missing_left (uint8), left and
            right (int32; left -1 at a leaf), value (float64): the flat node
            arrays of every tree, child indices global.
        roots: (n_iter * K,) int32, the root of tree k of iteration i at
            i * K + k.
        raw: (m, K) float64, added to in iteration order.

    Returns ``raw``."""
    m, k = raw.shape
    if x.dtype != torch.float64 or raw.dtype != torch.float64 or x.shape[0] != m:
        raise ValueError(f"gbm_predict takes float64 x (m, F) and raw (m, K); got {tuple(x.shape)}, {tuple(raw.shape)}")
    if roots.shape[0] % max(k, 1):
        raise ValueError(f"gbm_predict: {roots.shape[0]} roots for K={k}")
    if x.device.type == "cpu":
        return gbm_predict_plain(x, feature, threshold, missing_left, left, right, value, roots, raw)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    arrays = (x, feature, threshold, missing_left, left, right, value, roots, raw)
    _check_cuda("gbm_predict", arrays)
    if feature.dtype != torch.int32 or left.dtype != torch.int32 or right.dtype != torch.int32 \
            or roots.dtype != torch.int32 or missing_left.dtype != torch.uint8 \
            or threshold.dtype != torch.float64 or value.dtype != torch.float64:
        raise TypeError("gbm_predict: node arrays of the wrong types")
    n_iter = roots.shape[0] // k if k else 0
    if m == 0 or n_iter == 0:
        return raw
    with torch.cuda.device(x.device):
        err = cuda_build.load("gbm").gbm_predict_launch(
            x.data_ptr(), feature.data_ptr(), threshold.data_ptr(), missing_left.data_ptr(), left.data_ptr(),
            right.data_ptr(), value.data_ptr(), roots.data_ptr(), raw.data_ptr(), m, x.shape[1], k, n_iter, _stream(x))
    if err != 0:
        raise RuntimeError(f"gbm_predict launch failed with CUDA error {err} (m={m}, K={k}, iterations={n_iter})")
    gbm_predict.launches += 1
    return raw


# Kernel launches since the last reset (set to 0 to reset).
gbm_histograms.launches = 0
gbm_best_split.launches = 0
gbm_predict.launches = 0
