"""sklearn 1.9's ``HistGradientBoostingClassifier`` restated in torch, at the
settings the JAX package fits it with (``deepof_tpu/posthoc.py:932``:
``max_iter=200``, every other parameter at its default).

What runs where:

- Binning on the host in numpy (``binning.py`` ``_find_binning_thresholds``
  and ``_map_to_bins``): the midpoints of a feature's distinct values when
  there are at most 255, else ``np.percentile(method="averaged_inverted_cdf")``
  at 254 levels; missing values in bin 255; past 200,000 rows the thresholds
  come from a draw of 200,000 rows with replacement.
- Early stopping (on past 10,000 rows): the two seeds drawn from numpy's
  global ``RandomState`` (``gradient_boosting.py:490-491``), the stratified
  10% validation split (``train_test_split(stratify=y)`` restated),
  ``scoring="loss"``, ``n_iter_no_change=10``, ``tol=1e-7``.
- On the device: the float32 gradients and hessians of the half binomial
  loss (2 classes, one tree an iteration) or the half multinomial loss (K
  trees an iteration), the trees' histograms and splits
  (``ops.gbm_kernels``), the float64 raw predictions of the training and
  validation rows, and every prediction.

The K trees of an iteration depend only on that iteration's gradients, so
they grow together: each round pops, in every tree still growing, the best
node (a heap a tree, ordered as sklearn's ``TreeNode.__lt__``), and the
next ones while a split leaves only leaves. The round's splits, histogram
tasks and split-search jobs then go to the device in one non-blocking copy
from a pinned buffer (``_Upload``); the round updates each row's node id,
builds the histograms of the smaller children in one ``gbm_histograms``
launch, which also forms each larger child's as its parent's minus its
sibling's (as sklearn forms it) in the parent's slot, finds the children's
splits in one ``gbm_best_split`` launch and reads the records back in one
host copy. The gradients and hessians go to the kernels as (K, n), one
tree's values contiguous, and the bins as (n, Fp) rows. A node's rows are
the rows whose id names it, taken in ascending order, as sklearn's stable
partition keeps them. Trees: best-first growth with
``max_leaf_nodes=31``, ``min_samples_leaf=20``, ``min_hessian_to_split=1e-3``,
``l2_regularization=0``, leaf values shrunk by ``learning_rate=0.1``.
"""

from __future__ import annotations

import heapq
from typing import List, Optional

import numpy as np
import torch

from deepof_tpu_torch.device import host_array, resolve_device
from deepof_tpu_torch.ops.gbm_kernels import (
    MIN_HESSIAN, MIN_SAMPLES_LEAF, MISSING_BIN, N_BINS, NODE_WIDTH, TASK_WIDTH, gbm_best_split, gbm_histograms,
    gbm_predict, padded_width,
)

ALMOST_INF = 1e300
MAX_BINS = N_BINS - 1
SUBSAMPLE = 200_000
# sklearn's defaults, at which the JAX package fits.
LEARNING_RATE = 0.1
MAX_LEAF_NODES = 31
EARLY_STOPPING_ROWS = 10_000
VALIDATION_FRACTION = 0.1
N_ITER_NO_CHANGE = 10
TOL = 1e-7
HIST_SLOTS = 32  # live histograms a tree: at most 31 splittable nodes and a parent


# --------------------------------------------------------------------------- #
# Binning (host)
# --------------------------------------------------------------------------- #


def find_binning_thresholds(col: np.ndarray, max_bins: int = MAX_BINS) -> np.ndarray:
    """sklearn's ``_find_binning_thresholds`` for an unweighted continuous
    feature: NaNs ignored; no threshold for a constant feature; the distinct
    values' midpoints up to ``max_bins`` of them, else ``max_bins - 1``
    quantiles (duplicates removed); capped at ``ALMOST_INF``. An all-NaN
    feature raises ValueError, as it does in sklearn."""
    col = np.asarray(col, np.float64)
    col = np.sort(col[~np.isnan(col)])
    distinct = np.unique(col)
    if len(distinct) == 0:
        raise ValueError("a feature holds no non-missing value, so it cannot be binned (sklearn's "
                         "HistGradientBoostingClassifier raises on it too)")
    if len(distinct) == 1:
        return np.asarray([], np.float64)
    if len(distinct) <= max_bins:
        thresholds = (distinct[:-1] + distinct[1:]) * 0.5
    else:
        levels = np.linspace(0, 100, num=max_bins + 1)[1:-1]
        thresholds = np.percentile(col, levels, method="averaged_inverted_cdf")
        unique = np.unique(thresholds)
        if unique.shape[0] != thresholds.shape[0]:
            thresholds = unique
    return np.clip(thresholds, None, ALMOST_INF)


def map_to_bins(x: np.ndarray, thresholds: List[np.ndarray]) -> np.ndarray:
    """(F, n) uint8 bins, feature-major: the first i with x <= t[i]
    (``_map_to_bins``' binary search), NaN in ``MISSING_BIN``."""
    x = np.asarray(x, np.float64)
    out = np.empty((x.shape[1], x.shape[0]), np.uint8)
    for j, t in enumerate(thresholds):
        col = x[:, j]
        out[j] = np.searchsorted(t, col, side="left")
        out[j, np.isnan(col)] = MISSING_BIN
    return out


class BinMapper:
    """sklearn's ``_BinMapper`` for continuous features (fit and transform;
    bins feature-major): past ``SUBSAMPLE`` rows the thresholds come from a
    draw of that many rows, with replacement, from ``RandomState(random_state)``."""

    def __init__(self, random_state=None):
        self.random_state = random_state

    def fit(self, x: np.ndarray) -> "BinMapper":
        x = np.asarray(x, np.float64)
        if x.shape[0] > SUBSAMPLE:
            rng = np.random.RandomState(self.random_state)
            x = x.take(rng.choice(x.shape[0], SUBSAMPLE, replace=True), axis=0)
        self.bin_thresholds_ = [find_binning_thresholds(x[:, j]) for j in range(x.shape[1])]
        self.n_bins_non_missing_ = np.array([len(t) + 1 for t in self.bin_thresholds_], np.uint32)
        return self

    def transform(self, x: np.ndarray) -> np.ndarray:
        return map_to_bins(x, self.bin_thresholds_)


# --------------------------------------------------------------------------- #
# The validation split (host)
# --------------------------------------------------------------------------- #


def _approximate_mode(class_counts: np.ndarray, n_draws: int, rng: np.random.RandomState) -> np.ndarray:
    """sklearn's ``_approximate_mode`` (``utils/extmath.py``)."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def stratified_split(y: np.ndarray, test_size: float, seed) -> tuple:
    """(train, test) row indices of ``train_test_split(..., test_size,
    stratify=y, random_state=seed)`` (``StratifiedShuffleSplit``)."""
    n = len(y)
    n_test = int(np.ceil(test_size * n))
    n_train = n - n_test
    classes, y_indices, class_counts = np.unique(y, return_inverse=True, return_counts=True)
    if np.min(class_counts) < 2:
        raise ValueError("The least populated classes in y have only 1 member, which is too few. The minimum "
                         "number of groups for any class cannot be less than 2.")
    if n_train < len(classes) or n_test < len(classes):
        raise ValueError(f"train ({n_train}) and test ({n_test}) sizes must reach the number of classes "
                         f"({len(classes)})")
    class_indices = np.split(np.argsort(y_indices, kind="stable"), np.cumsum(class_counts)[:-1])
    rng = np.random.RandomState(seed)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(len(classes)):
        perm = class_indices[i].take(rng.permutation(class_counts[i]), mode="clip")
        train.extend(perm[:n_i[i]])
        test.extend(perm[n_i[i]:n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


# --------------------------------------------------------------------------- #
# Losses (device)
# --------------------------------------------------------------------------- #


def _logit(p: np.ndarray) -> np.ndarray:
    return np.log(p / (1 - p))


def _baseline(y: np.ndarray, n_trees: int) -> np.ndarray:
    """``fit_intercept_only`` of the half binomial (one tree) or half
    multinomial loss: (n_trees,) float64."""
    if n_trees == 1:
        p = np.average(y)
        eps = 10 * np.finfo(np.float64).eps
        return np.atleast_1d(_logit(np.clip(p, eps, 1 - eps)))
    from scipy.stats import gmean

    out = np.zeros(n_trees, np.float64)
    eps = np.finfo(np.float64).eps
    for k in range(n_trees):
        out[k] = np.clip(np.average(y == k), eps, 1 - eps)
    return np.log(out[None, :] / gmean(out[None, :], axis=1)[:, None]).reshape(-1)


def _softmax_parts(raw: torch.Tensor):
    """(exp(raw - max), their sum over the classes in class order)."""
    p = torch.exp(raw - raw.amax(dim=1, keepdim=True))
    s = p[:, 0]
    for k in range(1, raw.shape[1]):
        s = s + p[:, k]
    return p, s


def gradient_hessian(y: torch.Tensor, raw: torch.Tensor):
    """float32 (n, K) gradients and hessians of the half binomial (K = 1)
    or half multinomial loss, in float64 first (``_loss.pyx``)."""
    if raw.shape[1] == 1:
        r = raw[:, 0]
        yt = y
        e = torch.exp(-r)
        g = ((1 - yt) - yt * e) / (1 + e)
        h = e / ((1 + e) * (1 + e))
        low = r <= -37
        if bool(low.any()):
            e2 = torch.exp(r)
            g = torch.where(low, e2 - yt, g)
            h = torch.where(low, e2, h)
        return g[:, None].to(torch.float32), h[:, None].to(torch.float32)
    p, s = _softmax_parts(raw)
    p = p / s[:, None]
    onehot = (y[:, None] == torch.arange(raw.shape[1], device=raw.device, dtype=y.dtype)).to(raw.dtype)
    return (p - onehot).to(torch.float32), (p * (1.0 - p)).to(torch.float32)


def _log1pexp(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x <= -37, torch.exp(x), torch.where(
        x <= -2, torch.log1p(torch.exp(x)), torch.where(
            x <= 18, torch.log(1.0 + torch.exp(x)), torch.where(x <= 33.3, x + torch.exp(-x), x))))


def loss_per_row(y: torch.Tensor, raw: torch.Tensor) -> torch.Tensor:
    """(n,) float64 half binomial / half multinomial loss of each row."""
    if raw.shape[1] == 1:
        return _log1pexp(raw[:, 0]) - y * raw[:, 0]
    p, s = _softmax_parts(raw)
    return torch.log(s) + raw.amax(dim=1) - raw.gather(1, y.long()[:, None])[:, 0]


def probabilities(raw: torch.Tensor) -> torch.Tensor:
    """``predict_proba`` from raw predictions: the expit of one column, or
    the softmax of K (``utils.extmath.softmax``)."""
    if raw.shape[1] == 1:
        p1 = 1.0 / (1.0 + torch.exp(-raw[:, 0]))
        return torch.stack([1 - p1, p1], dim=1)
    p, s = _softmax_parts(raw)
    return p / s[:, None]


# --------------------------------------------------------------------------- #
# Tree growth (host control, device work)
# --------------------------------------------------------------------------- #


class _Node:
    """A grower node (sklearn's ``TreeNode``): ordered in a heap by gain,
    larger first."""

    __slots__ = ("id", "depth", "n", "sum_g", "sum_h", "value", "rec", "left", "right", "is_leaf", "slot",
                 "missing_left")

    def __init__(self, node_id, depth, n, sum_g, sum_h, value):
        self.id, self.depth, self.n, self.sum_g, self.sum_h, self.value = node_id, depth, n, sum_g, sum_h, value
        self.rec = None
        self.left = self.right = None
        self.is_leaf = False
        self.slot = -1
        self.missing_left = False

    def __lt__(self, other):
        return self.rec[0] > other.rec[0]


class _Tree:
    def __init__(self, k: int, slot0: int):
        self.k = k
        self.nodes: List[_Node] = []
        self.heap: List[_Node] = []
        self.leaves: List[_Node] = []
        self.free = list(range(slot0 + HIST_SLOTS - 1, slot0 - 1, -1))

    def add(self, depth, n, sum_g, sum_h, value) -> _Node:
        node = _Node(len(self.nodes), depth, n, sum_g, sum_h, value)
        self.nodes.append(node)
        return node

    def leaf(self, node: _Node) -> None:
        node.is_leaf = True
        self.leaves.append(node)
        if node.slot >= 0:
            self.free.append(node.slot)
            node.slot = -1


class _Upload:
    """A round's host arrays (int32 and float64) in one host-to-device
    copy: packed into one int32 buffer, pinned where the device is CUDA,
    and copied with one non-blocking copy into a device buffer; ``send``
    returns each array's view there. The host buffer is reused, so a fill
    first waits for the last copy (an event). On the CPU the views are the
    host buffer's own, read before the next fill."""

    def __init__(self, dev):
        self.dev = dev
        self.cuda = dev.type == "cuda"
        self.host = self.device = self.copied = None

    def send(self, arrays) -> list:
        spans, words = [], 0
        for a in arrays:
            if a.dtype not in (np.int32, np.float64):
                raise TypeError(f"_Upload takes int32 and float64 arrays, not {a.dtype}")
            size = a.size * (a.itemsize // 4)
            spans.append((words, size))
            words += size + (size & 1)  # every array starts at an even word: a float64 view
        if self.host is None or self.host.numel() < words:
            cap = max(2 * words, 1024)
            self.host = torch.empty(cap, dtype=torch.int32, pin_memory=self.cuda)
            self.device = torch.empty(cap, dtype=torch.int32, device=self.dev) if self.cuda else self.host
        elif self.copied is not None:
            self.copied.synchronize()
        host = self.host.numpy()
        for (at, size), a in zip(spans, arrays):
            host[at:at + size] = np.ascontiguousarray(a).reshape(-1).view(np.int32)
        if self.cuda:
            self.device[:words].copy_(self.host[:words], non_blocking=True)
            self.copied = torch.cuda.Event()
            self.copied.record()
        out = []
        for (at, size), a in zip(spans, arrays):
            view = self.device[at:at + size]
            out.append((view.view(torch.float64) if a.dtype == np.float64 else view).view(a.shape))
        return out


class _Context:
    """Per-fit device state: the bins as (n, Fp) rows, the histogram pool,
    the feature facts the split search reads and the rounds' upload."""

    def __init__(self, bins_np, n_bins_non_missing, has_missing, n_trees, dev):
        f, self.n = bins_np.shape
        self.bins = torch.zeros((self.n, padded_width(f)), dtype=torch.uint8, device=dev)
        self.bins[:, :f] = torch.as_tensor(bins_np, device=dev).T
        self.nbnm = torch.as_tensor(n_bins_non_missing.astype(np.int32), device=dev)
        self.miss = torch.as_tensor(has_missing.astype(np.uint8), device=dev)
        self.has_missing = has_missing.astype(bool)
        self.pool = torch.empty((n_trees * HIST_SLOTS, f, N_BINS, 3), dtype=torch.float64, device=dev)
        self.upload = _Upload(dev)
        self.dev = dev


def _grow_trees(est, ctx: _Context, g: torch.Tensor, h: torch.Tensor):
    """The K trees of one iteration, grown together from (K, n) gradients
    and hessians. Returns (trees, node ids (K, n) of each row's leaf)."""
    n, n_trees = ctx.n, g.shape[0]
    ids = torch.zeros((n_trees, n), dtype=torch.int32, device=ctx.dev)
    trees = [_Tree(k, k * HIST_SLOTS) for k in range(n_trees)]
    msl = MIN_SAMPLES_LEAF

    def send(splits, tasks, jobs):
        """One upload of a round's splits, histogram tasks and jobs' slots
        and node descriptions (a root's sums come from the split search)."""
        return ctx.upload.send([
            np.asarray(splits, np.int32).reshape(-1, 7), np.asarray(tasks, np.int32).reshape(-1, TASK_WIDTH),
            np.asarray([node.slot for _, node in jobs], np.int32),
            np.asarray([[node.n, node.sum_g, node.sum_h, node.value, float(node.depth == 0)] for _, node in jobs],
                       np.float64).reshape(-1, NODE_WIDTH)])

    def find(jobs, slots, info):
        """The split search of (tree, node) jobs, whose histograms are in
        their slots; one host read of the records."""
        if not jobs:
            return
        recs = gbm_best_split(ctx.pool, slots, info, ctx.nbnm, ctx.miss).cpu().numpy()
        est.host_reads_ += 1
        for (tree, node), rec in zip(jobs, recs):
            node.rec = rec
            if node.depth == 0:
                node.sum_g, node.sum_h = float(rec[12]), float(rec[13])

    # Root: all rows at node 0 (a leaf of value 0 below 2 * min_samples_leaf
    # rows, whatever its histograms hold).
    roots = [t.add(0, n, 0.0, 0.0, 0.0) for t in trees]
    if n < 2 * msl:
        for t, r in zip(trees, roots):
            t.leaf(r)
        return trees, ids
    for t, r in zip(trees, roots):
        r.slot = t.free.pop()
    jobs = list(zip(trees, roots))
    _, tasks, slots, info = send([], [[t.k, 0, r.slot, -1] for t, r in jobs], jobs)
    gbm_histograms(ctx.bins, g, h, ids, tasks, ctx.pool)
    find(jobs, slots, info)
    for t, r in zip(trees, roots):
        if r.sum_h < MIN_HESSIAN or r.rec[0] <= 0:
            t.leaf(r)
        else:
            heapq.heappush(t.heap, r)

    def pop(t, splits, tasks, jobs) -> bool:
        """sklearn's ``split_next`` for tree ``t``: True where a child
        needs a histogram and a split search (queued here), so that the
        tree's next pop waits for them."""
        node = heapq.heappop(t.heap)
        rec = node.rec
        feat, b = int(rec[1]), int(rec[2])
        left = t.add(node.depth + 1, int(rec[6]), float(rec[4]), float(rec[5]), float(rec[10]))
        right = t.add(node.depth + 1, int(rec[9]), float(rec[7]), float(rec[8]), float(rec[11]))
        node.left, node.right = left, right
        node.missing_left = bool(rec[3]) if ctx.has_missing[feat] else left.n > right.n
        splits.append((t.k, node.id, feat, b, int(rec[3]), left.id, right.id))
        n_leaf_nodes = len(t.leaves) + len(t.heap) + 2
        parent_slot, node.slot = node.slot, -1
        if n_leaf_nodes == MAX_LEAF_NODES:
            t.free.append(parent_slot)
            t.leaf(left)
            t.leaf(right)
            while t.heap:
                t.leaf(t.heap.pop())
            return False
        if left.n < 2 * msl:
            t.leaf(left)
        if right.n < 2 * msl:
            t.leaf(right)
        if left.is_leaf and right.is_leaf:
            t.free.append(parent_slot)
            return False
        small, large = (left, right) if left.n < right.n else (right, left)
        small.slot = t.free.pop()
        if not large.is_leaf:  # the parent's slot becomes parent - small
            large.slot = parent_slot
            tasks.append((t.k, small.id, small.slot, parent_slot))
        else:
            t.free.append(parent_slot)
            tasks.append((t.k, small.id, small.slot, -1))
        for child in (left, right):
            if not child.is_leaf:
                jobs.append((t, child))
        if small.is_leaf:  # its histogram serves only the subtraction of this round
            t.free.append(small.slot)
            small.slot = -1
        return True

    while True:
        growing = [t for t in trees if t.heap]
        if not growing:
            break
        # Each tree pops until a split needs its children searched: a split
        # whose children are both leaves pushes nothing, so the next pop
        # sees the heap sklearn's would.
        splits, tasks, jobs = [], [], []
        for t in growing:
            while t.heap and not pop(t, splits, tasks, jobs):
                pass
        split_arr, task_arr, slots, info = send(splits, tasks, jobs)
        _apply_splits(ctx, ids, split_arr)
        if tasks:
            gbm_histograms(ctx.bins, g, h, ids, task_arr, ctx.pool)
        find(jobs, slots, info)
        for t, child in jobs:
            if child.rec[0] <= 0:
                t.leaf(child)
            else:
                heapq.heappush(t.heap, child)
    return trees, ids


def _apply_splits(ctx: _Context, ids: torch.Tensor, s: torch.Tensor) -> None:
    """Move the rows of each split node to its left or right child:
    ``sample_goes_left`` (bin <= threshold, or missing and sent left). A
    tree may split several nodes at once; their rows are disjoint. ``s``:
    (S, 7) int32 on the device, (tree, node, feature, bin, missing left,
    left id, right id)."""
    if not len(s):
        return
    k = s[:, 0].long()
    parent, b, ml, lid, rid = (s[:, i:i + 1] for i in (1, 3, 4, 5, 6))
    col = ctx.bins[:, s[:, 2].long()].T.to(torch.int32)  # (S, n)
    go_left = (col <= b) | ((ml > 0) & (col == MISSING_BIN))
    moved = torch.where(ids[k] == parent, torch.where(go_left, lid, rid), -1)  # -1: not that node's row
    new = torch.full_like(ids, -1).scatter_reduce_(0, k[:, None].expand_as(moved), moved, "amax")
    ids.copy_(torch.where(new >= 0, new, ids))


# --------------------------------------------------------------------------- #
# The estimator
# --------------------------------------------------------------------------- #


class _Ensemble:
    """Flat predictor arrays of every tree (host numpy and a device copy):
    each tree's nodes in sklearn's ``make_predictor`` order (depth first,
    left before right)."""

    FIELDS = ("feature", "threshold", "missing_left", "left", "right", "value", "bin_threshold", "count",
              "is_leaf")

    def __init__(self):
        self.parts = {f: [] for f in self.FIELDS}
        self.roots: List[int] = []
        self.size = 0
        self._dev = None

    def add_tree(self, tree: _Tree, thresholds, nbnm) -> None:
        order: List[_Node] = []

        def visit(node):
            order.append(node)
            if not node.is_leaf:
                visit(node.left)
                visit(node.right)

        visit(tree.nodes[0])
        index = {node.id: self.size + i for i, node in enumerate(order)}
        cols = {f: [] for f in self.FIELDS}
        for node in order:
            leaf = node.is_leaf
            feat = -1 if leaf else int(node.rec[1])
            b = 0 if leaf else int(node.rec[2])
            if leaf:
                thr = 0.0
            elif b == int(nbnm[feat]) - 1:
                thr = np.inf
            else:
                thr = float(thresholds[feat][b])
            cols["feature"].append(feat)
            cols["threshold"].append(thr)
            cols["missing_left"].append(int(node.missing_left))
            cols["left"].append(-1 if leaf else index[node.left.id])
            cols["right"].append(-1 if leaf else index[node.right.id])
            cols["value"].append(node.value)
            cols["bin_threshold"].append(b)
            cols["count"].append(node.n)
            cols["is_leaf"].append(int(leaf))
        for f in self.FIELDS:
            self.parts[f].append(np.asarray(cols[f]))
        self.roots.append(self.size)
        self.size += len(order)
        self._dev = None

    def arrays(self) -> dict:
        return {f: (np.concatenate(v) if v else np.zeros(0)) for f, v in self.parts.items()}

    def device_arrays(self, dev, first_tree: int = 0) -> tuple:
        """(feature, threshold, missing_left, left, right, value, roots) on
        ``dev`` for the trees from ``first_tree`` on (their child indices
        rebased)."""
        if first_tree == 0 and self._dev is not None and self._dev[0] == dev:
            return self._dev[1]
        start = self.roots[first_tree] if first_tree < len(self.roots) else self.size
        a = {f: np.concatenate(v)[start:] if v else np.zeros(0) for f, v in self.parts.items()}
        left = np.where(a["left"] >= 0, a["left"] - start, -1)
        right = np.where(a["right"] >= 0, a["right"] - start, -1)
        out = (
            torch.as_tensor(a["feature"].astype(np.int32), device=dev),
            torch.as_tensor(a["threshold"].astype(np.float64), device=dev),
            torch.as_tensor(a["missing_left"].astype(np.uint8), device=dev),
            torch.as_tensor(left.astype(np.int32), device=dev),
            torch.as_tensor(right.astype(np.int32), device=dev),
            torch.as_tensor(a["value"].astype(np.float64), device=dev),
            torch.as_tensor((np.asarray(self.roots[first_tree:], np.int64) - start).astype(np.int32), device=dev),
        )
        if first_tree == 0:
            self._dev = (dev, out)
        return out


class HistGradientBoostingClassifier:
    """sklearn's ``HistGradientBoostingClassifier`` (log loss, continuous
    features, no sample weights) at its defaults but ``max_iter``, with
    ``fit``, ``predict``, ``predict_proba``, ``classes_`` and ``n_iter_``.
    The seeds come from numpy's global state, as with ``random_state=None``.
    Trees grow on ``device``; ``predictors_`` holds each tree's node arrays
    (sklearn's predictor fields) for inspection; ``n_rows_`` / ``n_train_``
    the rows given and trained on, ``host_reads_`` the device-to-host
    copies the fit waited for (a round's split records, an iteration's
    scores)."""

    def __init__(self, max_iter: int = 100, device="cuda"):
        self.max_iter = max_iter
        self.device = device

    def get_params(self, deep: bool = True) -> dict:
        return {"max_iter": self.max_iter, "device": self.device}

    @property
    def n_iter_(self) -> int:
        return len(self._ensemble.roots) // self.n_trees_per_iteration_

    def fit(self, X, y) -> "HistGradientBoostingClassifier":
        dev = resolve_device(self.device)
        x = np.asarray(host_array(X), np.float64)
        y = np.asarray(host_array(y))
        if np.isinf(x).any():
            raise ValueError("Input X contains infinity")
        self.classes_, y_enc = np.unique(y, return_inverse=True)
        y_enc = y_enc.astype(np.float64)
        n_classes = len(self.classes_)
        self.n_trees_per_iteration_ = 1 if n_classes <= 2 else n_classes
        n_trees = self.n_trees_per_iteration_

        self._random_seed = np.random.randint(np.iinfo(np.uint32).max, dtype="u8")
        np.random.randint(np.iinfo(np.uint32).max, dtype="u8")  # the feature-subsample seed (unused at max_features=1)

        n_samples = x.shape[0]
        self.do_early_stopping_ = n_samples > EARLY_STOPPING_ROWS
        if self.do_early_stopping_:
            train, val = stratified_split(y_enc, VALIDATION_FRACTION, self._random_seed)
            x_train, y_train, x_val, y_val = x[train], y_enc[train], x[val], y_enc[val]
        else:
            x_train, y_train = x, y_enc

        self._bin_mapper = BinMapper(random_state=self._random_seed).fit(x_train)
        bins_np = self._bin_mapper.transform(x_train)
        has_missing = (bins_np == MISSING_BIN).any(axis=1)
        ctx = _Context(bins_np, self._bin_mapper.n_bins_non_missing_, has_missing, n_trees, dev)
        self._baseline_prediction = _baseline(y_train, n_trees)
        base = torch.as_tensor(self._baseline_prediction, device=dev)
        y_t = torch.as_tensor(y_train, device=dev)
        raw = base[None, :].expand(len(y_train), n_trees).clone()
        self._ensemble = _Ensemble()
        self.train_score_, self.validation_score_ = [], []
        self.host_reads_ = 0  # device-to-host copies the fit waited for
        if self.do_early_stopping_:
            x_val_t = torch.as_tensor(x_val, device=dev)
            y_val_t = torch.as_tensor(y_val, device=dev)
            raw_val = base[None, :].expand(len(y_val), n_trees).clone()

        def scores():
            """The early-stopping check after an iteration (sklearn's
            ``scoring="loss"`` on the validation rows)."""
            parts = [loss_per_row(y_t, raw).mean(), loss_per_row(y_val_t, raw_val).mean()]
            vals = torch.stack(parts).cpu().numpy()
            self.host_reads_ += 1
            self.train_score_.append(-float(vals[0]))
            self.validation_score_.append(-float(vals[1]))
            return self._should_stop(self.validation_score_)

        if self.do_early_stopping_:
            scores()
        thresholds, nbnm = self._bin_mapper.bin_thresholds_, self._bin_mapper.n_bins_non_missing_
        for _ in range(self.max_iter):
            g, h = gradient_hessian(y_t, raw)
            trees, ids = _grow_trees(self, ctx, g.T.contiguous(), h.T.contiguous())
            values = torch.zeros((n_trees, max(len(t.nodes) for t in trees)), dtype=torch.float64)
            first = len(self._ensemble.roots)
            for t in trees:
                for leaf in t.leaves:
                    leaf.value *= LEARNING_RATE
                    values[t.k, leaf.id] = leaf.value
                self._ensemble.add_tree(t, thresholds, nbnm)
            raw += values.to(dev).gather(1, ids.long()).T
            if self.do_early_stopping_:
                gbm_predict(x_val_t, *self._ensemble.device_arrays(dev, first), raw_val)
                if scores():
                    break
        self.train_score_ = np.asarray(self.train_score_)
        self.validation_score_ = np.asarray(self.validation_score_)
        self.n_features_in_ = x.shape[1]
        self.n_rows_, self.n_train_ = n_samples, len(y_train)
        return self

    @staticmethod
    def _should_stop(scores) -> bool:
        reference_position = N_ITER_NO_CHANGE + 1
        if len(scores) < reference_position:
            return False
        reference_score = scores[-reference_position] + TOL
        return not any(score > reference_score for score in scores[-reference_position + 1:])

    @property
    def predictors_(self) -> dict:
        """Every tree's node arrays, concatenated, with ``roots``."""
        out = self._ensemble.arrays()
        out["roots"] = np.asarray(self._ensemble.roots)
        return out

    def _raw_predict(self, X) -> torch.Tensor:
        dev = resolve_device(self.device)
        x = X.to(dev, torch.float64) if isinstance(X, torch.Tensor) else torch.as_tensor(
            np.asarray(host_array(X), np.float64), device=dev)
        x = x.contiguous()
        if x.ndim != 2 or x.shape[1] != self.n_features_in_:
            raise ValueError(f"X has {tuple(x.shape)}; the estimator was fitted with {self.n_features_in_} features")
        base = torch.as_tensor(self._baseline_prediction, device=dev)
        raw = base[None, :].expand(x.shape[0], self.n_trees_per_iteration_).clone()
        return gbm_predict(x, *self._ensemble.device_arrays(dev), raw)

    def predict_proba(self, X):
        """(m, n_classes) float64 probabilities: a tensor on the
        estimator's device for a tensor ``X``, else a numpy array."""
        proba = probabilities(self._raw_predict(X))
        return proba if isinstance(X, torch.Tensor) else proba.cpu().numpy()

    def predict(self, X) -> np.ndarray:
        proba = self.predict_proba(X)
        idx = proba.argmax(dim=1).cpu().numpy() if isinstance(proba, torch.Tensor) else proba.argmax(axis=1)
        return self.classes_[idx]
