"""The tree fit's kernels' plain versions (``deepof_tpu_torch.ops.gbm_kernels``)
against restatements of what they replace, bit for bit, on the CPU:

- ``gbm_histograms_plain`` with the siblings' subtraction in the call
  (tasks (tree, node, slot, parent slot)) against the composition it
  replaces in the estimator's rounds: each task's histograms summed densely
  in ascending row order, then ``pool[parent] - pool[sibling]``. A seeded
  three-tree state of ragged row counts, features past a multiple of 16
  and a missing bin; the roots, children whose larger sibling is split on,
  and children whose larger sibling is a leaf (no parent slot).
- ``gbm_best_split_plain`` against the serial scan of sklearn's
  ``find_node_split`` (both directions of a feature in one pass, a running
  best, the first feature of the largest gain), at root tasks (the node's
  sums by numpy's pairwise sum of the first feature's bins) and at
  children with given sums.
- The estimator's round upload (``gbm._Upload``) on the CPU, and the
  wrappers' refusals.
"""

import numpy as np
import pytest
import torch

from deepof_tpu_torch import gbm
from deepof_tpu_torch.ops import gbm_kernels as gk

N_ROWS, N_FEATURES, N_TREES = 347, 19, 3


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _state(seed=0):
    """Seeded bins (F, n) (few-valued features, a missing bin in every
    third), nbnm, has_missing, g / h (K, n) float32 (feature 0 informative)
    and node ids (K, n):
    tree k's rows split into nodes 1 (the parent, ~45%) and 2, node 1 into
    its children 3 and 4, 4 into 5 and 6."""
    rng = np.random.default_rng(seed)
    nbnm = np.where(rng.random(N_FEATURES) < 0.3, rng.integers(2, 9, N_FEATURES), 255).astype(np.int32)
    has_missing = np.arange(N_FEATURES) % 3 == 0
    bins = (rng.random((N_FEATURES, N_ROWS)) * nbnm[:, None]).astype(np.uint8)
    bins[has_missing[:, None] & (rng.random(bins.shape) < 0.1)] = gk.MISSING_BIN
    # Feature 0's low bins and its missing values pull g one way: sending
    # the missing values left, with the low bins, is its best split.
    low = (bins[0] < nbnm[0] // 2) | (bins[0] == gk.MISSING_BIN)
    g = (rng.normal(size=(N_TREES, N_ROWS)) + np.where(low, 1.5, -1.5)).astype(np.float32)
    h = rng.uniform(0.01, 0.25, size=(N_TREES, N_ROWS)).astype(np.float32)
    u = rng.random((N_TREES, N_ROWS))
    parent_ids = np.where(u < 0.45, 1, 2)
    child_ids = np.where(u < 0.15, 3, np.where(u < 0.3, 5, np.where(u < 0.45, 6, 2)))
    return {"bins": bins, "nbnm": nbnm, "has_missing": has_missing, "g": g, "h": h,
            "parent_ids": parent_ids.astype(np.int32), "child_ids": child_ids.astype(np.int32)}


def _dense(bins, g, h, mask):
    """(F, 256, 3) float64 sums of one node's rows, added row by row in
    ascending order."""
    f = bins.shape[0]
    out = np.zeros((f, gk.N_BINS, 3))
    feats = np.arange(f)
    for row in np.flatnonzero(mask):
        b = bins[:, row]
        out[feats, b, 0] += float(g[row])
        out[feats, b, 1] += float(h[row])
        out[feats, b, 2] += 1.0
    return out


def _rows_major(bins):
    f, n = bins.shape
    out = torch.zeros((n, gk.padded_width(f)), dtype=torch.uint8)
    out[:, :f] = torch.as_tensor(bins).T
    return out


@pytest.mark.parametrize("case", ["roots", "children_split_on", "children_beside_a_leaf"])
def test_histograms_fused_subtraction_matches_old_composition(case):
    s = _state()
    k = N_TREES
    slots = 3 * k
    pool0 = np.random.default_rng(1).normal(size=(slots, N_FEATURES, gk.N_BINS, 3))  # stale slots stay stale
    if case == "roots":
        ids = np.zeros((k, N_ROWS), np.int32)
        tasks = [(t, 0, t, -1) for t in range(k)]
    else:
        # The parents' histograms sit in slots k + t; tree 1 splits node 4
        # (slot 2k + 1) instead of node 1, to mix nodes and trees.
        ids = s["child_ids"]
        for t in range(k):
            pool0[k + t] = _dense(s["bins"], s["g"][t], s["h"][t], s["parent_ids"][t] == 1)
        pool0[2 * k + 1] = _dense(s["bins"], s["g"][1], s["h"][1], (ids[1] == 5) | (ids[1] == 6))
        with_parent = case == "children_split_on"
        tasks = [(0, 3, 0, k if with_parent else -1), (1, 5, 1, 2 * k + 1 if with_parent else -1),
                 (2, 3, 2, k + 2 if with_parent else -1)]
    # The composition the estimator ran before: dense histograms of the
    # tasks into their slots, then each parent minus its smaller child.
    want = pool0.copy()
    for tree, node, slot, _ in tasks:
        want[slot] = _dense(s["bins"], s["g"][tree], s["h"][tree], ids[tree] == node)
    par = [p for *_, p in tasks if p >= 0]
    sib = [slot for _, _, slot, p in tasks if p >= 0]
    want[par] = want[par] - want[sib]

    pool = torch.as_tensor(pool0.copy())
    got = gk.gbm_histograms(_rows_major(s["bins"]), torch.as_tensor(s["g"]), torch.as_tensor(s["h"]),
                            torch.as_tensor(ids), torch.tensor(tasks, dtype=torch.int32), pool)
    assert got is pool
    np.testing.assert_array_equal(pool.numpy(), want)
    assert (want[[slot for _, _, slot, _ in tasks], :, gk.MISSING_BIN, 2] > 0).any()  # a missing bin was summed


def _node_value(g, h):
    return -g / ((h + gk.L2) + 1e-15)


def _serial_best_split(hist, node, nbnm, has_missing):
    """The record of one task by sklearn's serial find_node_split: each
    feature left to right, then (with missing values) right to left
    against the same running best, features in order, the first of the
    largest gain."""
    n = int(node[0])
    sg, sh = (float(np.sum(hist[0, :, 0])), float(np.sum(hist[0, :, 1]))) if node[4] > 0 else (node[1], node[2])
    loss_node = sg * node[3]
    msl, mh = gk.MIN_SAMPLES_LEAF, gk.MIN_HESSIAN
    win = None
    for f in range(hist.shape[0]):
        best = [-1.0, f, 0, 0, 0.0, 0.0, 0]  # gain, feature, bin, missing left, gl, hl, nl
        hf = hist[f]
        gl = hl = 0.0
        nl = 0
        for b in range(int(nbnm[f]) - 1 + int(has_missing[f])):
            nl += int(hf[b, 2])
            hl += hf[b, 1]
            gl += hf[b, 0]
            hr, gr = sh - hl, sg - gl
            if nl < msl:
                continue
            if n - nl < msl:
                break
            if hl < mh:
                continue
            if hr < mh:
                break
            gain = (loss_node - gl * _node_value(gl, hl)) - gr * _node_value(gr, hr)
            if gain > best[0] and gain > 0.0:
                best = [gain, f, b, 0, gl, hl, nl]
        if has_missing[f] and nbnm[f] >= 2:
            gr = hr = 0.0
            nr = 0
            for b in range(int(nbnm[f]) - 2, -1, -1):
                nr += int(hf[b + 1, 2])
                hr += hf[b + 1, 1]
                gr += hf[b + 1, 0]
                hl, gl = sh - hr, sg - gr
                if nr < msl:
                    continue
                if n - nr < msl:
                    break
                if hr < mh:
                    continue
                if hl < mh:
                    break
                gain = (loss_node - gl * _node_value(gl, hl)) - gr * _node_value(gr, hr)
                if gain > best[0] and gain > 0.0:
                    best = [gain, f, b, 1, gl, hl, n - nr]
        if win is None or best[0] > win[0]:
            win = best
    gain, f, b, ml, gl, hl, nl = win
    gr, hr = sg - gl, sh - hl
    return [gain, f, b, ml, gl, hl, nl, gr, hr, n - nl, _node_value(gl, hl), _node_value(gr, hr), sg, sh]


@pytest.mark.parametrize("case", ["roots", "children"])
def test_best_split_plain_matches_serial_scan(case):
    s = _state(2)
    ids = np.zeros((N_TREES, N_ROWS), np.int32) if case == "roots" else s["child_ids"]
    nodes_of = [0, 0, 0] if case == "roots" else [3, 6, 2]
    hist = np.stack([_dense(s["bins"], s["g"][t], s["h"][t], ids[t] == node) for t, node in enumerate(nodes_of)])
    nodes = []
    for t, node in enumerate(nodes_of):
        rows = int((ids[t] == node).sum())
        if case == "roots":
            nodes.append([rows, 0.0, 0.0, 0.0, 1.0])
        else:
            sg, sh = float(hist[t, 1, :, 0].sum()), float(hist[t, 1, :, 1].sum())
            nodes.append([rows, sg, sh, _node_value(sg, sh), 0.0])
    nodes = np.asarray(nodes)
    slots = np.array([2, 0, 1], np.int32)  # tasks read their slots out of order
    pool = np.empty_like(hist)
    pool[slots] = hist
    got = gk.gbm_best_split(torch.as_tensor(pool), torch.as_tensor(slots), torch.as_tensor(nodes),
                            torch.as_tensor(s["nbnm"]), torch.as_tensor(s["has_missing"].astype(np.uint8))).numpy()
    want = np.array([_serial_best_split(hist[t], nodes[t], s["nbnm"], s["has_missing"]) for t in range(N_TREES)])
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] > 0).all() and got[:, 3].any()  # every task splits, one with missing values left


def test_best_split_plain_without_a_split():
    """A node too small for two children of MIN_SAMPLES_LEAF rows: gain -1
    and the kernel's empty record (bin 0, sums 0) beside the node's sums."""
    s = _state(3)
    mask = np.zeros(N_ROWS, bool)
    mask[:30] = True
    hist = _dense(s["bins"], s["g"][0], s["h"][0], mask)[None]
    node = np.array([[30.0, 1.5, 2.0, -0.75, 0.0]])
    got = gk.gbm_best_split(torch.as_tensor(hist), torch.zeros(1, dtype=torch.int32), torch.as_tensor(node),
                            torch.as_tensor(s["nbnm"]), torch.as_tensor(s["has_missing"].astype(np.uint8))).numpy()
    np.testing.assert_array_equal(got[0], _serial_best_split(hist[0], node[0], s["nbnm"], s["has_missing"]))
    assert got[0, 0] == -1.0 and got[0, 2] == 0.0 and got[0, 4] == 0.0


def test_round_upload_packs_int32_and_float64():
    up = gbm._Upload(torch.device("cpu"))
    rng = np.random.default_rng(4)
    for sizes in ((3, 7, 5), (0, 2, 0), (41, 1, 13)):
        arrays = [rng.integers(-5, 99, size=(sizes[0], 7)).astype(np.int32),
                  rng.integers(-1, 9, size=sizes[1]).astype(np.int32),
                  rng.normal(size=(sizes[2], gk.NODE_WIDTH))]
        got = up.send(arrays)
        for a, v in zip(arrays, got):
            assert v.dtype == (torch.float64 if a.dtype == np.float64 else torch.int32) and tuple(v.shape) == a.shape
            np.testing.assert_array_equal(v.numpy(), a)
    with pytest.raises(TypeError):
        up.send([np.zeros(3, np.int64)])


def test_wrappers_refuse_what_the_kernels_do_not_take():
    s = _state()
    bins = _rows_major(s["bins"])
    g, h = torch.as_tensor(s["g"]), torch.as_tensor(s["h"])
    ids = torch.zeros((N_TREES, N_ROWS), dtype=torch.int32)
    pool = torch.zeros((N_TREES, N_FEATURES, gk.N_BINS, 3), dtype=torch.float64)
    tasks = torch.tensor([[0, 0, 0, -1]], dtype=torch.int32)
    with pytest.raises(ValueError, match="shapes"):  # bins not padded to a multiple of HIST_FEATURES
        gk.gbm_histograms(bins[:, :N_FEATURES].contiguous(), g, h, ids, tasks, pool)
    with pytest.raises(ValueError, match="shapes"):  # tasks without their parent column
        gk.gbm_histograms(bins, g, h, ids, tasks[:, :3], pool)
    with pytest.raises(ValueError, match="unsupported device"):
        gk.gbm_histograms(bins.to("meta"), g.to("meta"), h.to("meta"), ids.to("meta"), tasks, pool.to("meta"))
