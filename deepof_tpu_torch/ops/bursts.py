"""Kleinberg burst detection and the legacy smoothing of boolean detection
series (port of ``deepof_tpu/ops/bursts.py``: ``_kleinberg_q`` :21,
``kleinberg`` :57, ``smooth_boolean_array`` :129).

The two-parameter burst model's Viterbi-style DP is sequential in time, so
it runs in numpy on the host, as in the JAX package; the inner step is
vectorised over the k burst levels. The JAX package calls a C++ kernel
(``deepof_tpu/native/kernels.cpp:24``) where it is built and this numpy DP
where it is not; both break a tie of two levels' costs towards the lower
level (the C++ strict ``<``, numpy's first ``argmin``).
"""

from __future__ import annotations

import math

import numpy as np


def _kleinberg_q(gaps: np.ndarray, s: float, gamma: float, n: int, T: float, k: int) -> np.ndarray:
    """The optimal burst level (1-based, float64) of each gap, by min-cost
    dynamic programming over the k levels."""
    g_hat = T / n
    gamma_log_n = gamma * math.log(n)
    levels = np.arange(k)
    alpha = s ** levels / g_hat
    log_alpha = np.log(alpha)
    # Moving up from level i to level j costs (j - i) * gamma * log(n).
    trans = np.maximum(levels[None, :] - levels[:, None], 0) * gamma_log_n

    c = np.full(k, np.inf)
    c[0] = 0.0
    back = np.zeros((len(gaps), k), dtype=np.int32)
    for t in range(len(gaps)):
        cost = c[:, None] + trans  # (from, to)
        best_from = np.argmin(cost, axis=0)
        c = cost[best_from, levels] - (log_alpha - alpha * gaps[t])
        back[t] = best_from

    q = np.empty(len(gaps), dtype=np.int32)
    state = int(np.argmin(c))
    for t in range(len(gaps) - 1, -1, -1):
        q[t] = state + 1
        state = int(back[t, state])
    return q.astype(np.float64)


def kleinberg(offsets, s: float = 2.0, gamma: float = 1.0, n=None, T=None, k=None) -> np.ndarray:
    """Burst intervals, rows [level, start, end] (an object array), of a
    sequence of event offsets (deepof's ``kleinberg``)."""
    if s <= 1:
        raise ValueError("s must be greater than 1!")
    if gamma <= 0:
        raise ValueError("gamma must be positive!")
    if n is not None and n <= 0:
        raise ValueError("n must be positive!")
    if T is not None and T <= 0:
        raise ValueError("T must be positive!")
    offsets = np.asarray(offsets)
    if offsets.size < 1:
        raise ValueError("offsets must be non-empty!")
    if offsets.size == 1:
        return np.array([[0, offsets[0], offsets[0]]], dtype=object)

    offsets = np.sort(offsets)
    gaps = np.diff(offsets).astype(np.float64)
    if not np.all(gaps):
        raise ValueError("Input cannot contain events with zero time between!")
    if T is None:
        T = float(np.sum(gaps))
    if n is None:
        n = int(gaps.size)
    if k is None:
        k = min(6, int(math.ceil(1 + math.log(T) / math.log(s) + math.log(1.0 / float(np.amin(gaps))) / math.log(s))))

    q = _kleinberg_q(gaps, float(s), float(gamma), n, float(T), int(k))

    # The level sequence as nested [level, start, end] intervals.
    n_opens = int(np.maximum(np.diff(np.concatenate([[0.0], q])), 0).sum())
    bursts = np.empty((n_opens, 3), dtype=object)
    stack, counter, prev = [], 0, 0
    for t, level in enumerate(q):
        level = int(level)
        if level > prev:
            for i in range(level - prev):
                bursts[counter] = [prev + i, offsets[t], offsets[t]]
                stack.append(counter)
                counter += 1
        elif level < prev:
            for _ in range(prev - level):
                bursts[stack.pop(), 2] = offsets[t]
        prev = level
    while stack:
        bursts[stack.pop(), 2] = offsets[len(q)]
    return bursts


def smooth_boolean_array(a, scale: int = 1, sigma: float = 2.0, batch_size: int = 50000) -> np.ndarray:
    """A boolean detection series kept only inside its level-``scale``
    bursts, over batches of ``batch_size`` frames that overlap by half
    (deepof's legacy smoothing)."""
    n = len(a)
    out = np.zeros(n, dtype=bool)
    for start in range(0, n, batch_size // 2):
        end = min(start + batch_size, n)
        batch = np.asarray(a[start:end])
        offsets = np.where(batch)[0]
        if len(offsets) == 0:
            continue
        smoothed = np.zeros(batch.size, dtype=bool)
        for level, b_start, b_end in kleinberg(offsets, gamma=0.3, s=sigma):
            if level == scale:
                smoothed[int(b_start):int(b_end)] = True
        out[start:end] = smoothed
    return out
