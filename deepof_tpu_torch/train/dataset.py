"""The in-RAM window dataset and its host batch pipeline (port of
deepof_tpu/train/dataset.py:31-225 ``WindowDataset`` and ``prefetch``; one
process, so no shards).

Batches are numpy arrays drawn with the JAX package's numpy calls in its
order, so one ``np.random.default_rng(seed)`` gives both packages the same
batches in the same order. The HDF5 spill of very large projects waits for
the paths mode (ROADMAP queue 1, item 2): the machine with the card has no
h5py.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from deepof_tpu_torch.core.storage import get_dt


class WindowDataset:
    """Windowed (x, a, angles) arrays with per-video ranges, in RAM."""

    def __init__(self, preprocessed: Dict, spill_to_disk: bool = False):
        if spill_to_disk:
            raise NotImplementedError(
                "WindowDataset(spill_to_disk=True): the HDF5 spill comes with paths mode, "
                "ROADMAP queue 1 item 2 (the machine with the card has no h5py)"
            )
        self.keys = list(preprocessed.keys())
        self.video_ranges: Dict[str, Tuple[int, int]] = {}
        xs, as_, angs = [], [], []
        offset = 0
        for key in self.keys:
            nodes, edges, angles = get_dt(preprocessed, key)
            n = nodes.shape[0]
            self.video_ranges[key] = (offset, offset + n)
            offset += n
            xs.append(np.asarray(nodes, np.float32))
            as_.append(np.asarray(edges, np.float32))
            angs.append(np.asarray(angles, np.float32))
        self.x = np.concatenate(xs, axis=0) if xs else np.zeros((0, 1, 1), np.float32)
        self.a = np.concatenate(as_, axis=0) if as_ else np.zeros((0, 1, 1), np.float32)
        self.angles = np.concatenate(angs, axis=0) if angs else np.zeros((0, 1, 0), np.float32)

    def __len__(self) -> int:
        return self.x.shape[0]

    def batches(
        self,
        batch_size: int,
        rng: Optional[np.random.Generator] = None,
        shuffle: bool = True,
        block_size: int = 256,
        bootstrap: bool = False,
        drop_last: bool = False,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
        """Yield (x, a, angles, idx) batches.

        Blocks of ``block_size`` consecutive windows are shuffled (or, with
        ``bootstrap``, drawn with replacement), then the windows;
        ``drop_last`` drops a short final batch.
        """
        n = len(self)
        if n == 0:
            return
        rng = rng or np.random.default_rng(0)

        n_blocks = (n + block_size - 1) // block_size
        if bootstrap:
            block_ids = rng.integers(0, n_blocks, size=n_blocks)
        else:
            block_ids = np.arange(n_blocks)
            if shuffle:
                rng.shuffle(block_ids)

        indices = np.concatenate(
            [np.arange(b * block_size, min((b + 1) * block_size, n)) for b in block_ids]
        ) if len(block_ids) else np.zeros(0, np.int64)
        if shuffle:
            rng.shuffle(indices)

        for start in range(0, len(indices), batch_size):
            batch_idx = indices[start:start + batch_size]
            if drop_last and len(batch_idx) < batch_size:
                break
            yield self.x[batch_idx], self.a[batch_idx], self.angles[batch_idx], batch_idx

    def n_batches(self, batch_size: int) -> int:
        return (len(self) + batch_size - 1) // batch_size


class PrefetchIterator:
    """Background-thread prefetch over a batch iterator: the next ``depth``
    batches are gathered on a host thread while the card runs the step."""

    def __init__(self, iterator, depth: int = 2):
        self._q = queue.Queue(maxsize=max(1, depth))
        self._sentinel = object()
        self._err = None
        self._stop = threading.Event()

        def worker():
            try:
                for item in iterator:
                    if self._stop.is_set():
                        return
                    self._q.put(item)
            except BaseException as e:  # re-raised in the consumer
                self._err = e
            finally:
                self._q.put(self._sentinel)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._sentinel:
            self._thread.join()
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self) -> None:
        """Stop the worker after the batch it is gathering and join it."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._q.get(timeout=0.1)
            except queue.Empty:
                pass
        self._thread.join()


def prefetch(iterator, depth: int = 2) -> PrefetchIterator:
    """Wrap ``iterator`` so the next ``depth`` batches load on a host thread."""
    return PrefetchIterator(iterator, depth)
