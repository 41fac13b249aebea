"""The window dataset and its host batch pipeline (port of
deepof_tpu/train/dataset.py:31-225 ``WindowDataset`` and ``prefetch``; one
process, so no shards).

Batches are numpy arrays drawn with the JAX package's numpy calls in its
order, so one ``np.random.default_rng(seed)`` gives both packages the same
batches in the same order. The windows sit in RAM, or, with
``spill_to_disk`` (very large projects), in ``{dataset_folder}/
{dataset_name}_windows/`` as three ``.npy`` files read through read-only
maps, beside a json of the build (the JAX package spills to HDF5, which the
card's machine lacks).
"""

from __future__ import annotations

import hashlib
import json
import os
import queue
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from deepof_tpu_torch.core.storage import get_dt

_SPILLED = ("x", "a", "ang")


def _keys_hash(preprocessed: Dict) -> str:
    """The build's identity: each key with its windows' shapes
    (deepof_tpu/train/dataset.py:23)."""
    parts = [""]
    for key in sorted(preprocessed.keys()):
        parts.append(f"{key}:{get_dt(preprocessed, key, only_metainfo=True).get('shape')}")
    return hashlib.sha1("|".join(map(str, parts)).encode()).hexdigest()


def _write_json(path: str, obj: dict) -> None:
    with open(f"{path}.tmp", "w") as f:
        json.dump(obj, f)
    os.replace(f"{path}.tmp", path)


class WindowDataset:
    """Windowed (x, a, angles) arrays with per-video ranges, in RAM or, with
    ``spill_to_disk``, a ``dataset_folder`` and any key, in read-only maps of
    files written there (rebuilt when the json's ``build_complete`` is unset, its
    keys hash differs, or ``force_rebuild``). ``h5_chunk_len`` is accepted
    with the JAX package's name; the files have no chunks."""

    def __init__(
        self,
        preprocessed: Dict,
        dataset_folder: Optional[str] = None,
        dataset_name: str = "train",
        force_rebuild: bool = False,
        spill_to_disk: bool = False,
        h5_chunk_len: int = 4096,
    ):
        self.keys = list(preprocessed.keys())
        self.video_ranges: Dict[str, Tuple[int, int]] = {}
        self._spill_dir = None
        if spill_to_disk and dataset_folder is not None and self.keys:
            self._spill_dir = os.path.join(dataset_folder, f"{dataset_name}_windows")
            self._spill(preprocessed, force_rebuild)
            return
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

    def _spill(self, preprocessed: Dict, force_rebuild: bool) -> None:
        """Write (or reuse) the spilled windows, then map them read-only."""
        want = _keys_hash(preprocessed)
        meta_path = os.path.join(self._spill_dir, "build.json")
        meta = None
        if os.path.exists(meta_path) and not force_rebuild:
            with open(meta_path) as f:
                meta = json.load(f)
            if not (meta.get("build_complete") and meta.get("keys_hash") == want):
                meta = None
        if meta is None:
            meta = self._build_spill(preprocessed, want, meta_path)
        self.video_ranges = {k: tuple(v) for k, v in meta["video_ranges"].items()}
        self.x, self.a, self.angles = (
            np.load(os.path.join(self._spill_dir, f"{name}.npy"), mmap_mode="r") for name in _SPILLED)

    def _build_spill(self, preprocessed: Dict, keys_hash: str, meta_path: str) -> dict:
        """The windows of every key in order, written into maps of their
        final size (shapes from the metainfo, then the data) under
        temporary names moved over the old files (whose maps keep their
        data), the json's ``build_complete`` set last."""
        os.makedirs(self._spill_dir, exist_ok=True)
        meta = {"build_complete": False, "keys_hash": keys_hash, "video_ranges": {}}
        _write_json(meta_path, meta)
        shapes = [get_dt(preprocessed, key, only_metainfo=True)["shape"] for key in self.keys]
        total = sum(int(s[0][0]) for s in shapes)
        paths = [os.path.join(self._spill_dir, f"{name}.npy") for name in _SPILLED]
        tmp = [f"{path}.{os.getpid()}.tmp" for path in paths]
        outs = [np.lib.format.open_memmap(t, mode="w+", dtype=np.float32, shape=(total,) + tuple(shapes[0][i][1:]))
                for i, t in enumerate(tmp)]
        offset = 0
        for key in self.keys:
            parts = get_dt(preprocessed, key)
            n = int(np.shape(parts[0])[0])
            for out, arr in zip(outs, parts):
                out[offset:offset + n] = np.asarray(arr, np.float32)
            meta["video_ranges"][key] = [offset, offset + n]
            offset += n
        for out in outs:
            out.flush()
        del outs
        for t, path in zip(tmp, paths):
            os.replace(t, path)
        meta["build_complete"] = True
        _write_json(meta_path, meta)
        return meta

    def __len__(self) -> int:
        return self.x.shape[0]

    def _read(self, idx: np.ndarray):
        """The windows ``idx`` in that order: from the maps in sorted order
        (deepof_tpu/train/dataset.py:147-162), else from RAM."""
        if self._spill_dir is None:
            return self.x[idx], self.a[idx], self.angles[idx]
        order = np.argsort(idx)
        inv = np.empty_like(order)
        inv[order] = np.arange(len(order))
        return tuple(np.asarray(arr[idx[order]])[inv] for arr in (self.x, self.a, self.angles))

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
            yield (*self._read(batch_idx), batch_idx)

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
