"""Epoch checkpoints of a fit, and resuming from them (port of
deepof_tpu/train/checkpoint.py: ``TrainCheckpointer`` :20-87,
``make_epoch_checkpoint_hook`` :90 and ``maybe_resume`` :108).

The JAX package saves its train state through Orbax; the port writes one
``torch.save`` file an epoch, ``epoch_{n}.pt``, to a temporary name first
and then ``os.replace``s it, so a run cut mid-write leaves the previous
epoch's file whole. A state is a dict of the model's parameters and
buffers (BatchNorm running statistics included), the optimiser's state
(``ClippedAdam``'s moments, steps and update count) and the epoch, read
back with ``weights_only=True``. A directory of Orbax checkpoints (the JAX
package's) raises a TypeError naming it.
"""

from __future__ import annotations

import os
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

_FILE = re.compile(r"^epoch_(\d+)\.pt$")


def _raise_if_orbax(directory: str) -> None:
    """Orbax writes a directory per step, named by the step and holding
    ``_CHECKPOINT_METADATA``."""
    if not os.path.isdir(directory):
        return
    for name in os.listdir(directory):
        if name.isdigit() and os.path.exists(os.path.join(directory, name, "_CHECKPOINT_METADATA")):
            raise TypeError(
                f"{directory} holds Orbax checkpoints of the JAX package (step {name}); this package "
                "reads and writes its own torch.save epoch files (ROADMAP §3)"
            )


class TrainCheckpointer:
    """Epoch checkpoints under ``directory``: ``save`` writes every
    ``save_interval_epochs``-th epoch (or any epoch with ``force``) and keeps
    the newest ``max_to_keep`` files."""

    def __init__(self, directory: str, max_to_keep: int = 3, save_interval_epochs: int = 1):
        self.directory = os.path.abspath(directory)
        _raise_if_orbax(self.directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_epochs = max(1, int(save_interval_epochs))

    def _path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"epoch_{epoch}.pt")

    def epochs(self) -> List[int]:
        """The epochs saved, oldest first."""
        found = (_FILE.match(name) for name in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def save(self, epoch: int, state: Dict[str, Any], force: bool = False) -> bool:
        """Write ``state`` as epoch ``epoch``'s file; True when a save ran."""
        if not force and (epoch + 1) % self.save_interval_epochs != 0:
            return False
        path = self._path(epoch)
        torch.save(state, path + ".tmp")
        os.replace(path + ".tmp", path)
        for old in self.epochs()[:-self.max_to_keep] if self.max_to_keep else []:
            os.remove(self._path(old))
        return True

    def latest_epoch(self) -> Optional[int]:
        epochs = self.epochs()
        return epochs[-1] if epochs else None

    def restore(self, epoch: Optional[int] = None) -> Dict[str, Any]:
        """The state saved at ``epoch`` (default: the latest), on the CPU."""
        epoch = self.latest_epoch() if epoch is None else epoch
        if epoch is None:
            raise FileNotFoundError(f"No checkpoints under {self.directory}")
        return torch.load(self._path(epoch), map_location="cpu", weights_only=True)

    def close(self) -> None:
        """Saves are synchronous: nothing is pending."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def make_epoch_checkpoint_hook(checkpointer: Optional[TrainCheckpointer],
                               get_state: Callable[[], Dict[str, Any]]):
    """An ``on_epoch_end`` hook saving ``get_state()`` with its epoch, or
    None without a checkpointer."""
    if checkpointer is None:
        return None

    def hook(epoch, train_logs, val_logs):
        checkpointer.save(epoch, {**get_state(), "epoch": epoch})

    return hook


def maybe_resume(checkpointer: Optional[TrainCheckpointer]) -> Tuple[int, Optional[Dict[str, Any]]]:
    """(start epoch, state) from the latest checkpoint: the saved epoch + 1
    and its state, or (0, None) when there is none."""
    if checkpointer is None or checkpointer.latest_epoch() is None:
        return 0, None
    state = dict(checkpointer.restore())
    return int(state.pop("epoch")) + 1, state
