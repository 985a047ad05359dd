"""Checkpoint/resume with ``torch.save`` (PyTorch port of
``lhvi_tpu/utils/checkpoint.py``, which wraps orbax).

A payload is any nest of dicts, lists, tuples, Python scalars, strings and
tensors (an engine state's fields, accumulators, step counters). One file
per step, ``step_<step>.pt`` in the directory. Tensors are saved from the
host (``.cpu()``), so a checkpoint written on the card restores anywhere;
``restore`` loads with ``weights_only=True`` (no pickled code runs).

Writes are atomic: the payload goes to a temporary name in the same
directory and is moved into place with ``os.replace``, so a run killed
mid-save leaves at most a stray temporary file, which ``latest_step``
never picks up. The last ``max_to_keep`` steps are kept.

In a sharded run the payload is assembled on every rank (gather, then
save: see ``engines/resumable.py``) and one rank writes it.
"""

from __future__ import annotations

import os
import re
from typing import Any, List, Optional

import torch

_STEP = re.compile(r"^step_(\d+)\.pt$")


def _to_host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


class CheckpointManager:
    """Numbered checkpoints in one directory, with step retention."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1: {max_to_keep}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = int(max_to_keep)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step)}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in
                      map(_STEP.match, os.listdir(self.directory)) if m)

    def save(self, step: int, payload: Any, wait: bool = False) -> None:
        """Write ``payload`` as ``step`` (atomically), then drop the oldest
        steps past ``max_to_keep``. Saves are synchronous; ``wait`` is
        accepted for the reference's signature."""
        del wait
        final = self._path(step)
        tmp = f"{final}.tmp-{os.getpid()}"
        with open(tmp, "wb") as fh:
            torch.save(_to_host(payload), fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, final)
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def restore(self, step: Optional[int] = None) -> Any:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return torch.load(self._path(step), map_location="cpu",
                          weights_only=True)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def close(self) -> None:
        """Nothing is pending (saves are synchronous); kept for the
        reference's interface."""
