"""Checkpoints with top-k-by-metric retention and resume.

Counterpart of ``snn_for_object_detection_tpu/train/checkpoint.py`` with
``torch.save`` / ``torch.load`` in place of orbax. A checkpoint is a
directory ``step_<9 digits>`` holding ``state.pt`` (the payload: any
nested dict of tensors, numbers and strings) beside a
``step_<9 digits>.meta.json`` with its metrics. The manager keeps the
``save_top_k`` best by the monitored metric in ``index.json`` and a
``last`` symlink to the newest save, whose data are never pruned while
it is the newest.

Under several ranks every rank calls :meth:`CheckpointManager.save`
together; rank 0 alone writes, prunes and moves ``last`` (the ranks hold
the same weights), every rank keeps the same index in memory, and
barriers keep a rank from reading a checkpoint that rank 0 is still
writing.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

import torch

from snn_for_object_detection_tpu_torch.parallel import distributed as dist

PAYLOAD = "state.pt"


def _load(path: str) -> Any:
    return torch.load(os.path.join(path, PAYLOAD), map_location="cpu",
                      weights_only=True)


class CheckpointManager:
    """Top-k checkpoint manager over ``torch.save``."""

    def __init__(self, directory: str, save_top_k: int = 4,
                 monitor: str = "map", mode: str = "max"):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.save_top_k = save_top_k
        self.monitor = monitor
        self.mode = mode
        self._index_path = os.path.join(self.directory, "index.json")
        self._latest_name: Optional[str] = None
        self._index: Dict[str, float] = {}
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                self._index = json.load(f)

    def _remove(self, name: str) -> None:
        if not dist.is_primary():
            return
        path = os.path.join(self.directory, name)
        if os.path.exists(path):
            shutil.rmtree(path)
        if os.path.exists(path + ".meta.json"):
            os.remove(path + ".meta.json")

    def _ranked(self):
        return sorted(self._index.items(), key=lambda kv: kv[1],
                      reverse=self.mode == "max")

    def save(self, step: int, state: Any, metric: Optional[float] = None,
             meta: Optional[Dict] = None) -> str:
        """Save ``state`` tagged by step; keep only the top k by the
        monitored metric (``metric=None``: kept as the newest only)."""
        name = f"step_{step:09d}"
        path = os.path.join(self.directory, name)
        primary = dist.is_primary()
        # no rank may still be reading a checkpoint rank 0 replaces
        dist.barrier("ckpt_pre_save")
        if primary and os.path.exists(path):
            shutil.rmtree(path)
        # a pruned checkpoint kept only because it was the newest goes
        # once a newer save supersedes it
        if (self._latest_name and self._latest_name != name
                and self._latest_name not in self._index):
            self._remove(self._latest_name)
        if primary:
            os.makedirs(path)
            torch.save(state, os.path.join(path, PAYLOAD))
            if meta is not None:
                with open(path + ".meta.json", "w") as f:
                    json.dump(meta, f, indent=1, default=str)
        self._latest_name = name
        if metric is not None:
            self._index[name] = float(metric)
            self._prune()
        if primary:
            with open(self._index_path, "w") as f:
                json.dump(self._index, f, indent=1)
            last = os.path.join(self.directory, "last")
            if os.path.islink(last):
                os.unlink(last)
            elif os.path.exists(last):
                shutil.rmtree(last)
            os.symlink(path, last)
        # every rank sees the checkpoint once save returns
        dist.barrier("ckpt_saved")
        return path

    def _prune(self) -> None:
        if self.save_top_k <= 0:
            return
        for name, _ in self._ranked()[self.save_top_k:]:
            # 'last' points at the newest: its data stay until a newer
            # save supersedes it (see save())
            if name != self._latest_name:
                self._remove(name)
            del self._index[name]

    def best_path(self) -> Optional[str]:
        if not self._index:
            return None
        return os.path.join(self.directory, self._ranked()[0][0])

    def restore(self, path: Optional[str] = None) -> Dict[str, Any]:
        """The payload of a checkpoint (``path=None``: ``last``), on the
        CPU. Callers read optional keys with ``.get`` / ``in``: a
        weights-only checkpoint lacks the trainer's keys."""
        if path is None:
            path = os.path.join(self.directory, "last")
        return _load(os.path.abspath(path))


def save_single(path: str, state: Any) -> None:
    """One checkpoint at ``path`` (no retention management)."""
    path = os.path.abspath(path)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    torch.save(state, os.path.join(path, PAYLOAD))


def load_single(path: str) -> Any:
    return _load(os.path.abspath(path))
