"""Checkpoints of the port: ``torch.save`` of the step, the model's
``state_dict`` and, for training, the optimizer's, one file per step under
``<run>/<subdir>/``; the newest wins, and only the ``keep`` newest stay.

Counterpart of ``categoricalnf_tpu/training/checkpoint.py`` (which writes
Orbax directories ``step_XXXXXXXX/`` there; the port's files end in
``.pt`` and the two never collide).  The eval metrics that earned a save sit
next to its file as ``step_XXXXXXXX.metrics.json``.  The trainer keeps the
best-metric files in ``checkpoints/`` (what ``inference.load_run`` serves)
and periodic ones in ``checkpoints_last/``.
"""

from __future__ import annotations

import json
import os
import re
from typing import Optional

import torch

_STEP_RE = re.compile(r"^step_(\d{8})\.pt$")


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


class CheckpointManager:
    def __init__(self, out_dir: str, keep: Optional[int] = 2,
                 subdir: str = "checkpoints"):
        self.dir = os.path.abspath(os.path.join(out_dir, subdir))
        self.keep = keep

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}.pt")

    def save(self, step: int, model: torch.nn.Module, *, optimizer=None,
             metrics: Optional[dict] = None) -> str:
        os.makedirs(self.dir, exist_ok=True)
        path = self._path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        payload = {"step": int(step), "model": _to_cpu(model.state_dict())}
        if optimizer is not None:
            payload["optimizer"] = _to_cpu(optimizer.state_dict())
        torch.save(payload, tmp)
        os.replace(tmp, path)  # a reader never sees a partial file
        if metrics:
            mpath = path[:-3] + ".metrics.json"
            with open(f"{mpath}.tmp", "w") as f:
                json.dump({k: float(v) for k, v in metrics.items()}, f)
            os.replace(f"{mpath}.tmp", mpath)
        self._gc()
        return path

    def steps(self) -> list[int]:
        if not os.path.isdir(self.dir):
            return []
        return sorted(int(m.group(1)) for m in map(_STEP_RE.match,
                                                   os.listdir(self.dir)) if m)

    def _gc(self) -> None:
        if not self.keep:
            return
        for step in self.steps()[:-self.keep]:
            for path in (self._path(step),
                         self._path(step)[:-3] + ".metrics.json"):
                if os.path.exists(path):
                    os.remove(path)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore_latest(self) -> Optional[dict]:
        """``{"step": int, "model": state_dict[, "optimizer": ...]}`` of the
        newest file."""
        step = self.latest_step()
        if step is None:
            return None
        return torch.load(self._path(step), map_location="cpu",
                          weights_only=True)
