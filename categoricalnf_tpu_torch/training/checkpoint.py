"""Checkpoints of the port: ``torch.save`` of the model's ``state_dict`` and
the step, one file per step under ``<run>/checkpoints/``; the latest wins.

Counterpart of ``categoricalnf_tpu/training/checkpoint.py`` (which writes
Orbax directories ``step_XXXXXXXX/`` there; the port's files end in
``.pt`` and the two never collide).
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

_STEP_RE = re.compile(r"^step_(\d{8})\.pt$")


class CheckpointManager:
    def __init__(self, out_dir: str, subdir: str = "checkpoints"):
        self.dir = os.path.abspath(os.path.join(out_dir, subdir))

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}.pt")

    def save(self, step: int, model: torch.nn.Module) -> str:
        os.makedirs(self.dir, exist_ok=True)
        path = self._path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        torch.save({"step": int(step), "model": state}, tmp)
        os.replace(tmp, path)  # a reader never sees a partial file
        return path

    def latest_step(self) -> Optional[int]:
        if not os.path.isdir(self.dir):
            return None
        steps = [int(m.group(1)) for m in map(_STEP_RE.match,
                                              os.listdir(self.dir)) if m]
        return max(steps) if steps else None

    def restore_latest(self) -> Optional[dict]:
        """``{"step": int, "model": state_dict}`` of the newest file."""
        step = self.latest_step()
        if step is None:
            return None
        return torch.load(self._path(step), map_location="cpu",
                          weights_only=True)
