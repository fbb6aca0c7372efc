"""Run config snapshot (counterpart of ``categoricalnf_tpu/utils/config.py``):
a run directory's ``config.json`` holds ``{"task": name, "args": {...}}``."""

from __future__ import annotations

import json
import os
import random
from typing import Any, Optional

import numpy as np
import torch


def set_seed(seed: int) -> None:
    """Seed Python's, numpy's and torch's global generators (the port's own
    noise comes from explicit generators; this covers everything else)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def save_config(out_dir: str, config: Any, name: str = "config.json") -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    with open(path, "w") as f:
        json.dump(config, f, indent=2, default=str)
    return path


def load_config(out_dir: str, name: str = "config.json") -> Optional[dict]:
    path = os.path.join(out_dir, name)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)
