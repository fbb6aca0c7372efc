"""Metrics sinks: a JSONL file, stdout, and TensorBoard where it imports.

Counterpart of ``categoricalnf_tpu/training/metrics.py``: one record per
``log`` call with the keys ``step``, ``time`` (seconds since the logger
started), ``prefix`` and the scalars, appended to ``<out_dir>/metrics.jsonl``
and, unless ``echo`` is off, printed.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricsLogger:
    def __init__(self, out_dir: Optional[str] = None, echo: bool = True):
        self.out_dir = out_dir
        self.echo = echo
        self._jsonl = None
        self._tb = None
        self._t0 = time.time()
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            self._jsonl = open(os.path.join(out_dir, "metrics.jsonl"), "a")
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(os.path.join(out_dir, "tb"))

    def log(self, step: int, scalars: dict, prefix: str = "train"):
        rec = {"step": int(step), "time": time.time() - self._t0,
               "prefix": prefix}
        rec.update({k: float(v) for k, v in scalars.items()})
        if self._jsonl:
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()
        if self._tb:
            for k, v in scalars.items():
                self._tb.add_scalar(f"{prefix}/{k}", float(v), step)
        if self.echo:
            parts = " ".join(f"{k}={float(v):.4f}"
                             for k, v in scalars.items())
            print(f"[{prefix} @ {step}] {parts}", flush=True)

    def close(self):
        if self._jsonl:
            self._jsonl.close()
            self._jsonl = None
        if self._tb:
            self._tb.close()
            self._tb = None
