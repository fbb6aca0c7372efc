"""Inference API: load a finished run and serve samples / likelihoods.

Counterpart of ``categoricalnf_tpu/inference.py``: ``load_run`` rebuilds the
task from the run's ``config.json``, restores the newest checkpoint of the
port and returns a handle.  Runs on ``cuda`` unless ``device="cpu"`` is
passed; with no card and no device it raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from categoricalnf_tpu_torch.training.checkpoint import CheckpointManager
from categoricalnf_tpu_torch.utils.config import load_config
from categoricalnf_tpu_torch.utils.device import resolve_device


def _task_class(task_name: str):
    if task_name == "set_shuffling":
        from categoricalnf_tpu_torch.tasks import SetShufflingTask
        return SetShufflingTask
    if task_name == "set_summation":
        from categoricalnf_tpu_torch.tasks import SetSummationTask
        return SetSummationTask
    if task_name == "graph_coloring":
        from categoricalnf_tpu_torch.tasks import GraphColoringTask
        return GraphColoringTask
    if task_name.startswith("lm_"):
        from categoricalnf_tpu_torch.tasks import LanguageModelingTask
        return LanguageModelingTask
    if task_name.startswith("molecules_"):
        from categoricalnf_tpu_torch.tasks import MoleculeTask
        return MoleculeTask
    raise NotImplementedError(
        f"task {task_name!r} is not ported yet (ROADMAP.md, Queue A)")


# CLI flag name -> task dataclass field name
_ARG_RENAMES = {"encoding": "encoding_name", "corpus": "corpus_name"}


def build_task(task_name: str, args: dict, device=None):
    """Rebuild a task from CLI args saved in config.json: args that match a
    field of the task are passed through, the rest fall to the defaults."""
    device = resolve_device(device)
    cls = _task_class(task_name)
    fields = {f.name for f in dataclasses.fields(cls)} - {"name", "device"}
    kwargs = {}
    for k, v in args.items():
        k = _ARG_RENAMES.get(k, k)
        if k in fields and v is not None:
            kwargs[k] = v
    return cls(**kwargs, device=device)


@dataclasses.dataclass
class RunHandle:
    task: Any
    step: int

    def generator(self, seed: int) -> torch.Generator:
        return torch.Generator(self.task.device).manual_seed(int(seed))

    @torch.no_grad()
    def sample(self, batch: int, num_pos: int, *, seed: int = 0,
               temperature: float = 1.0) -> np.ndarray:
        return self.task.model.sample(
            batch, num_pos, temperature=temperature,
            generator=self.generator(seed)).cpu().numpy()

    def eval_bpd(self, batch: dict, *, seed: int = 0,
                 num_samples: int = 16) -> np.ndarray:
        """Per-example importance-sampled bits/var, in the fp32 twin."""
        return self.task.eval_step(
            batch, num_samples, generator=self.generator(seed)).cpu().numpy()

    def sample_metrics(self, *, seed: int = 0, **kw) -> dict:
        return self.task.sample_metrics(generator=self.generator(seed), **kw)


def load_run(run_dir: str, device=None, **overrides) -> RunHandle:
    """Restore a run for inference; ``overrides`` replace saved args."""
    cfg = load_config(run_dir)
    if cfg is None:
        raise FileNotFoundError(f"no config.json in {run_dir}")
    task = build_task(cfg["task"], {**cfg.get("args", {}), **overrides},
                      device=device)
    restored = CheckpointManager(run_dir).restore_latest()
    if restored is None:
        raise FileNotFoundError(f"no checkpoints of the port in {run_dir}")
    task.model.load_state_dict(restored["model"])
    return RunHandle(task=task, step=int(restored["step"]))
