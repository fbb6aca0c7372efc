"""Optimizer construction and the train state.

Counterpart of ``categoricalnf_tpu/training/state.py``, whose optimizer is
``optax.chain(clip_by_global_norm(c), radam(schedule))`` with the schedule
``lr * max(decay ** step, min_factor)`` (times an optional linear warm-up).
Here: the same clip (written out, since ``torch.nn.utils.clip_grad_norm_``
divides by ``norm + 1e-6`` where optax divides by the norm), then
``torch.optim.RAdam`` (or Adam, AdamW, SGD) at the schedule's rate for the
step, set before each update.  ``tests/test_torch_training.py`` pins a few
steps against optax.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

_OPTIMIZERS = {"radam": torch.optim.RAdam, "adam": torch.optim.Adam,
               "adamw": torch.optim.AdamW, "sgd": torch.optim.SGD}


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "radam"
    learning_rate: float = 7.5e-4
    lr_decay_rate: float = 0.999975  # per-step exponential decay
    lr_min_factor: float = 0.1
    grad_clip_norm: float = 100.0
    weight_decay: float = 0.0
    warmup_steps: int = 0

    def lr(self, step: int) -> float:
        """The learning rate of update number ``step`` (0-based)."""
        lr = self.learning_rate * max(self.lr_decay_rate ** step,
                                      self.lr_min_factor)
        if self.warmup_steps > 0:
            lr *= min(max(step / self.warmup_steps, 0.0), 1.0)
        return lr

    def build(self, params) -> torch.optim.Optimizer:
        if self.name not in _OPTIMIZERS:
            raise ValueError(f"unknown optimizer {self.name!r}")
        kw = {"weight_decay": self.weight_decay} if self.name == "adamw" \
            else {}
        return _OPTIMIZERS[self.name](list(params), lr=self.lr(0), **kw)


def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` in place: every gradient times
    ``max_norm / norm`` when the global norm exceeds ``max_norm``.  Returns
    the norm before clipping, as a tensor (no host sync)."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    coef = torch.where(norm < max_norm, torch.ones_like(norm),
                       max_norm / norm)
    torch._foreach_mul_(grads, coef)
    return norm


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    config: OptimizerConfig

    @classmethod
    def create(cls, model: nn.Module, config: OptimizerConfig):
        return cls(step=0, model=model,
                   optimizer=config.build(model.parameters()), config=config)

    def apply_gradients(self) -> Optional[torch.Tensor]:
        """Clip, set the step's rate, update, count the step; returns the
        gradient's global norm before clipping (a tensor)."""
        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        norm = clip_by_global_norm_(grads, self.config.grad_clip_norm) \
            if grads else None
        lr = self.config.lr(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1
        return norm

    def state_dict(self) -> dict:
        return {"step": int(self.step), "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
