"""Scalar schedules of the step (beta annealing), as plain functions.

Counterpart of ``categoricalnf_tpu/training/schedules.py``: the same
factories and ``ScheduleSpec``, in Python floats of the int step (the
reference computes them in fp32 inside its jitted step; the values agree to
fp32 rounding).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

Schedule = Callable[[int], float]


def constant(value: float) -> Schedule:
    def fn(step):
        return float(value)
    return fn


def linear(start: float, end: float, num_steps: int,
           delay: int = 0) -> Schedule:
    def fn(step):
        t = min(max((step - delay) / max(num_steps, 1), 0.0), 1.0)
        return start + (end - start) * t
    return fn


def sigmoid_anneal(start: float, end: float, center: int,
                   rate: float = 0.01) -> Schedule:
    """Smooth start -> end transition centered at ``center`` steps."""
    def fn(step):
        z = -rate * (float(step) - center)
        frac = 1.0 / (1.0 + math.exp(z)) if z < 700 else 0.0
        return start + (end - start) * frac
    return fn


def exponential_decay(init: float, decay_rate: float, decay_steps: int,
                      staircase: bool = False,
                      min_value: float = 0.0) -> Schedule:
    def fn(step):
        p = float(step) / max(decay_steps, 1)
        if staircase:
            p = math.floor(p)
        return max(init * decay_rate ** p, min_value)
    return fn


@dataclasses.dataclass(frozen=True)
class ScheduleSpec:
    """Config-friendly schedule description."""

    kind: str = "constant"
    value: float = 1.0
    start: float = 0.0
    end: float = 1.0
    num_steps: int = 1000
    delay: int = 0
    center: int = 1000
    rate: float = 0.01
    decay_rate: float = 0.5
    decay_steps: int = 10000

    def build(self) -> Schedule:
        if self.kind == "constant":
            return constant(self.value)
        if self.kind == "linear":
            return linear(self.start, self.end, self.num_steps, self.delay)
        if self.kind == "sigmoid":
            return sigmoid_anneal(self.start, self.end, self.center, self.rate)
        if self.kind == "exponential":
            return exponential_decay(self.value, self.decay_rate,
                                     self.decay_steps)
        raise ValueError(f"unknown schedule kind {self.kind!r}")
