"""Factorized logistic prior (counterpart of ``LogisticPrior`` in
``categoricalnf_tpu/flows/distributions.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from categoricalnf_tpu_torch.flows.base import sum_ldj
from categoricalnf_tpu_torch.ops import numerics as nm


class LogisticPrior:
    """Standard factorized logistic prior (no parameters)."""

    def log_prob(self, z: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return sum_ldj(nm.logistic_log_pdf(z, 0.0, 0.0), mask)

    def sample(self, shape, temperature: float = 1.0, *, generator=None,
               noise=None, device=None) -> torch.Tensor:
        """Draw from the prior; ``temperature`` scales the base logistic.
        ``noise`` is the uniform draw (see ``numerics.logistic_sample``)."""
        return nm.logistic_sample(shape, generator=generator, noise=noise,
                                  device=device) * temperature
