"""Task protocol (counterpart of ``categoricalnf_tpu/training/task.py``).

A task owns its data generator and its ``CategoricalFlow`` model.  Batches
are dicts with ``x`` [B, T] and optionally ``mask`` and ``cond`` (an array
or a dict of them), as numpy arrays or tensors.  Density evaluations run in the fp32 twin
(``eval_model``), which shares every parameter with ``model``.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn

from categoricalnf_tpu_torch.models.categorical_flow import _num_vars
from categoricalnf_tpu_torch.utils.tree import tree_map


def force_f32(module: nn.Module) -> nn.Module:
    """A structural copy of ``module`` whose every ``compute_dtype`` is
    float32.  Parameters and buffers are the SAME tensors, so in-place
    updates (loading a checkpoint, data init) reach both."""
    twin = copy.copy(module)
    twin._modules = {k: None if v is None else force_f32(v)
                     for k, v in module._modules.items()}
    twin._parameters = dict(module._parameters)
    twin._buffers = dict(module._buffers)
    if getattr(module, "compute_dtype", "float32") != "float32":
        twin.compute_dtype = "float32"
    return twin


class TaskTemplate:
    name: str = "task"
    model: nn.Module
    device: torch.device

    def build_model(self, generator: torch.Generator) -> nn.Module:
        raise NotImplementedError

    @property
    def eval_model(self) -> nn.Module:
        """fp32-compute twin of ``model`` for density evaluations: bf16
        noise inflates the importance-sampled bound through the logsumexp
        (Jensen), so likelihoods are evaluated in fp32, as the reference
        does."""
        m = getattr(self, "_eval_model_cache", None)
        if m is None:
            m = self._eval_model_cache = force_f32(self.model)
        return m

    def _tensor(self, a, dtype=None):
        """An array, or a dict of them (a graph's ``cond``), as tensors on
        the task's device."""
        return tree_map(lambda v: torch.as_tensor(v, dtype=dtype,
                                                  device=self.device), a)

    # -- hooks ------------------------------------------------------------

    def init_params(self, seed: int) -> None:
        """(Re)build the model from ``seed`` on the task's device."""
        self.model = self.build_model(
            torch.Generator().manual_seed(int(seed))).to(self.device)
        self._eval_model_cache = None

    @torch.no_grad()
    def data_init(self, batch: dict, *, generator=None, noise=None) -> None:
        self.model.data_init(self._tensor(batch["x"], torch.long),
                             mask=self._tensor(batch.get("mask")),
                             cond=self._tensor(batch.get("cond")),
                             generator=generator, noise=noise)

    def loss(self, batch: dict, beta=1.0, *, generator=None, noise=None,
             batch_mean=None):
        """The training objective of one batch (mean bits/var), through the
        model in its own compute dtype; the fp32 twin only evaluates.
        ``batch_mean`` takes the positive-ELBO penalty's mean over the
        global batch where the rows are one rank's (``Mesh.batch_mean``)."""
        return self.model.loss_bpd(self._tensor(batch["x"], torch.long), beta,
                                   mask=self._tensor(batch.get("mask")),
                                   cond=self._tensor(batch.get("cond")),
                                   generator=generator, noise=noise,
                                   batch_mean=batch_mean)

    def test_batches(self) -> list:
        """Held-out test split; defaults to the validation batches."""
        return self.eval_batches()

    @torch.no_grad()
    def eval_step(self, batch: dict, num_samples: int, *, generator=None,
                  noise=None) -> torch.Tensor:
        """Per-example importance-sampled bpd for one batch (fp32)."""
        return self.eval_model.eval_bpd(
            self._tensor(batch["x"], torch.long), num_samples=num_samples,
            mask=self._tensor(batch.get("mask")),
            cond=self._tensor(batch.get("cond")), generator=generator,
            noise=noise)

    # The three hooks below are the pieces of ``eval_step`` that the sharded
    # evaluation (parallel/eval.py) runs separately, as the reference's
    # (categoricalnf_tpu/training/task.py): over S chains, ``eval_step``
    # equals ``-(logsumexp_S(elbo) - ln S) / (num_vars ln 2) +
    # eval_bpd_extra``.

    @torch.no_grad()
    def elbo(self, batch: dict, *, generator=None, noise=None):
        """Single-sample per-example ELBO [B] (fp32 twin)."""
        return self.eval_model.elbo(
            self._tensor(batch["x"], torch.long),
            mask=self._tensor(batch.get("mask")),
            cond=self._tensor(batch.get("cond")), generator=generator,
            noise=noise)["elbo"]

    def num_vars(self, batch: dict) -> torch.Tensor:
        """Per-example count of categorical variables [B] (fp32)."""
        return _num_vars(self._tensor(batch["x"]),
                         self._tensor(batch.get("mask")))

    def eval_bpd_extra(self, batch: dict):
        """An additive per-example bpd outside the IS bound (the molecule
        task's node-count prior); 0 here."""
        return 0.0

    def sample_metrics(self, generator=None, **kw) -> dict:
        return {}

    def sample_artifacts(self, out_dir: str, generator=None) -> None:
        """Write samples of the model into ``out_dir`` (the LM's text);
        optional."""

    def analytic_optimum_bpd(self):
        return None

    def train_batches(self, rng: np.random.Generator):
        raise NotImplementedError

    def eval_batches(self) -> list:
        raise NotImplementedError
