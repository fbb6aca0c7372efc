"""Importance-sampled evaluation with its chains split over the mesh's
``sample`` axis and its batch over ``data`` (counterpart of
``make_task_sharded_iw_eval`` in ``categoricalnf_tpu/parallel/eval.py``).

Each rank computes the ELBOs of its share of the chains on its rows,
through the task's ``elbo`` hook, 16 chains at a time as a batch dimension
(``CategoricalFlow.iw_log_prob``'s chunks); the ELBOs are gathered over
the sample group and reduced with a logsumexp, and the per-example bits
are gathered over the data group, so every rank returns the whole batch's.
On a 1 x 1 mesh this is the computation of ``task.eval_step``.
"""

from __future__ import annotations

import math

import torch

from categoricalnf_tpu_torch.models.categorical_flow import LN2
from categoricalnf_tpu_torch.parallel.mesh import (DATA_AXIS, SAMPLE_AXIS,
                                                   Mesh, shard_batch)
from categoricalnf_tpu_torch.utils.tree import tree_map


def make_task_sharded_iw_eval(task, mesh: Mesh):
    """``eval_fn(batch, num_samples, *, generator=None, noise=None)`` ->
    the per-example IS bpd [B] of ``batch`` for any task with the
    ``elbo``/``num_vars``/``eval_bpd_extra`` hooks; ``noise``, if given,
    is the whole evaluation's uniforms with a leading chain axis ([S, B,
    ...], or a tuple of such), of which each rank takes its chains and
    rows.  ``eval_fn.effective_num_samples`` is the chain count it
    evaluates."""
    s_size = mesh.num_sample

    def effective_num_samples(num_samples: int) -> int:
        """The chain count actually evaluated: rounded up to tile the
        sample axis.  A caller logging an IS count logs this one."""
        return -(-num_samples // s_size) * s_size

    @torch.no_grad()
    def eval_fn(batch: dict, num_samples: int, *, generator=None,
                noise=None) -> torch.Tensor:
        num = effective_num_samples(num_samples)
        per = num // s_size
        rows = task._tensor(shard_batch(mesh, batch))
        num_vars = task.num_vars(rows)
        b = num_vars.shape[0]
        if noise is not None:
            first = mesh.sample_index * per
            noise = tree_map(lambda u: u[first:first + per], noise)
            noise = shard_batch(mesh, noise, axis=1)
        chunk = per if per % 16 else 16
        elbos = []
        for s0 in range(0, per, chunk):
            c = min(chunk, per - s0)
            tiled = tree_map(
                lambda v: v.repeat(c, *([1] * (v.dim() - 1))), rows)
            nz = None if noise is None else tree_map(
                lambda u: u[s0:s0 + c].reshape(c * b, *u.shape[2:]), noise)
            elbos.append(task.elbo(tiled, generator=generator,
                                   noise=nz).reshape(c, b))
        elbos = mesh.gather(torch.cat(elbos), SAMPLE_AXIS)  # [num, b]
        ll = torch.logsumexp(elbos, dim=0) - math.log(num)
        bpd = -ll / (num_vars * LN2) + task.eval_bpd_extra(rows)
        return mesh.gather(bpd, DATA_AXIS)

    eval_fn.effective_num_samples = effective_num_samples
    return eval_fn
