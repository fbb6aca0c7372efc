"""The ``('data', 'sample')`` mesh of the port's data-parallel training and
sharded importance-sampled evaluation (counterpart of
``categoricalnf_tpu/parallel/mesh.py``).

The reference lays its devices out as a ``num_data x num_sample`` mesh
inside one jitted program; the port runs one process a rank over
``torch.distributed`` (NCCL, one card a process, or gloo on the CPU), and
rank ``r`` sits at ``(r // num_sample, r % num_sample)``, the reference's
``reshape(num_data, num_sample)``.  A batch splits over ``data`` into
contiguous rows; IS chains split over ``sample``; parameters are
replicated, and each step's gradients are averaged over the world with one
all-reduce.  The launcher's variables are the reference's:
``CNF_COORDINATOR_ADDRESS`` (host:port), ``CNF_NUM_PROCESSES`` and
``CNF_PROCESS_ID``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from categoricalnf_tpu_torch.utils.tree import tree_map

DATA_AXIS = "data"
SAMPLE_AXIS = "sample"


def maybe_init_distributed(device=None) -> Optional[torch.device]:
    """Join the process group that the launcher's ``CNF_*`` variables
    describe, where ``CNF_COORDINATOR_ADDRESS`` is set: over NCCL with
    ``cuda:(rank % device_count)`` as this process's card where ``device``
    is CUDA (the default), over gloo on the CPU.  Returns this rank's
    device, or None (and does nothing) without the variables."""
    address = os.environ.get("CNF_COORDINATOR_ADDRESS")
    if not address:
        return None
    world = int(os.environ.get("CNF_NUM_PROCESSES", "1"))
    rank = int(os.environ.get("CNF_PROCESS_ID", "0"))
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method=f"tcp://{address}", world_size=world, rank=rank)
    return device


class _AllReduceSum(torch.autograd.Function):
    """The sum of ``t`` over ``group``'s ranks; its backward is the same sum
    of the incoming gradients."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


@dataclasses.dataclass
class Mesh:
    """This rank's place in a ``num_data x num_sample`` mesh, with the
    process groups of its row and column: ``data_group`` holds the ranks
    of its sample coordinate (their rows make the global batch),
    ``sample_group`` the ranks of its data coordinate (their chains make
    the IS bound), ``host_group`` the world over gloo, for flags the host
    reads."""

    num_data: int
    num_sample: int
    rank: int
    data_group: object
    sample_group: object
    host_group: object

    @property
    def world(self) -> int:
        return self.num_data * self.num_sample

    @property
    def data_index(self) -> int:
        return self.rank // self.num_sample

    @property
    def sample_index(self) -> int:
        return self.rank % self.num_sample

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.num_data, SAMPLE_AXIS: self.num_sample}

    def data_mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of ``t`` over the data axis's ranks; differentiable
        (the backward all-reduces the incoming gradient), so that a term
        of the global batch's mean, such as the positive-ELBO penalty,
        gives each rank its share of the exact gradient."""
        return _AllReduceSum.apply(t, self.data_group) / self.num_data

    def batch_mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of the per-example ``t`` over the global batch (every
        rank holds as many rows)."""
        return self.data_mean(torch.mean(t))

    def average_gradients(self, params) -> None:
        """Every gradient averaged over the world, in place, with one
        all-reduce of the gradients laid end to end.  Every rank runs the
        same code path, so the same parameters have a gradient on each."""
        grads = [p.grad for p in params if p.grad is not None]
        if not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        flat /= self.world
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()

    def gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The ranks' ``t`` along ``axis``, concatenated on dim 0 in the
        order of their coordinate."""
        group = self.data_group if axis == DATA_AXIS else self.sample_group
        n = self.num_data if axis == DATA_AXIS else self.num_sample
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts)

    def any(self, flag: bool) -> bool:
        """Whether ``flag`` is set on some rank (a collective: every rank
        calls it at the same point)."""
        t = torch.tensor([int(flag)])
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.host_group)
        return bool(t.item())


def create_mesh(num_data: Optional[int] = None, num_sample: int = 1) -> Mesh:
    """The mesh over the world's ranks (a collective: every rank calls it
    with the same arguments).  ``num_data`` defaults to the world over
    ``num_sample``."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if num_data is None:
        num_data = world // num_sample
    if num_data * num_sample != world:
        raise ValueError(f"mesh {num_data}x{num_sample} != {world} ranks")
    data_groups = [dist.new_group([d * num_sample + s
                                   for d in range(num_data)])
                   for s in range(num_sample)]
    sample_groups = [dist.new_group([d * num_sample + s
                                     for s in range(num_sample)])
                     for d in range(num_data)]
    host = (dist.group.WORLD if dist.get_backend() == "gloo"
            else dist.new_group(backend="gloo"))
    return Mesh(num_data, num_sample, rank,
                data_groups[rank % num_sample],
                sample_groups[rank // num_sample], host)


def shard_batch(mesh: Mesh, batch, axis: int = 0):
    """This rank's contiguous share of a batch's rows along ``axis`` (1 for
    ``[K, B, ...]`` stacks): a dict of arrays or tensors, a dict ``cond``
    of them included.  The batch must split evenly over ``data``."""
    def rows(a):
        n = a.shape[axis]
        if n % mesh.num_data:
            raise ValueError(f"a batch of {n} does not split over "
                             f"{mesh.num_data} data ranks")
        b = n // mesh.num_data
        index = (slice(None),) * axis + (
            slice(mesh.data_index * b, (mesh.data_index + 1) * b),)
        return a[index]
    return tree_map(rows, batch)
