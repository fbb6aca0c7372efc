"""ScannedBlocks: ``depth`` copies of one block of transforms, in order.

Counterpart of ``categoricalnf_tpu/flows/scanned.py``.  The reference
scans one traced block over parameters stacked along a depth axis; in
PyTorch the stack is an unrolled loop over ``blocks``, an ``nn.ModuleList``
of ``depth`` ``nn.ModuleList``s that each hold their own parameters
(``blocks.<d>.<i>.<name>``; ``convert.from_jax_params`` splits the
reference's depth axis into these names).  ``remat=True`` recomputes each
block's activations in the backward pass instead of storing them
(``torch.utils.checkpoint``), as ``jax.checkpoint`` does on the scan body.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from categoricalnf_tpu_torch.flows.base import Transform
from categoricalnf_tpu_torch.ops.numerics import at_least_f32


class ScannedBlocks(Transform):
    has_data_init = True

    def __init__(self, blocks: Sequence[Sequence[Transform]], *,
                 remat: bool = False, unroll: int = 1):
        """``blocks``: one sequence of transforms for each depth, all of the
        same layer types.  ``unroll`` is the reference's ``lax.scan``
        unroll factor, accepted for saved configs; the loop here is
        unrolled whatever it says, which the reference states leaves the
        results unchanged."""
        super().__init__()
        kinds = [tuple(map(type, b)) for b in blocks]
        if not kinds or any(k != kinds[0] for k in kinds):
            raise ValueError(f"ScannedBlocks takes blocks of one layer "
                             f"sequence, got {kinds}")
        self.blocks = nn.ModuleList(nn.ModuleList(b) for b in blocks)
        self.remat = remat

    @staticmethod
    def _run(layers, z, ldj, cond, mask):
        for layer in layers:
            z, ldj = layer(z, ldj, cond=cond, mask=mask)
        return z, ldj

    def forward(self, z, ldj, *, cond=None, mask=None):
        for block in self.blocks:
            if self.remat and torch.is_grad_enabled():
                z, ldj = checkpoint(self._run, block, z, ldj, cond, mask,
                                    use_reentrant=False)
            else:
                z, ldj = self._run(block, z, ldj, cond, mask)
        return z, ldj

    def inverse(self, z, ldj, *, cond=None, mask=None):
        for block in reversed(self.blocks):
            for layer in reversed(block):
                z, ldj = layer.inverse(z, ldj, cond=cond, mask=mask)
        return z, ldj

    @torch.no_grad()
    def data_init(self, z, *, cond=None, mask=None):
        """Block by block, as the reference's; a layer without data init
        runs its forward."""
        for block in self.blocks:
            for layer in block:
                if layer.has_data_init:
                    z = layer.data_init(z, cond=cond, mask=mask)
                else:
                    z, _ = layer(z, at_least_f32(z.new_zeros(z.shape[0])),
                                 cond=cond, mask=mask)
        return z
