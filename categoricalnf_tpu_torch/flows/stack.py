"""The coupling stack that the set, graph-coloring and molecule flows share."""

from __future__ import annotations

from categoricalnf_tpu_torch.flows.actnorm import ActNorm
from categoricalnf_tpu_torch.flows.coupling import MixtureCDFCoupling
from categoricalnf_tpu_torch.flows.linear import InvertibleLinear
from categoricalnf_tpu_torch.flows.model import FlowModel
from categoricalnf_tpu_torch.flows.scanned import ScannedBlocks
from categoricalnf_tpu_torch.flows.softclamp import SoftClamp


def coupling_stack(make_net, dim: int, num_layers: int, num_mixtures: int,
                   *, scan: bool = True, remat: bool = False,
                   unroll: int = 1, generator=None) -> FlowModel:
    """num_layers x [ActNorm, InvertibleLinear, MixtureCDFCoupling(make_net()),
    SoftClamp], parities alternating.  With ``scan`` at an even depth of at
    least 4 the stack is one ``ScannedBlocks`` of ``num_layers // 2``
    two-parity blocks, which takes ``remat`` and ``unroll``; unrolled
    otherwise, which ignores both, as the reference's does."""
    def sub(parity):
        net = make_net()
        return [ActNorm(dim), InvertibleLinear(dim, generator=generator),
                MixtureCDFCoupling(net, dim, parity=parity,
                                   num_mixtures=num_mixtures,
                                   generator=generator),
                SoftClamp()]

    if scan and num_layers % 2 == 0 and num_layers >= 4:
        return FlowModel([ScannedBlocks(
            [sub(0) + sub(1) for _ in range(num_layers // 2)], remat=remat,
            unroll=unroll)])
    layers = []
    for i in range(num_layers):
        layers += sub(i % 2)
    return FlowModel(layers)
