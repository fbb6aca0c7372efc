from categoricalnf_tpu_torch.flows.actnorm import ActNorm
from categoricalnf_tpu_torch.flows.base import Transform, apply_mask, sum_ldj
from categoricalnf_tpu_torch.flows.coupling import (MixtureCDFCoupling,
                                                    make_channel_mask)
from categoricalnf_tpu_torch.flows.distributions import LogisticPrior
from categoricalnf_tpu_torch.flows.linear import InvertibleLinear
from categoricalnf_tpu_torch.flows.model import FlowModel
from categoricalnf_tpu_torch.flows.scanned import ScannedBlocks
from categoricalnf_tpu_torch.flows.softclamp import SoftClamp

__all__ = [
    "Transform", "apply_mask", "sum_ldj", "ActNorm", "MixtureCDFCoupling",
    "make_channel_mask", "LogisticPrior", "InvertibleLinear", "FlowModel",
    "ScannedBlocks", "SoftClamp",
]
