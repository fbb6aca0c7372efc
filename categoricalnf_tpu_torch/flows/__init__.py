from categoricalnf_tpu_torch.flows.actnorm import ActNorm, ExtActNorm
from categoricalnf_tpu_torch.flows.base import Transform, apply_mask, sum_ldj
from categoricalnf_tpu_torch.flows.cond_affine import ConditionalAffine
from categoricalnf_tpu_torch.flows.coupling import (MixtureCDFCoupling,
                                                    make_channel_mask,
                                                    make_checker_mask)
from categoricalnf_tpu_torch.flows.autoregressive import \
    AutoregressiveMixtureCDF
from categoricalnf_tpu_torch.flows.distributions import (GaussianPrior,
                                                         HMMPrior,
                                                         LogisticPrior,
                                                         create_prior)
from categoricalnf_tpu_torch.flows.linear import (InvertibleLinear,
                                                  ReverseChannels)
from categoricalnf_tpu_torch.flows.model import FlowModel
from categoricalnf_tpu_torch.flows.scanned import ScannedBlocks
from categoricalnf_tpu_torch.flows.sigmoid import Logit, Sigmoid
from categoricalnf_tpu_torch.flows.softclamp import SoftClamp
from categoricalnf_tpu_torch.flows.stack import coupling_stack

__all__ = [
    "Transform", "apply_mask", "sum_ldj", "ActNorm", "ExtActNorm",
    "AutoregressiveMixtureCDF", "ConditionalAffine", "MixtureCDFCoupling",
    "make_channel_mask", "make_checker_mask", "GaussianPrior", "HMMPrior",
    "LogisticPrior", "create_prior", "InvertibleLinear", "FlowModel",
    "Logit", "ReverseChannels", "ScannedBlocks", "Sigmoid", "SoftClamp",
    "coupling_stack",
]
