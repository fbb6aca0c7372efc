"""Route the mixture-CDF hot paths by device.

A CUDA tensor always goes to the hand-written kernel (``ops/cuda/mixture``),
a CPU tensor to the plain fp32 version in ``ops.numerics``.  On the card the
forward is ``MixtureForward``, whose backward is a kernel too, and the
inverse is ``MixtureInverse``, whose backward (#1') is the loop-rule kernel:
it reruns the reference's loop (42 bisections, 3 clipped Newton steps) and
pulls the cotangent back through it as reverse mode does.  A CPU tensor's
inverse is differentiated through that loop by autograd.  So both devices
take the reference's gradient, XLA's reverse mode through the loop (the
reference sends every encoder's inverse to XLA: its Pallas inverse starts
at 2^17 elements, the encoders run 16,384 and 65,536).  There is no size
threshold: the TPU's was measured on a TPU, and one for the H100 has not
been measured yet.
"""

from __future__ import annotations

from categoricalnf_tpu_torch.ops import numerics as nm
from categoricalnf_tpu_torch.ops.cuda import mixture as cuda_mixture


def mixture_inverse(y, pi_logits, means, log_scales):
    """Invert x -> logit(MixLogCDF(x))."""
    if y.is_cuda:
        return cuda_mixture.mixture_inverse_cuda(y, pi_logits, means,
                                                 log_scales)
    return nm.mixture_inverse_logit_cdf(y, pi_logits, means, log_scales)


def mixture_forward(x, pi_logits, means, log_scales):
    """(logit F(x), its log-derivative); differentiable on both devices."""
    if x.is_cuda:
        return cuda_mixture.mixture_forward_cuda(x, pi_logits, means,
                                                 log_scales)
    return nm.mixture_logit_cdf_and_ldj(x, pi_logits, means, log_scales)
