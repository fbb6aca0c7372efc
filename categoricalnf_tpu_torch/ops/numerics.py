"""Logistic / mixture-of-logistics primitives in fp32 (plain PyTorch).

Counterpart of ``categoricalnf_tpu/ops/numerics.py``: the same log-space
formulas, the same clip of the log-scales, the same 42-bisection + 3-Newton
inverse.  These functions are the plain versions of the CUDA mixture
kernels (``ops/cuda/mixture.py``) and the path every CPU tensor takes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Lower bound keeps every component resolvable in fp32 (see the reference's
# note); it must stay below the encoder's min log-sigma (-4.6).
LOG_SCALE_MIN = -5.0
LOG_SCALE_MAX = 7.0

# Uniform noise is clipped away from {0, 1} before the logit.
NOISE_EPS = 1e-6


def at_least_f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` if it is float64, else ``t.float()``: the plain path computes
    in fp32, or in float64 throughout where its inputs are float64 (the
    step that the fp32 train step's gradients are held against)."""
    return t if t.dtype == torch.float64 else t.float()


def _like(v, ref: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=ref.dtype, device=ref.device)


def logistic_log_pdf(x, mean, log_scale) -> torch.Tensor:
    """log pdf of Logistic(mean, exp(log_scale)) at x, in fp32."""
    x = at_least_f32(x)
    mean, log_scale = _like(mean, x), _like(log_scale, x)
    z = (x - mean) * torch.exp(-log_scale)
    return -z - 2.0 * F.softplus(-z) - log_scale


def uniform_noise(shape, *, generator=None, device=None) -> torch.Tensor:
    """Uniform in [NOISE_EPS, 1 - NOISE_EPS), as ``jax.random.uniform``
    with minval/maxval draws it."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    return u * (1.0 - 2.0 * NOISE_EPS) + NOISE_EPS


def logistic_sample(shape, mean=0.0, log_scale=0.0, *, generator=None,
                    noise=None, device=None) -> torch.Tensor:
    """Inverse-CDF logistic sample.  ``noise`` (uniform, ``shape``) replaces
    the draw so that a caller can feed both frameworks the same numbers."""
    if noise is None:
        noise = uniform_noise(shape, generator=generator, device=device)
    u = at_least_f32(noise).clamp(NOISE_EPS, 1.0 - NOISE_EPS)
    logit_u = torch.log(u) - torch.log1p(-u)
    return _like(mean, u) + torch.exp(_like(log_scale, u)) * logit_u


def _log_sigmoid_pair(z: torch.Tensor):
    """(log sigmoid(z), log sigmoid(-z)) from one softplus, via the exact
    identity log sigmoid(-z) = log sigmoid(z) - z."""
    lsp = F.logsigmoid(z)
    return lsp, lsp - z


def _prep(pi_logits, means, log_scales):
    log_pi = torch.log_softmax(at_least_f32(pi_logits), dim=-1)
    log_scales = at_least_f32(log_scales).clamp(LOG_SCALE_MIN, LOG_SCALE_MAX)
    return log_pi, at_least_f32(means), log_scales


def mixture_logit_cdf_and_ldj(x, pi_logits, means, log_scales):
    """y = log F(x) - log(1 - F(x)) and ldj = log f - log F - log(1 - F)
    for a K-logistic mixture; parameters are ``[..., K]``, x is ``[...]``."""
    log_pi, means, log_scales = _prep(pi_logits, means, log_scales)
    z = (at_least_f32(x)[..., None] - means) * torch.exp(-log_scales)
    lsp, lsn = _log_sigmoid_pair(z)
    log_cdf = torch.logsumexp(log_pi + lsp, dim=-1)
    log_sf = torch.logsumexp(log_pi + lsn, dim=-1)
    log_pdf = torch.logsumexp(log_pi + lsp + lsn - log_scales, dim=-1)
    return log_cdf - log_sf, log_pdf - log_cdf - log_sf


def mixture_inverse_logit_cdf(y, pi_logits, means, log_scales, *,
                              num_bisect: int = 42,
                              num_newton: int = 3) -> torch.Tensor:
    """Invert x -> logit F(x): bisection in the exact bracket
    [min_k, max_k](mu_k + s_k y), then Newton steps clipped to it."""
    y = at_least_f32(y)
    log_pi, means, log_scales = _prep(pi_logits, means, log_scales)
    cand = means + torch.exp(log_scales) * y[..., None]
    lo0 = cand.min(dim=-1).values
    hi0 = cand.max(dim=-1).values
    inv_scales = torch.exp(-log_scales)

    def parts(x):
        z = (x[..., None] - means) * inv_scales
        lsp, lsn = _log_sigmoid_pair(z)
        return lsp, lsn, (torch.logsumexp(log_pi + lsp, dim=-1),
                          torch.logsumexp(log_pi + lsn, dim=-1))

    lo, hi = lo0, hi0
    for _ in range(num_bisect):
        mid = 0.5 * (lo + hi)
        _, _, (log_cdf, log_sf) = parts(mid)
        go_right = (log_cdf - log_sf) < y
        lo = torch.where(go_right, mid, lo)
        hi = torch.where(go_right, hi, mid)
    x = 0.5 * (lo + hi)
    for _ in range(num_newton):
        lsp, lsn, (log_cdf, log_sf) = parts(x)
        log_pdf = torch.logsumexp(log_pi + lsp + lsn - log_scales, dim=-1)
        step = (log_cdf - log_sf - y) * torch.exp(log_cdf + log_sf - log_pdf)
        x = torch.minimum(torch.maximum(x - step, lo), hi)
    return x


def mixture_inverse_loop_vjp(y, pi_logits, means, log_scales, gx, *,
                             num_bisect: int = 42, num_newton: int = 3):
    """(gy, gpi, gmu, gls): the cotangent ``gx`` of
    ``mixture_inverse_logit_cdf``'s root pulled back through its loop, as
    reverse mode does (the reference's rule, XLA's autodiff of its loop;
    autograd through the loop is the spec), by the algorithm of the CUDA
    inverse's backward (#1', ``mixture_inverse_loop_bwd_f32``), of which
    this is the plain version: the loop rerun from the inputs, each
    bisection's bracket kept as a lo0 + b hi0 (the comparisons pass no
    gradient), the Newton iterates and their clip weights kept (1/2 to each
    side at a tie), then the steps reversed by their first derivatives, the
    bracket's ends to their arg-min and arg-max components (shared among
    ties), the log-softmax, and 0 for a clipped log-scale."""
    with torch.no_grad():
        y = at_least_f32(y)
        logits = at_least_f32(pi_logits)
        log_pi = torch.log_softmax(logits, dim=-1)
        raw = at_least_f32(log_scales)
        inside = (raw >= LOG_SCALE_MIN) & (raw <= LOG_SCALE_MAX)
        log_scales = raw.clamp(LOG_SCALE_MIN, LOG_SCALE_MAX)
        means = at_least_f32(means)
        scale = torch.exp(log_scales)
        cand = means + scale * y[..., None]
        lo0 = cand.min(dim=-1).values
        hi0 = cand.max(dim=-1).values
        inv_scales = torch.exp(-log_scales)

        def parts(x):
            z = (x[..., None] - means) * inv_scales
            lsp, lsn = _log_sigmoid_pair(z)
            a, b = log_pi + lsp, log_pi + lsn
            c = log_pi + lsp + lsn - log_scales
            return z, lsp, (a, b, c), [torch.logsumexp(t, dim=-1)
                                       for t in (a, b, c)]

        one, zero = torch.ones_like(lo0), torch.zeros_like(lo0)
        lo, hi, la, lb, ha, hb = lo0, hi0, one, zero, zero, one
        for _ in range(num_bisect):
            mid = 0.5 * (lo + hi)
            ma, mb = 0.5 * (la + ha), 0.5 * (lb + hb)
            _, _, _, (log_cdf, log_sf, _) = parts(mid)
            right = (log_cdf - log_sf) < y
            lo, la, lb = (torch.where(right, new, old) for new, old in
                          ((mid, lo), (ma, la), (mb, lb)))
            hi, ha, hb = (torch.where(right, old, new) for new, old in
                          ((mid, hi), (ma, ha), (mb, hb)))
        x = 0.5 * (lo + hi)
        trace = []
        for _ in range(num_newton):
            _, _, _, (log_cdf, log_sf, log_pdf) = parts(x)
            u = x - (log_cdf - log_sf - y) * torch.exp(log_cdf + log_sf
                                                       - log_pdf)
            m = torch.maximum(u, lo)
            to_u = torch.where(u > lo, 1.0, torch.where(u == lo, 0.5, 0.0))
            to_m = torch.where(m < hi, 1.0, torch.where(m == hi, 0.5, 0.0))
            trace.append((x, to_m * to_u, to_m * (1 - to_u), 1 - to_m))
            x = torch.minimum(m, hi)

        g = at_least_f32(gx)
        g_lo, g_hi, g_y = zero, zero, zero
        g_lp = g_mu = g_ls = torch.zeros_like(cand)
        for x, w_u, w_lo, w_hi in reversed(trace):
            g_lo, g_hi = g_lo + g * w_lo, g_hi + g * w_hi
            g_u = g * w_u
            z, lsp, (a, b, c), (log_cdf, log_sf, log_pdf) = parts(x)
            f = log_cdf - log_sf - y
            e = torch.exp(log_cdf + log_sf - log_pdf)
            g_f, g_e = -g_u * e, -g_u * f * e
            ga = (g_f + g_e)[..., None] * torch.exp(a - log_cdf[..., None])
            gb = (g_e - g_f)[..., None] * torch.exp(b - log_sf[..., None])
            gc = -g_e[..., None] * torch.exp(c - log_pdf[..., None])
            g_y = g_y - g_f
            g_lp = g_lp + ga + gb + gc
            gz = (ga + gc) * torch.exp(lsp - z) - (gb + gc) * torch.exp(lsp)
            g = g_u + (gz * inv_scales).sum(-1)
            g_mu = g_mu - gz * inv_scales
            g_ls = g_ls - gc - gz * z
        g_lo_end, g_hi_end = 0.5 * g + g_lo, 0.5 * g + g_hi
        g_lo0 = g_lo_end * la + g_hi_end * ha
        g_hi0 = g_lo_end * lb + g_hi_end * hb
        at_lo, at_hi = cand == lo0[..., None], cand == hi0[..., None]
        g_cand = (at_lo * (g_lo0 / at_lo.sum(-1))[..., None]
                  + at_hi * (g_hi0 / at_hi.sum(-1))[..., None])
        g_mu = g_mu + g_cand
        g_y = g_y + (g_cand * scale).sum(-1)
        g_ls = g_ls + g_cand * scale * y[..., None]
        g_pi = g_lp - torch.exp(log_pi) * g_lp.sum(-1, keepdim=True)
        return g_y, g_pi, g_mu, torch.where(inside, g_ls, 0.0)


def mixture_inverse_vjp(x, pi_logits, means, log_scales, gx):
    """The implicit rule at the root ``x`` of logit F(x; theta) = y, for
    the cotangent ``gx``: (gy, gpi, gmu, gls) with gy = gx exp(-ldj(x)) and
    the parameters' gradients -gy dy/dtheta (0 for a clipped log-scale):
    the exact derivative.  The plain version of the implicit-rule launches
    (``ops/cuda/mixture.py`` ``mixture_inverse_bwd_cuda``), which are on no
    path of the port: the reference, and with it the port on both devices,
    differentiates the inverse's loop instead (``mixture_inverse_loop_vjp``);
    the checks hold this rule beside that one as their control."""
    with torch.enable_grad():
        params = [t.detach().requires_grad_(True)
                  for t in (pi_logits, means, log_scales)]
        y, ldj = mixture_logit_cdf_and_ldj(x.detach(), *params)
        gy = at_least_f32(gx) * torch.exp(-ldj.detach())
        grads = torch.autograd.grad(y, params, grad_outputs=-gy)
    return (gy, *grads)


class ImplicitInverse(torch.autograd.Function):
    """The plain inverse with the implicit rule for its backward
    (``mixture_inverse_vjp``), on no path of the port; chip_smoke puts it in
    ``dispatch.mixture_inverse`` as the control of its vardeq step check."""

    @staticmethod
    def forward(ctx, y, pi_logits, means, log_scales):
        x = mixture_inverse_logit_cdf(y, pi_logits, means, log_scales)
        ctx.save_for_backward(x, pi_logits, means, log_scales)
        return x

    @staticmethod
    def backward(ctx, gx):
        return mixture_inverse_vjp(*ctx.saved_tensors, gx)
