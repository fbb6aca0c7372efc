"""Priors of the top of the flow (counterpart of
``categoricalnf_tpu/flows/distributions.py``): the factorized logistic and
normal priors, and the learned HMM prior of the language models.

Each ``sample`` takes ``noise``, the uniform draw itself, so that a caller
can feed two devices or two frameworks the same numbers; its shape is the
prior's ``noise_shape(shape)``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from categoricalnf_tpu_torch.flows.base import sum_ldj
from categoricalnf_tpu_torch.ops import numerics as nm


class LogisticPrior:
    """Standard factorized logistic prior (no parameters)."""

    def log_prob(self, z: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return sum_ldj(nm.logistic_log_pdf(z, 0.0, 0.0), mask)

    def noise_shape(self, shape) -> tuple:
        return tuple(shape)

    def sample(self, shape, temperature: float = 1.0, *, generator=None,
               noise=None, device=None) -> torch.Tensor:
        """Draw from the prior; ``temperature`` scales the base logistic.
        ``noise`` is the uniform draw (see ``numerics.logistic_sample``)."""
        return nm.logistic_sample(shape, generator=generator, noise=noise,
                                  device=device) * temperature


class GaussianPrior:
    """Standard factorized normal prior (no parameters)."""

    def log_prob(self, z: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        z32 = nm.at_least_f32(z)
        return sum_ldj(-0.5 * (z32 ** 2 + math.log(2.0 * math.pi)), mask)

    def noise_shape(self, shape) -> tuple:
        return tuple(shape)

    def sample(self, shape, temperature: float = 1.0, *, generator=None,
               noise=None, device=None) -> torch.Tensor:
        """Normal draws by the inverse CDF of the uniform ``noise`` (drawn
        from ``generator`` when it is None)."""
        if noise is None:
            noise = nm.uniform_noise(shape, generator=generator,
                                     device=device)
        u = nm.at_least_f32(noise).clamp(nm.NOISE_EPS, 1.0 - nm.NOISE_EPS)
        return math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0) * temperature


class HMMPrior(nn.Module):
    """Latent state-space prior: p(z) = sum_s p(s) prod_t q(z_t | s_t), a
    learned S-state Markov chain over time with factorized-logistic
    emissions per state.  Its parameters (``start_logits`` [S],
    ``trans_logits`` [S, S], ``means`` and ``log_scales`` [S, D]) are a
    submodule of the flow, so the optimizer trains them with the layers.
    The density runs in fp32; the forward recursion is a loop over T of a
    logsumexp over [B, S, S]."""

    # the clip of the emissions' log-scales, which keeps densities finite
    min_log_sigma, max_log_sigma = -4.6, 2.3

    def __init__(self, event_dim: int, num_states: int = 32, *,
                 generator=None):
        super().__init__()
        self.num_states = num_states
        S, D = num_states, event_dim
        self.start_logits = nn.Parameter(torch.zeros(S))
        self.trans_logits = nn.Parameter(torch.zeros(S, S))
        self.means = nn.Parameter(torch.randn(S, D, generator=generator))
        self.log_scales = nn.Parameter(torch.zeros(S, D))

    def _log_scales(self):
        return self.log_scales.clamp(self.min_log_sigma, self.max_log_sigma)

    def _emissions(self, z: torch.Tensor) -> torch.Tensor:
        """log q(z_t | s) for all states: [B, T, S]."""
        return nm.logistic_log_pdf(nm.at_least_f32(z)[..., None, :],
                                   self.means, self._log_scales()).sum(-1)

    def log_prob(self, z: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        emit = self._emissions(z)                          # [B, T, S]
        log_T = torch.log_softmax(self.trans_logits, dim=-1)
        log_pi = torch.log_softmax(self.start_logits, dim=-1)

        def trans(log_alpha, emit_t):
            return torch.logsumexp(log_alpha[:, :, None] + log_T[None],
                                   dim=1) + emit_t

        if mask is None:
            log_alpha = log_pi[None] + emit[:, 0]
            for t in range(1, emit.shape[1]):
                log_alpha = trans(log_alpha, emit[:, t])
            return torch.logsumexp(log_alpha, dim=-1)

        # masked positions are skipped: the chain applies an identity
        # transition across them, so the density is that of the valid
        # positions concatenated into a shorter sequence
        m = nm.at_least_f32(mask) > 0.5                    # [B, T]
        log_alpha = emit.new_zeros(emit.shape[0], emit.shape[2])
        started = torch.zeros_like(m[:, 0])
        for t in range(emit.shape[1]):
            valid = torch.where(started[:, None], trans(log_alpha, emit[:, t]),
                                log_pi[None] + emit[:, t])
            log_alpha = torch.where(m[:, t, None], valid, log_alpha)
            started = started | m[:, t]
        lp = torch.logsumexp(log_alpha, dim=-1)
        # all-masked rows have probability 1 over the empty sequence
        return torch.where(started, lp, torch.zeros_like(lp))

    def noise_shape(self, shape) -> tuple:
        """[B, T, D + 1]: channel D draws the state chain, the first D the
        emissions."""
        return (*shape[:-1], shape[-1] + 1)

    def sample(self, shape, temperature: float = 1.0, *, generator=None,
               noise=None, device=None) -> torch.Tensor:
        """z [B, T, D]: a state chain (the start and transition
        distributions sharpened by 1 / temperature), then logistic
        emissions whose scales are times the temperature.  Each state is
        the inverse CDF of its categorical at the uniform of channel D of
        ``noise``; the reference draws the same distributions with Gumbel
        maxima."""
        B, T, D = shape
        if noise is None:
            noise = nm.uniform_noise(self.noise_shape(shape),
                                     generator=generator,
                                     device=device or self.means.device)
        u = nm.at_least_f32(noise)
        inv_t = 1.0 / max(float(temperature), 1e-3)
        cdf_T = torch.softmax(
            torch.log_softmax(self.trans_logits, dim=-1) * inv_t,
            dim=-1).cumsum(-1)
        cdf_pi = torch.softmax(
            torch.log_softmax(self.start_logits, dim=-1) * inv_t,
            dim=-1).cumsum(-1)
        last = self.num_states - 1
        u_chain = u[..., D].t().contiguous()[..., None]    # [T, B, 1]
        s = torch.searchsorted(cdf_pi.expand(B, -1).contiguous(),
                               u_chain[0]).clamp(max=last)[:, 0]
        chain = [s]
        for t in range(1, T):
            s = torch.searchsorted(cdf_T[s], u_chain[t]).clamp(max=last)[:, 0]
            chain.append(s)
        chain = torch.stack(chain, dim=1)                  # [B, T]
        ls = self._log_scales()[chain] + math.log(max(float(temperature),
                                                      1e-3))
        return nm.logistic_sample((B, T, D), self.means[chain], ls,
                                  noise=u[..., :D])


def create_prior(name: Optional[str], event_dim: int, *, generator=None,
                 **kw):
    """The prior named ``name``; ``kw`` go to the HMM prior
    (``num_states``)."""
    if name in ("logistic", "logistic_mixture", None):
        return LogisticPrior()
    if name in ("gaussian", "normal"):
        return GaussianPrior()
    if name == "hmm":
        return HMMPrior(event_dim, generator=generator, **kw)
    raise ValueError(f"unknown prior {name!r}")
