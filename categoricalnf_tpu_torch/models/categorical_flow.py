"""CategoricalFlow: encoding + continuous flow + prior, end to end.

Counterpart of ``categoricalnf_tpu/models/categorical_flow.py``:

    log p(x) >= E_q(z|x) [ log p(z) + log p(x|z) - log q(z|x) ]

Bits per variable divide by the (masked) variable count and ln 2.  The
importance-sampled bound runs its chains as a batch dimension, 16 chains at
a time.  Every method that draws noise takes a ``torch.Generator`` and an
optional ``noise`` (the uniform draw itself) so tests can feed both
frameworks the same numbers.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from categoricalnf_tpu_torch.ops.numerics import at_least_f32
from categoricalnf_tpu_torch.utils.tree import tree_map

LN2 = 0.6931471805599453


def _num_vars(x, mask):
    if mask is None:
        return torch.full((x.shape[0],), float(x.shape[1]),
                          dtype=torch.float32, device=x.device)
    return at_least_f32(mask).sum(dim=1)


def _tile(t, n):
    """[B, ...] -> [n * B, ...] (chain-major), for a tensor or a dict of
    them."""
    return tree_map(lambda v: v.repeat(n, *([1] * (v.dim() - 1))), t)


class CategoricalFlow(nn.Module):
    def __init__(self, encoding: nn.Module, flow: nn.Module):
        super().__init__()
        self.encoding = encoding
        self.flow = flow

    def elbo(self, x, *, cond=None, mask=None, generator=None, noise=None):
        """Single-sample ELBO parts, per batch element."""
        z, log_q = self.encoding.encode(x, mask=mask, generator=generator,
                                        noise=noise)
        log_pz = self.flow.log_prob(z, cond=cond, mask=mask)
        log_dec = self.encoding.log_decoder(x, z, mask=mask)
        return {"elbo": log_pz + log_dec - log_q, "log_pz": log_pz,
                "log_dec": log_dec, "log_q": log_q}

    def loss_bpd(self, x, beta=1.0, *, cond=None, mask=None, generator=None,
                 noise=None, batch_mean=None):
        """Mean bits/variable of the beta-annealed ELBO, plus the reference's
        positive-ELBO guard: a positive batch-mean ELBO certifies that the
        flow exploits a gap between its claimed ldj and the fp32 map, and
        the quadratic penalty points the gradient back out (inert in
        legitimate training).  ``batch_mean`` (default ``torch.mean``)
        takes that mean, over the global batch where ``x`` is one rank's
        rows."""
        parts = self.elbo(x, cond=cond, mask=mask, generator=generator,
                          noise=noise)
        obj = parts["log_pz"] + parts["log_dec"] - beta * parts["log_q"]
        n = _num_vars(x, mask)
        loss = torch.mean(-obj / (n * LN2))
        cheat = torch.relu((batch_mean or torch.mean)(parts["elbo"]
                                                      / (n * LN2)))
        return loss + 10.0 * cheat * cheat

    def iw_log_prob(self, x, num_samples: int, *, cond=None, mask=None,
                    generator=None, noise=None):
        """Importance-sampled log p(x) bound [B].  ``noise``, if given, is
        [S, B, T, D]; chains run in chunks of 16 as a batch dimension."""
        B = x.shape[0]
        chunk = num_samples if num_samples % 16 else 16
        elbos = []
        for s0 in range(0, num_samples, chunk):
            c = min(chunk, num_samples - s0)
            nz = None if noise is None else noise[s0:s0 + c].reshape(
                c * B, *noise.shape[2:])
            e = self.elbo(_tile(x, c), cond=_tile(cond, c),
                          mask=_tile(mask, c), generator=generator,
                          noise=nz)["elbo"]
            elbos.append(e.reshape(c, B))
        elbos = torch.cat(elbos, dim=0)
        return torch.logsumexp(elbos, dim=0) - math.log(num_samples)

    def eval_bpd(self, x, num_samples: int = 1, *, cond=None, mask=None,
                 generator=None, noise=None):
        ll = self.iw_log_prob(x, num_samples, cond=cond, mask=mask,
                              generator=generator, noise=noise)
        return -ll / (_num_vars(x, mask) * LN2)

    def sample(self, batch: int, num_pos: int, *, cond=None, mask=None,
               temperature: float = 1.0, generator=None, noise=None):
        """Ancestral samples [batch, num_pos]: prior draw, flow inverse,
        Bayes decode."""
        shape = (batch, num_pos, self.encoding.dim)
        z = self.flow.sample(shape, cond=cond, mask=mask,
                             temperature=temperature, generator=generator,
                             noise=noise,
                             device=next(self.parameters()).device)
        return self.encoding.decode(z, mask=mask)

    @torch.no_grad()
    def data_init(self, x, *, cond=None, mask=None, generator=None,
                  noise=None):
        """Calibration pass: ActNorm layers absorb activation statistics."""
        z, _ = self.encoding.encode(x, mask=mask, generator=generator,
                                    noise=noise)
        self.flow.data_init(z, cond=cond, mask=mask)
