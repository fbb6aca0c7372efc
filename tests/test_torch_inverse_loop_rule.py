"""The inverse's backward by the reference's rule, on the CPU.

The reference trains its vardeq and linear-flows encoders through
``jax.vjp`` of its inverse's loop (42 bisections, 3 Newton steps clipped
to the bracket), and the port's card takes the same rule
(``mixture_inverse_loop_bwd_f32``).  Here its plain version,
``numerics.mixture_inverse_loop_vjp`` (the kernel's algorithm in PyTorch),
is held against autograd through the port's plain loop (its spec) and
against ``jax.vjp`` of the reference's loop; the implicit rule
(``numerics.mixture_inverse_vjp``, the exact derivative) is the control
that fails the same rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from categoricalnf_tpu.ops import numerics as jnm
from categoricalnf_tpu_torch.ops import numerics as nm

# one intra-op thread: pytest-xdist runs six workers at once, and each at
# torch's default pool oversubscribes the cores on these small tensors
torch.set_num_threads(1)

NAMES = ("gy", "gpi", "gmu", "gls")


def _inputs(seed, k, shape=(64, 8)):
    """y = logit F(x) of drawn x for K-logistic mixtures, and a cotangent."""
    r = np.random.default_rng(seed)
    x = (r.standard_normal(shape) * 2).astype(np.float32)
    pi = r.standard_normal(shape + (k,)).astype(np.float32)
    mu = (r.standard_normal(shape + (k,)) * 2).astype(np.float32)
    ls = (r.standard_normal(shape + (k,)) * 0.5 - 0.5).astype(np.float32)
    y, _ = nm.mixture_logit_cdf_and_ldj(*map(torch.tensor, (x, pi, mu, ls)))
    gx = r.standard_normal(shape).astype(np.float32)
    return y.numpy(), pi, mu, ls, gx


def _near(g, r, rel=1e-3, floor=1e-4):
    """Elementwise: within ``rel`` of the reference plus ``floor`` of its
    largest magnitude."""
    g, r = np.asarray(g, np.float64), np.asarray(r, np.float64)
    return np.abs(g - r) <= rel * np.abs(r) + floor * np.abs(r).max()


def _mirror(y, pi, mu, ls, gx):
    return [g.numpy() for g in nm.mixture_inverse_loop_vjp(
        *map(torch.tensor, (y, pi, mu, ls, gx)))]


def _jax_vjp(y, pi, mu, ls, gx):
    _, vjp = jax.vjp(jax.jit(jnm.mixture_inverse_logit_cdf),
                     *map(jnp.asarray, (y, pi, mu, ls)))
    return [np.asarray(g) for g in vjp(jnp.asarray(gx))]


@pytest.mark.parametrize("k", [4, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_loop_mirror_matches_autograd_of_the_plain_loop(seed, k):
    """The mirror runs the plain loop's operations, so its bisections take
    the same branches; it differs from autograd only in the order of its
    sums: every element within 1e-3 of the reference plus 1e-4 of the
    tensor's largest magnitude (100% read so)."""
    y, pi, mu, ls, gx = _inputs(seed, k)
    ts = [torch.tensor(a, requires_grad=True) for a in (y, pi, mu, ls)]
    ref = torch.autograd.grad(nm.mixture_inverse_logit_cdf(*ts), ts,
                              torch.tensor(gx))
    got = _mirror(y, pi, mu, ls, gx)
    for name, g, r in zip(NAMES, got, ref):
        assert g.shape == tuple(r.shape), name
        assert _near(g, r.numpy()).all(), name


@pytest.mark.parametrize("k", [4, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_loop_mirror_matches_the_reference_gradient(seed, k):
    """The mirror against ``jax.vjp`` of the reference's loop by
    ``test_plain_inverse_autograd_matches_reference``'s rule: within 1e-3
    of itself plus 1e-4 of the tensor's largest magnitude on at least 90%
    of the elements (a one-ulp difference of a bisection's midpoint sends
    the rest of an element's loop another way)."""
    y, pi, mu, ls, gx = _inputs(seed, k)
    ref = _jax_vjp(y, pi, mu, ls, gx)
    got = _mirror(y, pi, mu, ls, gx)
    for name, g, r in zip(NAMES, got, ref):
        assert _near(g, r).mean() >= 0.9, name


@pytest.mark.parametrize("seed", [0, 1])
def test_implicit_rule_fails_the_reference_rule(seed):
    """The control: the implicit rule (the exact derivative, at the plain
    root) fails the same rule against ``jax.vjp`` on some gradient, so the
    rule tells the two apart."""
    y, pi, mu, ls, gx = _inputs(seed, 4)
    ref = _jax_vjp(y, pi, mu, ls, gx)
    x = nm.mixture_inverse_logit_cdf(*map(torch.tensor, (y, pi, mu, ls)))
    got = nm.mixture_inverse_vjp(x, *map(torch.tensor, (pi, mu, ls, gx)))
    assert min(_near(g.numpy(), r).mean() for g, r in zip(got, ref)) < 0.9


def test_loop_mirror_clipped_log_scales_and_float64():
    """A log-scale outside the clip gets no gradient, as the reference's
    clip passes none; the mirror runs in float64 on float64 inputs."""
    y, pi, mu, ls, gx = _inputs(3, 4, (16, 4))
    ls[..., 0] = -9.0
    ls[..., 1] = 8.0
    got = nm.mixture_inverse_loop_vjp(
        *map(lambda a: torch.tensor(a, dtype=torch.float64),
             (y, pi, mu, ls, gx)))
    assert all(g.dtype == torch.float64 for g in got)
    assert not got[3][..., :2].any()
    assert got[3][..., 2:].abs().max() > 0
