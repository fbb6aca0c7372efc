"""The port's mixture-CDF numerics against the JAX package.

Inputs come from numpy and go to both sides.  The JAX side is
``categoricalnf_tpu.ops.numerics`` and the Pallas kernels in interpret mode,
as the JAX package's own tests run them on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from categoricalnf_tpu.ops import numerics as jnm
from categoricalnf_tpu.ops.pallas.mixture import (mixture_forward_pallas,
                                                  mixture_inverse_pallas)
from categoricalnf_tpu_torch.ops import dispatch
from categoricalnf_tpu_torch.ops import numerics as tnm

# one intra-op thread: pytest-xdist runs six workers at once, and each at
# torch's default pool oversubscribes the cores on these small tensors
torch.set_num_threads(1)


def _mix(seed, shape, k):
    r = np.random.default_rng(seed)
    f = lambda *s: r.standard_normal(s).astype(np.float32)
    return (f(*shape) * 2.0, f(*shape, k), f(*shape, k) * 2.0,
            f(*shape, k) * 0.5 - 0.5)


def _t(*arrs):
    return tuple(torch.tensor(np.asarray(a)) for a in arrs)


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


def test_constants_match():
    assert tnm.LOG_SCALE_MIN == jnm.LOG_SCALE_MIN
    assert tnm.LOG_SCALE_MAX == jnm.LOG_SCALE_MAX


def test_logistic_log_pdf_and_sample():
    """1e-5: the same fp32 formulas."""
    r = np.random.default_rng(0)
    x = r.standard_normal((16, 5)).astype(np.float32) * 3
    mu = r.standard_normal((16, 5)).astype(np.float32)
    ls = r.standard_normal((16, 5)).astype(np.float32) * 0.5
    _close(tnm.logistic_log_pdf(*_t(x, mu, ls)),
           jnm.logistic_log_pdf(x, mu, ls), 1e-5)
    u = r.uniform(1e-6, 1 - 1e-6, (16, 5)).astype(np.float32)
    z = tnm.logistic_sample(u.shape, torch.from_numpy(mu),
                            torch.from_numpy(ls), noise=torch.from_numpy(u))
    want = mu + np.exp(ls) * (np.log(u) - np.log1p(-u))
    _close(z, want, 1e-5)


@pytest.mark.parametrize("k", [3, 8])
def test_forward_matches_numerics_and_pallas(k):
    """(a) y and ldj to 1e-5 against numerics and the Pallas kernel."""
    x, pi, mu, ls = _mix(1, (32, 20), k)
    y, ldj = tnm.mixture_logit_cdf_and_ldj(*_t(x, pi, mu, ls))
    y_j, ldj_j = jnm.mixture_logit_cdf_and_ldj(x, pi, mu, ls)
    y_p, ldj_p = mixture_forward_pallas(x, pi, mu, ls, interpret=True)
    for got, want in ((y, y_j), (ldj, ldj_j), (y, y_p), (ldj, ldj_p)):
        _close(got, want, 1e-5)


def test_log_sigmoid_pair_both_tails():
    z = torch.linspace(-80, 80, 2001)
    lsp, lsn = tnm._log_sigmoid_pair(z)
    lsp_j, lsn_j = jnm._log_sigmoid_pair(jnp.asarray(z.numpy()))
    _close(lsp, lsp_j, 1e-5)
    _close(lsn, lsn_j, 1e-5)


def test_inverse_matches_numerics_and_pallas():
    """(b) 1e-4 against numerics (same algorithm) and the rtsafe kernel
    (another algorithm), and back to x to 1e-3."""
    x, pi, mu, ls = _mix(2, (16, 24), 5)
    y = np.asarray(jnm.mixture_logit_cdf_and_ldj(x, pi, mu, ls)[0])
    xi = tnm.mixture_inverse_logit_cdf(*_t(y, pi, mu, ls))
    _close(xi, jnm.mixture_inverse_logit_cdf(y, pi, mu, ls), 1e-4)
    _close(xi, mixture_inverse_pallas(y, pi, mu, ls, interpret=True), 1e-4)
    _close(xi, x, 1e-3)


def test_inverse_newton_two_cycle():
    """(b) The parameters that made plain safeguarded Newton oscillate."""
    pi = np.tile(np.float32([0.6, 1.614, 0.921, 1.032, 0.278, -1.363, 2.304,
                             0.68]), (256, 1))
    mu = np.tile(np.float32([-1.708, 5.648, 0.566, -2.809, -0.082, 1.026,
                             -2.156, 0.744]), (256, 1))
    ls = np.tile(np.float32([-0.095, -1.146, -0.103, 0.93, -0.74, -0.958,
                             -0.81, -0.332]), (256, 1))
    y = np.full((256,), -1.2907967567443848, np.float32)
    xi = tnm.mixture_inverse_logit_cdf(*_t(y, pi, mu, ls))
    _close(xi, np.full(256, -2.456364393234253), 1e-4)
    _close(xi, mixture_inverse_pallas(y, pi, mu, ls, interpret=True), 1e-4)


def test_inverse_odd_sizes():
    """(b) K=3, M=91."""
    x, pi, mu, ls = _mix(3, (7, 13), 3)
    y = np.asarray(jnm.mixture_logit_cdf_and_ldj(x, pi, mu, ls)[0])
    xi = tnm.mixture_inverse_logit_cdf(*_t(y, pi, mu, ls))
    _close(xi, mixture_inverse_pallas(y, pi, mu, ls, interpret=True), 1e-4)
    _close(xi, x, 1e-3)


def test_inverse_far_tails():
    """The exact bracket keeps the inverse right far into the tails."""
    _, pi, mu, ls = _mix(4, (5,), 4)
    x = np.float32([-25.0, -10.0, 0.0, 10.0, 25.0])
    y, _ = tnm.mixture_logit_cdf_and_ldj(*_t(x, pi, mu, ls))
    xi = tnm.mixture_inverse_logit_cdf(y, *_t(pi, mu, ls))
    np.testing.assert_allclose(xi.numpy(), x, rtol=1e-4, atol=1e-3)


def test_dispatch_takes_plain_path_on_cpu():
    """A CPU tensor goes to the plain version and launches nothing."""
    from categoricalnf_tpu_torch.ops.cuda import mixture as cm
    before = dict(cm.LAUNCHES)
    x, pi, mu, ls = _t(*_mix(5, (4, 6), 8))
    y, ldj = dispatch.mixture_forward(x, pi, mu, ls)
    y2, ldj2 = tnm.mixture_logit_cdf_and_ldj(x, pi, mu, ls)
    assert torch.equal(y, y2) and torch.equal(ldj, ldj2)
    xi = dispatch.mixture_inverse(y, pi, mu, ls)
    assert torch.equal(xi, tnm.mixture_inverse_logit_cdf(y, pi, mu, ls))
    assert cm.LAUNCHES == before


def test_cuda_wrappers_refuse_cpu_tensors():
    """No fallback: the kernel wrappers raise on a CPU tensor."""
    from categoricalnf_tpu_torch.ops.cuda import mixture as cm
    x, pi, mu, ls = _t(*_mix(6, (4, 6), 8))
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        cm.mixture_forward_cuda(x, pi, mu, ls)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        cm.mixture_inverse_cuda(x, pi, mu, ls)
