"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where torch sees no card.  Imports no JAX,
so on a machine without it the file runs on its own:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from categoricalnf_tpu_torch.networks import SetTransformer
from categoricalnf_tpu_torch.ops import numerics as nm
from categoricalnf_tpu_torch.ops.cuda import fused_transformer as ft
from categoricalnf_tpu_torch.ops.cuda import mixture as cm

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from categoricalnf_tpu_torch.utils.device import resolve_device
    return resolve_device("cuda")


def _mix(shape, k, dev, seed=0):
    g = torch.Generator(dev).manual_seed(seed)
    n = lambda *s: torch.randn(*s, generator=g, device=dev)
    return n(*shape) * 2.0, n(*shape, k), n(*shape, k) * 2.0, \
        n(*shape, k) * 0.5 - 0.5


def _close(a, b, tol):
    torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("shape,k", [((64, 16, 4), 8), ((7, 13), 3),
                                     ((5, 3), 16), ((1,), 1)])
def test_mixture_kernels_match_plain(dev, shape, k):
    """Forward to 1e-4 of the plain version; the rtsafe inverse to 1e-4 of
    the 42 + 3 bisection/Newton version and back to x to 1e-3."""
    x, pi, mu, ls = _mix(shape, k, dev)
    n_fwd, n_inv = cm.LAUNCHES["mixture_forward"], cm.LAUNCHES[
        "mixture_inverse"]
    y, ldj = cm.mixture_forward_cuda(x, pi, mu, ls)
    y_p, ldj_p = nm.mixture_logit_cdf_and_ldj(x, pi, mu, ls)
    torch.cuda.synchronize()
    _close(y, y_p, 1e-4)
    _close(ldj, ldj_p, 1e-4)
    xi = cm.mixture_inverse_cuda(y_p, pi, mu, ls)
    torch.cuda.synchronize()
    _close(xi, nm.mixture_inverse_logit_cdf(y_p, pi, mu, ls), 1e-4)
    _close(xi, x, 1e-3)
    assert cm.LAUNCHES["mixture_forward"] == n_fwd + 1
    assert cm.LAUNCHES["mixture_inverse"] == n_inv + 1


def test_mixture_kernels_take_strided_slices(dev):
    """Parameters as the coupling slices them out of the net's output."""
    K = 8
    g = torch.Generator(dev).manual_seed(1)
    raw = torch.randn(32, 16, 4, 2 + 3 * K, generator=g, device=dev)
    x = torch.randn(32, 16, 4, generator=g, device=dev)
    pi, mu, ls = raw[..., 2:2 + K], raw[..., 2 + K:2 + 2 * K], raw[..., 2 + 2 * K:]
    y, ldj = cm.mixture_forward_cuda(x, pi, mu, ls)
    y_p, ldj_p = nm.mixture_logit_cdf_and_ldj(x, pi, mu, ls)
    _close(y, y_p, 1e-4)
    _close(ldj, ldj_p, 1e-4)
    _close(cm.mixture_inverse_cuda(y_p, pi, mu, ls), x, 1e-3)


def test_mixture_inverse_two_cycle(dev):
    t = lambda v: torch.tensor(v, device=dev).expand(256, 8)
    pi = t([0.6, 1.614, 0.921, 1.032, 0.278, -1.363, 2.304, 0.68])
    mu = t([-1.708, 5.648, 0.566, -2.809, -0.082, 1.026, -2.156, 0.744])
    ls = t([-0.095, -1.146, -0.103, 0.93, -0.74, -0.958, -0.81, -0.332])
    y = torch.full((256,), -1.2907967567443848, device=dev)
    xi = cm.mixture_inverse_cuda(y, pi, mu, ls)
    _close(xi, torch.full_like(xi, -2.456364393234253), 1e-4)


def test_mixture_wrappers_reject_bad_input(dev):
    x, pi, mu, ls = _mix((4, 4), 17, dev)
    with pytest.raises(ValueError, match="K=17"):
        cm.mixture_forward_cuda(x, pi, mu, ls)
    x, pi, mu, ls = _mix((4, 4), 8, dev)
    with pytest.raises(TypeError):
        cm.mixture_inverse_cuda(x.double(), pi, mu, ls)
    with pytest.raises(ValueError, match="shape"):
        cm.mixture_inverse_cuda(x[:2], pi, mu, ls)


def _net(cd, dev, hidden=96, heads=4, in_dim=4, out_dim=104):
    net = SetTransformer(in_dim, out_dim, hidden_dim=hidden, num_heads=heads,
                         compute_dtype=cd,
                         generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        net.out.w.copy_(torch.randn(net.out.w.shape, generator=torch
                                    .Generator().manual_seed(1)) * 0.1)
    return net.to(dev)


@pytest.mark.parametrize("b,s,hidden,heads", [(64, 16, 96, 4), (3, 16, 96, 4),
                                              (5, 6, 24, 4), (2, 32, 48, 2),
                                              (9, 1, 24, 3)])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_fused_net_matches_unfused(dev, b, s, hidden, heads, cd):
    """fp32 to 1e-4 of the unfused path; bf16 within the reference's
    loose bound (< 2% of elements off by more than 5%).  Covers a ragged
    last tile (3 x 16 rows), sets that do not divide the tile (S=6), a
    one-set tile (S=32) and S=1."""
    net = _net(cd, dev, hidden, heads)
    x = torch.randn(b, s, 4, generator=torch.Generator(dev).manual_seed(2),
                    device=dev)
    n = ft.LAUNCHES[cd]
    with torch.no_grad():
        packed = ft.PackedWeights(ft.flatten_params(net), getattr(torch, cd))
        y = ft.fused_set_transformer(packed, x, num_heads=heads)
        y_p = net.plain_forward(x)
    torch.cuda.synchronize()
    assert ft.LAUNCHES[cd] == n + 1
    assert y.shape == y_p.shape and y.dtype == y_p.dtype
    if cd == "float32":
        _close(y, y_p, 1e-4)
    else:
        err = (y.float() - y_p.float()).abs()
        bad = (err > 0.05 * y_p.float().abs().clamp_min(1.0)).float().mean()
        assert float(bad) < 0.02


def test_cuda_calls_always_take_the_kernel(dev):
    """Every CUDA call of the net launches the kernel; what the kernel does
    not take raises instead of running the plain path on the card.  The
    cast weights are reused until a parameter changes."""
    net = _net("float32", dev)
    x = torch.randn(4, 16, 4, device=dev)
    n = ft.LAUNCHES["float32"]
    with torch.no_grad():
        y1 = net(x)
        packed = net._packed_weights(torch.float32)
        assert net._packed_weights(torch.float32) is packed
        net.out.b.add_(1.0)  # an in-place write, as loading does
        y2 = net(x)
        assert net._packed_weights(torch.float32) is not packed
        _close(y2, y1 + 1.0, 1e-5)
        with pytest.raises(NotImplementedError, match="mask"):
            net(x, mask=torch.ones(4, 16, device=dev))
    assert ft.LAUNCHES["float32"] == n + 2


def test_tiny_task_on_card_matches_cpu(dev):
    """The whole fp32 slice (kernels) against the CPU (plain path).  A
    saved config with ``"fused": false`` still runs the kernel on the card:
    the device alone picks it."""
    from categoricalnf_tpu_torch.inference import build_task
    args = dict(set_size=6, num_layers=2, hidden_dim=24, num_mixtures=3,
                encoding_dim=2, compute_dtype="float32", fused=False)
    cpu = build_task("set_shuffling", args, device="cpu")
    gpu = build_task("set_shuffling", args, device=dev)
    gpu.model.load_state_dict(cpu.model.state_dict())
    n = ft.LAUNCHES["float32"]
    x = np.argsort(np.random.default_rng(0).random((16, 6)), axis=1)
    noise = nm.uniform_noise((4, 16, 6, 2),
                             generator=torch.Generator().manual_seed(0))
    bpd_cpu = cpu.eval_step({"x": x}, 4, noise=noise)
    bpd_gpu = gpu.eval_step({"x": x}, 4, noise=noise.to(dev)).cpu()
    _close(bpd_gpu, bpd_cpu, 1e-4)
    u = nm.uniform_noise((16, 6, 2), generator=torch.Generator()
                         .manual_seed(1))
    with torch.no_grad():
        _close(gpu.model.flow.sample((16, 6, 2), noise=u.to(dev)).cpu(),
               cpu.model.flow.sample((16, 6, 2), noise=u), 1e-3)
    # 2 layers: a forward pass per IS chunk, an inverse for the sample
    assert ft.LAUNCHES["float32"] == n + 4
