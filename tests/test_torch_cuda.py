"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where torch sees no card.  Imports no JAX,
so on a machine without it the file runs on its own:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from categoricalnf_tpu_torch.networks import SetTransformer
from categoricalnf_tpu_torch.ops import numerics as nm
from categoricalnf_tpu_torch.ops.cuda import fused_transformer as ft
from categoricalnf_tpu_torch.ops.cuda import mixture as cm

# one intra-op thread: pytest-xdist runs six workers at once, and each at
# torch's default pool oversubscribes the cores on these small tensors
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cs = _chip_smoke()


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


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(
        1e-30))


def _strided(pi, ls):
    """pi and ls as the coupling slices them out of one [..., 2 + 3K]
    tensor."""
    k = pi.shape[-1]
    raw = torch.zeros(*pi.shape[:-1], 2 + 3 * k, device=pi.device)
    raw[..., 2:2 + k], raw[..., 2 + 2 * k:] = pi, ls
    return raw[..., 2:2 + k], raw[..., 2 + 2 * k:]


# The cases of the inverse (#1); the forward and its backward also run K on
# both group widths of #2 and #2' (8 and 16 components) with partly filled
# groups (1, 3, 9), and M with a partly filled last warp (1, 91) and at the
# flagship train step's 65,536
_INV_CASES = [((64, 16, 4), 8), ((7, 13), 3), ((5, 3), 16), ((1,), 1)]
_MIX_CASES = _INV_CASES + [
    (s, k) for s in ((1,), (7, 13), (1024, 16, 4)) for k in (1, 3, 8, 9, 16)
    if (s, k) not in _INV_CASES]


@pytest.mark.parametrize("shape,k", _MIX_CASES)
def test_mixture_kernels_match_plain(dev, shape, k):
    """Forward to 1e-4 of the plain version; at the inverse's cases the
    rtsafe inverse to 1e-4 of the 42 + 3 bisection/Newton version and back
    to x to 1e-3.  (Not at the others: at M = 65,536 some elements sit
    where y is so flat in x that one ulp of y moves x by more than 1e-4;
    test_mixture_inverse_residual holds the inverse there.)"""
    x, pi, mu, ls = _mix(shape, k, dev)
    n_fwd, n_inv = cm.LAUNCHES["mixture_forward"], cm.LAUNCHES[
        "mixture_inverse"]
    y, ldj = cm.mixture_forward_cuda(x, pi, mu, ls)
    y_p, ldj_p = nm.mixture_logit_cdf_and_ldj(x, pi, mu, ls)
    torch.cuda.synchronize()
    _close(y, y_p, 1e-4)
    _close(ldj, ldj_p, 1e-4)
    assert cm.LAUNCHES["mixture_forward"] == n_fwd + 1
    if (shape, k) not in _INV_CASES:
        return
    xi = cm.mixture_inverse_cuda(y_p, pi, mu, ls)
    torch.cuda.synchronize()
    _close(xi, nm.mixture_inverse_logit_cdf(y_p, pi, mu, ls), 1e-4)
    _close(xi, x, 1e-3)
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


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["flagship", "k3", "sample4", "k16",
                                  "tails", "wide", "far"])
def test_mixture_inverse_residual(dev, name, seed):
    """The inverse by its residual in y (chip_smoke.inverse_failures) at
    chip_smoke.inverse_cases: M = 65,536 with K = 8 (pi and ls strided
    slices, as the coupling passes them) and K = 3, a /sample of 4 sets
    (M = 256, strided), K = 16 at M = 91, the tails, y = +-60 and +-90
    with the log-scales at the clip (the linear domain near underflow, and
    the log domain past |y| = 64), and wide brackets (log-scales spread
    over the clip's range, y = +-30 and +-90), and far roots (|y| up to
    5e7, as GraphCNF's masked bond positions); the plain version cut short
    (12 bisections, no Newton step) is refused at each."""
    y, pi, mu, ls = cs.inverse_cases(seed, dev)[name]
    n = cm.LAUNCHES["mixture_inverse"]
    x = cm.mixture_inverse_cuda(y, pi, mu, ls)
    torch.cuda.synchronize()
    assert cm.LAUNCHES["mixture_inverse"] == n + 1
    x_p = nm.mixture_inverse_logit_cdf(y, pi, mu, ls)
    assert cs.inverse_failures(x, x_p, y, pi, mu, ls, name) == []
    cut = nm.mixture_inverse_logit_cdf(y, pi, mu, ls, num_bisect=12,
                                       num_newton=0)
    assert cs.inverse_failures(cut, x_p, y, pi, mu, ls, name)


def test_mixture_forward_and_backward_at_wide_brackets(dev):
    """#2 and #2' at the roots of the wide case (x up to 1e5 from narrow
    components: |z| near 1e7), against their plain versions within 1e-4:
    z is rounded before the log-sigmoids, as the plain version rounds it,
    so log(1 - F) does not take z's rounding error."""
    y, pi, mu, ls = cs.inverse_cases(0, dev)["wide"]
    x = nm.mixture_inverse_logit_cdf(y, pi, mu, ls)
    got = cm.mixture_forward_cuda(x, pi, mu, ls)
    want = nm.mixture_logit_cdf_and_ldj(x, pi, mu, ls)
    for a, w in zip(got, want):
        _close(a, w, 1e-4)
    gy, gl = torch.randn_like(x), torch.randn_like(x)
    _, vjp = torch.func.vjp(nm.mixture_logit_cdf_and_ldj, x, pi, mu, ls)
    for a, w in zip(cm.mixture_forward_bwd_cuda(x, pi, mu, ls, gy, gl),
                    vjp((gy, gl))):
        _close(a, w, 1e-4)


def test_mixture_inverse_residual_on_strided_slices(dev):
    """The residual rule at K = 3, M = 65,536 with pi and ls sliced as the
    coupling slices them (_strided), and the same x as from contiguous
    copies."""
    y, pi, mu, ls = cs.inverse_cases(0, dev)["k3"]
    pi_s, ls_s = _strided(pi, ls)
    x = cm.mixture_inverse_cuda(y, pi_s, mu, ls_s)
    assert torch.equal(x, cm.mixture_inverse_cuda(y, pi, mu, ls))
    x_p = nm.mixture_inverse_logit_cdf(y, pi, mu, ls)
    assert cs.inverse_failures(x, x_p, y, pi, mu, ls, "k3 strided") == []


def test_mixture_inverse_two_cycle(dev):
    t = lambda v: torch.tensor(v, device=dev).expand(256, 8)
    pi = t([0.6, 1.614, 0.921, 1.032, 0.278, -1.363, 2.304, 0.68])
    mu = t([-1.708, 5.648, 0.566, -2.809, -0.082, 1.026, -2.156, 0.744])
    ls = t([-0.095, -1.146, -0.103, 0.93, -0.74, -0.958, -0.81, -0.332])
    y = torch.full((256,), -1.2907967567443848, device=dev)
    xi = cm.mixture_inverse_cuda(y, pi, mu, ls)
    _close(xi, torch.full_like(xi, -2.456364393234253), 1e-4)


def test_mixture_wrappers_reject_bad_input(dev):
    x, pi, mu, ls = _mix((4, 4), 33, dev)
    with pytest.raises(ValueError, match="K=33"):
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
    """fp32 (the 3xTF32 kernel) to 1e-4 of the unfused path and within
    F32_FWD_REL of its norm; bf16 (the tensor-core kernel) within the
    reference's loose bound (< 2% of elements off by more than
    5%) and within 1% of the output's norm (BF16_FWD_REL).  Covers a ragged
    last tile (3 x 16 rows), sets that do not divide the tile (S=6), two
    sets a tile (S=32), S=1 and widths 24 and 48."""
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
        assert _rel(y, y_p) <= F32_FWD_REL
    else:
        err = (y.float() - y_p.float()).abs()
        bad = (err > 0.05 * y_p.float().abs().clamp_min(1.0)).float().mean()
        assert float(bad) < 0.02
        assert _rel(y, y_p) <= BF16_FWD_REL


# Relative norm error allowed between the fp32 forward (3xTF32 on the
# tensor cores) and plain_forward in fp32: fp32's accuracy.  A single TF32
# pass reads about 3e-4.
F32_FWD_REL = 1e-5


def test_fused_f32_fwd_is_deterministic_at_the_flagship_shape(dev):
    """Two calls at eval_bpd's 65,536 rows (1024 sets x 4 chains) are
    bitwise equal and within F32_FWD_REL of the plain path."""
    net = _net("float32", dev)
    x = torch.randn(4096, 16, 4, generator=torch.Generator(dev)
                    .manual_seed(4), device=dev)
    with torch.no_grad():
        packed = ft.PackedWeights(ft.flatten_params(net), torch.float32)
        one = ft.fused_set_transformer(packed, x, num_heads=4)
        two = ft.fused_set_transformer(packed, x, num_heads=4)
        y_p = net.plain_forward(x)
    torch.cuda.synchronize()
    assert torch.equal(one, two)
    assert _rel(one, y_p) <= F32_FWD_REL


@pytest.mark.parametrize("b,s", [(64, 16), (3, 16), (5, 6)])
def test_fused_f32_differentiable_call_takes_the_fma_forward(dev, b, s):
    """With grad, an fp32 net's forward is the FMA kernel whose arithmetic
    the fp32 backward recomputes (to 1e-4 of the unfused path); without
    grad it is the 3xTF32 kernel."""
    net = _net("float32", dev)
    x = torch.randn(b, s, 4, generator=torch.Generator(dev).manual_seed(6),
                    device=dev)
    n, n_train = ft.LAUNCHES["float32"], ft.TRAIN_FWD_LAUNCHES["float32"]
    y = net(x.clone().requires_grad_(True))
    with torch.no_grad():
        y_nograd = net(x)
        y_p = net.plain_forward(x)
    torch.cuda.synchronize()
    assert ft.TRAIN_FWD_LAUNCHES["float32"] == n_train + 1
    assert ft.LAUNCHES["float32"] == n + 1
    _close(y.detach(), y_p, 1e-4)
    _close(y_nograd, y_p, 1e-4)
    assert _rel(y_nograd, y_p) <= F32_FWD_REL


@pytest.mark.parametrize("b,s,hidden,heads,ratio", [
    (5, 16, 256, 4, 8),   # 32 rows do not fit: 16-row tiles
    (3, 11, 256, 4, 8),   # 22 rows fit
    (2, 32, 362, 2, 1)])  # rows at their true width
def test_fused_f32_fwd_takes_the_fallback_layouts(dev, b, s, hidden, heads,
                                                  ratio):
    """Nets too wide for the flagship's layout take 16-row tiles, then
    rows at their true width (bank conflicts, same arithmetic), and stay
    within F32_FWD_REL of the plain path."""
    net = SetTransformer(4, 104, hidden_dim=hidden, num_heads=heads,
                         mlp_ratio=ratio, compute_dtype="float32",
                         generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        net.out.w.copy_(torch.randn(net.out.w.shape, generator=torch
                                    .Generator().manual_seed(1)) * 0.1)
    net = net.to(dev)
    x = torch.randn(b, s, 4, generator=torch.Generator(dev).manual_seed(5),
                    device=dev)
    with torch.no_grad():
        packed = ft.PackedWeights(ft.flatten_params(net), torch.float32)
        y = ft.fused_set_transformer(packed, x, num_heads=heads)
        y_p = net.plain_forward(x)
    torch.cuda.synchronize()
    _close(y, y_p, 1e-4)
    assert _rel(y, y_p) <= F32_FWD_REL


# Relative norm error allowed between the bf16 forward and plain_forward:
# the kernel and the plain path round the same values to bf16 after sums
# taken in another order, so a few roundings flip by one bf16 step.  It
# read 0.00116 at 16,384 rows of the flagship net on an H100 (chip_smoke).
BF16_FWD_REL = 0.01


def test_fused_bf16_fwd_is_deterministic_at_the_flagship_shape(dev):
    """Two calls at a sampling chunk's 16,384 rows are bitwise equal."""
    net = _net("bfloat16", dev)
    x = torch.randn(1024, 16, 4, generator=torch.Generator(dev)
                    .manual_seed(4), device=dev)
    with torch.no_grad():
        packed = ft.PackedWeights(ft.flatten_params(net), torch.bfloat16)
        one = ft.fused_set_transformer(packed, x, num_heads=4)
        two = ft.fused_set_transformer(packed, x, num_heads=4)
        y_p = net.plain_forward(x)
    torch.cuda.synchronize()
    assert torch.equal(one, two)
    assert _rel(one, y_p) <= BF16_FWD_REL


@pytest.mark.parametrize("b,s", [(5, 16), (7, 6)])
def test_fused_bf16_fwd_takes_half_tiles_for_a_wide_net(dev, b, s):
    """Hidden 256 with an MLP ratio of 8 does not fit a 64-row tile: the
    kernel takes 32 rows (whole sets, a ragged last tile) and stays within
    the bf16 bounds of the plain path."""
    assert ft.fwd_shape(torch.bfloat16, s, 4, 256, 2048)[0] in (30, 32)
    net = SetTransformer(4, 104, hidden_dim=256, num_heads=4, mlp_ratio=8,
                         compute_dtype="bfloat16",
                         generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        net.out.w.copy_(torch.randn(net.out.w.shape, generator=torch
                                    .Generator().manual_seed(1)) * 0.1)
    net = net.to(dev)
    x = torch.randn(b, s, 4, generator=torch.Generator(dev).manual_seed(5),
                    device=dev)
    with torch.no_grad():
        packed = ft.PackedWeights(ft.flatten_params(net), torch.bfloat16)
        y = ft.fused_set_transformer(packed, x, num_heads=4)
        y_p = net.plain_forward(x)
    torch.cuda.synchronize()
    err = (y.float() - y_p.float()).abs()
    bad = (err > 0.05 * y_p.float().abs().clamp_min(1.0)).float().mean()
    assert float(bad) < 0.02
    assert _rel(y, y_p) <= BF16_FWD_REL


def test_fused_bf16_fwd_raises_on_what_it_does_not_take(dev):
    """A width above 256 in bf16 raises on the card, as a set above 32
    does, rather than run the plain path there."""
    net = _net("bfloat16", dev, hidden=264)
    x = torch.randn(2, 16, 4, device=dev)
    n = ft.LAUNCHES["bfloat16"]
    with torch.no_grad(), pytest.raises(ValueError, match="unsupported"):
        net(x)
    assert ft.LAUNCHES["bfloat16"] == n


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
        # a key mask launches the kernel too; one of ones is no mask
        assert torch.equal(net(x, mask=torch.ones(4, 16, device=dev)), y2)
        with pytest.raises(NotImplementedError, match="condition"):
            net(x, cond=torch.ones(4, 16, 1, device=dev))
    assert ft.LAUNCHES["float32"] == n + 3


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


# -- backward kernels (#4 and the mixture forward's backward) -------------

def _net_grads(net, x, wy, plain):
    """d sum(y * wy) / d (x, every parameter), through the kernels or
    through autograd of plain_forward."""
    x = x.clone().requires_grad_(True)
    y = net.plain_forward(x) if plain else net(x)
    params = list(net.parameters())
    return torch.autograd.grad((y.float() * wy).sum(), [x] + params)


@pytest.mark.parametrize("b,s,hidden,heads", [(64, 16, 96, 4), (3, 16, 96, 4),
                                              (5, 6, 24, 4)])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_fused_bwd_matches_autograd_of_plain(dev, b, s, hidden, heads, cd):
    """#4 against autograd through plain_forward: fp32 to 2e-4 (the
    tolerance of the reference's own gradient test), bf16 to 3% of each
    tensor's norm.  (3, 16) has a ragged last tile; S=6 pads the tile."""
    net = _net(cd, dev, hidden, heads)
    g = torch.Generator(dev).manual_seed(3)
    x = torch.randn(b, s, 4, generator=g, device=dev)
    wy = torch.randn(b, s, 104, generator=g, device=dev)
    n = ft.BWD_LAUNCHES[cd]
    got = _net_grads(net, x, wy, plain=False)
    want = _net_grads(net, x, wy, plain=True)
    torch.cuda.synchronize()
    assert ft.BWD_LAUNCHES[cd] == n + 1
    for a, w in zip(got, want):
        assert a.shape == w.shape and a.dtype == w.dtype
        if cd == "float32":
            _close(a, w, 2e-4)
        else:
            assert _rel(a, w) <= 0.03
    assert all(float(a.abs().max()) > 0 for a in got)


@pytest.mark.parametrize("cd", ["bfloat16", "float32"])
def test_fused_bwd_is_deterministic(dev, cd):
    net = _net(cd, dev)
    x = torch.randn(256, 16, 4, device=dev)
    gy = torch.randn(256, 16, 104, device=dev).to(getattr(torch, cd))
    packed = net._packed_weights(getattr(torch, cd))
    one = ft.fused_set_transformer_bwd(packed, x, gy, num_heads=4)
    two = ft.fused_set_transformer_bwd(packed, x, gy, num_heads=4)
    torch.cuda.synchronize()
    assert torch.equal(one[0], two[0])
    assert all(torch.equal(a, b) for a, b in zip(one[1], two[1]))


def _tf32x3_bwd():
    """``tools/f32_bwd_tf32x3.py``: the 3xTF32 fp32 backward that waits
    beside the port on the fp32 train step's gradient check."""
    spec = importlib.util.spec_from_file_location(
        "f32_bwd_tf32x3", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "tools", "f32_bwd_tf32x3.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _stacked(net, grads):
    """Per-parameter gradients (``net.parameters()`` order) as the 12-tuple
    of ``flatten_params``."""
    g = dict(zip((n for n, _ in net.named_parameters()), grads))

    def stack(key, part):
        return torch.stack([g[f"blocks.{i}.{key}.{part}"]
                            for i in range(len(net.blocks))])
    return (g["embed.w"], g["embed.b"][None], stack("qkv", "w"),
            stack("qkv", "b"), stack("proj", "w"), stack("proj", "b"),
            stack("fc1", "w"), stack("fc1", "b"), stack("fc2", "w"),
            stack("fc2", "b"), g["out.w"], g["out.b"][None])


@pytest.mark.parametrize("b,s,hidden,heads,ratio", [
    (64, 16, 96, 4, 2), (4, 32, 96, 4, 2), (7, 16, 96, 4, 2),
    (11, 6, 24, 4, 2), (3, 32, 48, 2, 2), (9, 1, 24, 3, 2),
    (300, 16, 96, 4, 2),  # 4,800 rows: blocks walk several tiles
    (5, 16, 160, 4, 4),   # a wide net
    (2, 32, 128, 4, 1)])  # one set of 32 a tile, rows at their true width
def test_tf32x3_bwd_matches_autograd_of_plain(dev, b, s, hidden, heads,
                                              ratio):
    """The 3xTF32 fp32 backward against autograd through plain_forward at
    2e-4, the reference's own gradient tolerance, at the edges of its
    16-row tiles: S=32 (one set a tile), S=6 (12-row tiles, the last
    holding one set), S=1, widths 24 and 48, a wide net, and rows at their
    true width where conflict-free rows do not fit."""
    net = SetTransformer(4, 104, hidden_dim=hidden, num_heads=heads,
                         mlp_ratio=ratio, compute_dtype="float32",
                         generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        net.out.w.copy_(torch.randn(net.out.w.shape, generator=torch
                                    .Generator().manual_seed(1)) * 0.1)
    net = net.to(dev)
    g = torch.Generator(dev).manual_seed(7)
    x = torch.randn(b, s, 4, generator=g, device=dev)
    wy = torch.randn(b, s, 104, generator=g, device=dev)
    dx, dws = _tf32x3_bwd().fused_set_transformer_bwd(
        net._packed_weights(torch.float32), x, wy, num_heads=heads)
    want = _net_grads(net, x, wy, plain=True)
    torch.cuda.synchronize()
    for a, w in zip((dx,) + dws, (want[0],) + _stacked(net, want[1:])):
        assert a.shape == w.shape and a.dtype == w.dtype
        _close(a, w, 2e-4)
        assert float(a.abs().max()) > 0


@pytest.mark.parametrize("sets", [256, 1024])
def test_tf32x3_bwd_is_deterministic(dev, sets):
    """Two calls are bitwise equal, also at 16,384 rows, where each block
    walks several tiles."""
    tool = _tf32x3_bwd()
    net = _net("float32", dev)
    x = torch.randn(sets, 16, 4, device=dev)
    gy = torch.randn(sets, 16, 104, device=dev)
    packed = net._packed_weights(torch.float32)
    one = tool.fused_set_transformer_bwd(packed, x, gy, num_heads=4)
    two = tool.fused_set_transformer_bwd(packed, x, gy, num_heads=4)
    torch.cuda.synchronize()
    assert torch.equal(one[0], two[0])
    assert all(torch.equal(a, b) for a, b in zip(one[1], two[1]))


@pytest.mark.parametrize("b,s,hidden,heads", [(4, 32, 96, 4), (7, 16, 96, 4),
                                              (11, 6, 24, 4), (3, 32, 48, 2)])
def test_fused_bwd_bf16_tile_edges(dev, b, s, hidden, heads):
    """The bf16 tensor-core backward at the edges of its 64-row tiles, to
    3% of each tensor's norm of autograd through plain_forward: S=32 (two
    sets a tile), 112 and 96 rows (a ragged last tile), and 66 rows of S=6
    (60-row tiles padded to 64, the last holding one set)."""
    net = _net("bfloat16", dev, hidden, heads)
    g = torch.Generator(dev).manual_seed(5)
    x = torch.randn(b, s, 4, generator=g, device=dev)
    wy = torch.randn(b, s, 104, generator=g, device=dev)
    n = ft.BWD_LAUNCHES["bfloat16"]
    got = _net_grads(net, x, wy, plain=False)
    want = _net_grads(net, x, wy, plain=True)
    torch.cuda.synchronize()
    assert ft.BWD_LAUNCHES["bfloat16"] == n + 1
    for a, w in zip(got, want):
        assert a.shape == w.shape and a.dtype == w.dtype
        assert _rel(a, w) <= 0.03
    assert all(float(a.abs().max()) > 0 for a in got)


def test_fused_bwd_bf16_is_deterministic_at_the_training_shape(dev):
    """Two calls at a flagship train step's 16,384 rows are bitwise equal."""
    net = _net("bfloat16", dev)
    g = torch.Generator(dev).manual_seed(6)
    x = torch.randn(1024, 16, 4, generator=g, device=dev)
    gy = torch.randn(1024, 16, 104, generator=g, device=dev).bfloat16()
    packed = net._packed_weights(torch.bfloat16)
    one = ft.fused_set_transformer_bwd(packed, x, gy, num_heads=4)
    two = ft.fused_set_transformer_bwd(packed, x, gy, num_heads=4)
    torch.cuda.synchronize()
    assert torch.equal(one[0], two[0])
    assert all(torch.equal(a, b) for a, b in zip(one[1], two[1]))
    assert all(float(a.abs().max()) > 0 for a in one[1])


def _mix_grads(x, pi, mu, ls, gy, gl, kernel):
    ins = [t.detach().clone().requires_grad_(True) for t in (x, pi, mu, ls)]
    fn = cm.mixture_forward_cuda if kernel else nm.mixture_logit_cdf_and_ldj
    y, ldj = fn(*ins)
    return torch.autograd.grad((y * gy).sum() + (ldj * gl).sum(), ins)


@pytest.mark.parametrize("strided", [False, True], ids=["dense", "strided"])
@pytest.mark.parametrize("shape,k", [((64, 16, 4), 8), ((7, 13), 3),
                                     ((5, 3), 16)] + _MIX_CASES[3:])
def test_mixture_bwd_matches_autograd_of_numerics(dev, shape, k, strided):
    """The backward kernel against autograd of the numerics to 1e-4, with
    log-scales on both sides of the clip (their gradient is 0 there).
    Strided: the logits and log-scales slices of one [..., 2 + 3K] tensor,
    passed to the backward's wrapper as they are."""
    x, pi, mu, ls = _mix(shape, k, dev, seed=5)
    ls = ls * 6.0  # many outside [-5, 7]
    g = torch.Generator(dev).manual_seed(6)
    gy = torch.randn(shape, generator=g, device=dev)
    gl = torch.randn(shape, generator=g, device=dev)
    n = cm.LAUNCHES["mixture_forward_bwd"]
    if strided:
        pi, ls = _strided(pi, ls)
        got = cm.mixture_forward_bwd_cuda(x, pi, mu, ls, gy, gl)
    else:
        got = _mix_grads(x, pi, mu, ls, gy, gl, kernel=True)
    want = _mix_grads(x, pi, mu, ls, gy, gl, kernel=False)
    torch.cuda.synchronize()
    assert cm.LAUNCHES["mixture_forward_bwd"] == n + 1
    for a, w in zip(got, want):
        _close(a, w, 1e-4)
    clipped = (ls < nm.LOG_SCALE_MIN) | (ls > nm.LOG_SCALE_MAX)
    assert clipped.any() or x.numel() == 1
    assert bool((got[3][clipped] == 0).all())


@pytest.mark.parametrize("b", [32, 1024])
def test_mixture_bwd_takes_strided_slices_and_is_deterministic(dev, b):
    """The backward on strided slices to 1e-4 of autograd; two calls of it,
    and of the forward, give the same bits (b = 1024: the flagship train
    step's shape)."""
    K = 8
    g = torch.Generator(dev).manual_seed(7)
    raw = torch.randn(b, 16, 4, 2 + 3 * K, generator=g, device=dev)
    x = torch.randn(b, 16, 4, generator=g, device=dev)
    gy, gl = torch.randn(2, b, 16, 4, generator=g, device=dev)
    pi, mu, ls = raw[..., 2:2 + K], raw[..., 2 + K:2 + 2 * K], raw[..., 2 + 2 * K:]
    one, two = ((*cm.mixture_forward_cuda(x, pi, mu, ls),
                 *cm.mixture_forward_bwd_cuda(x, pi, mu, ls, gy, gl))
                for _ in range(2))
    torch.cuda.synchronize()
    assert all(torch.equal(u.view(torch.int32), v.view(torch.int32))
               for u, v in zip(one, two))
    want = _mix_grads(x, pi, mu, ls, gy, gl, kernel=False)
    for a, w in zip(one[2:], want):
        _close(a, w, 1e-4)


@pytest.mark.parametrize("case", ["vardeq", "k8", "k16", "k32",
                                  "k8_wide", "k16_wide", "k32_wide"])
def test_wrappers_without_backward_raise_on_grad(dev, case):
    """The inverse has a backward, #1', the reference's rule: with grad on,
    one launch of the loop-rule kernel and no other, its gradients within
    chip_smoke's elementwise rule of its plain version
    (``numerics.mixture_inverse_loop_vjp``) on at least INV_LOOP_SHARE of
    the elements, at the vardeq encoder's shape (K = 4) and at every other
    width the kernel is built for (K = 8, 16, 32 on ``_mix``'s inputs, 16
    and 4,096 elements), and under no_grad the same root.  The plain
    forward wrapper of #3 keeps no graph: with grad on it raises rather
    than drop it."""
    if case == "vardeq":
        y, pi, mu, ls = cs.encoder_inverse_cases(0, dev)["vardeq"]
    else:
        k = int(case[1:].split("_")[0])
        x, pi, mu, ls = _mix((64, 64) if case.endswith("wide") else (4, 4),
                             k, dev)
        y, _ = nm.mixture_logit_cdf_and_ldj(x, pi, mu, ls)
    args = [t.clone().requires_grad_(True) for t in (y, pi, mu, ls)]
    before = dict(cm.LAUNCHES)
    root = cm.mixture_inverse_cuda(*args)
    gx = torch.randn_like(root)
    got = torch.autograd.grad(root, args, gx)
    assert cm.LAUNCHES["mixture_inverse_loop_bwd"] == \
        before["mixture_inverse_loop_bwd"] + 1
    assert cm.LAUNCHES["mixture_inverse_bwd"] == before["mixture_inverse_bwd"]
    want = nm.mixture_inverse_loop_vjp(y, pi, mu, ls, gx)
    for a, w in zip(got, want):
        assert cs.near_share(a, w) >= cs.INV_LOOP_SHARE
    with torch.no_grad():
        assert torch.equal(cm.mixture_inverse_cuda(y, pi, mu, ls),
                           root.detach())
    net = _net("float32", dev)
    xr = torch.randn(2, 16, 4, device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="autograd graph"):
        ft.fused_set_transformer(net._packed_weights(torch.float32), xr,
                                 num_heads=4)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_train_step_on_card_gives_every_parameter_a_gradient(dev, cd):
    """After one training step on the card (kernels #3/#4 and the mixture
    forward with its backward), every parameter that has a gradient on the
    CPU (plain path) has a non-zero one; in fp32 each within 1e-3 of the
    CPU's (relative to the tensor's norm).  The optimizer then moves every
    one of them."""
    from categoricalnf_tpu_torch.inference import build_task
    from categoricalnf_tpu_torch.training.state import (OptimizerConfig,
                                                        TrainState)
    args = dict(set_size=8, num_layers=2, hidden_dim=32, num_mixtures=4,
                encoding_dim=4, compute_dtype=cd)
    cpu = build_task("set_shuffling", args, device="cpu")
    x = np.argsort(np.random.default_rng(0).random((32, 8)), axis=1)
    cpu.data_init({"x": x}, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        g = torch.Generator().manual_seed(1)
        for name, p in cpu.model.named_parameters():
            if name.endswith("net.out.w"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    gpu = build_task("set_shuffling", args, device=dev)
    gpu.model.load_state_dict(cpu.model.state_dict())
    noise = nm.uniform_noise((32, 8, 4), generator=torch.Generator()
                             .manual_seed(2))
    cpu.loss({"x": x}, 0.8, noise=noise).backward()
    state = TrainState.create(gpu.model, OptimizerConfig())
    n = (ft.BWD_LAUNCHES[cd], cm.LAUNCHES["mixture_forward_bwd"])
    gpu.loss({"x": x}, 0.8, noise=noise.to(dev)).backward()
    torch.cuda.synchronize()
    assert ft.BWD_LAUNCHES[cd] == n[0] + 2
    assert cm.LAUNCHES["mixture_forward_bwd"] == n[1] + 2
    before = {k: p.detach().clone() for k, p in gpu.model.named_parameters()}
    gp = dict(gpu.model.named_parameters())
    checked = 0
    for name, p in cpu.model.named_parameters():
        if p.grad is None or not p.grad.abs().max() > 0:
            continue
        g_card = gp[name].grad
        assert g_card is not None and float(g_card.abs().max()) > 0, name
        if cd == "float32":
            assert _rel(g_card.cpu(), p.grad) <= 1e-3, name
        checked += 1
    assert checked > 20 * 2
    state.apply_gradients()
    for name, p in cpu.model.named_parameters():
        if p.grad is not None and p.grad.abs().max() > 0:
            assert not torch.equal(gp[name].detach(), before[name]), name


# -- the graph-coloring path ----------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["chunk", "sample4"])
def test_mixture_inverse_residual_at_coloring_shapes(dev, name, seed):
    """#1 by its residual in y at the coloring path's sampling chunk
    (M = 10,240) and /sample of 4 graphs (M = 160), pi and ls strided as
    the coupling passes them (chip_smoke.coloring_inverse_cases)."""
    y, pi, mu, ls = cs.coloring_inverse_cases(seed, dev)[name]
    x = cm.mixture_inverse_cuda(y, pi, mu, ls)
    x_p = nm.mixture_inverse_logit_cdf(y, pi, mu, ls)
    assert cs.inverse_failures(x, x_p, y, pi, mu, ls, name) == []


def test_mixture_kernels_at_the_coloring_train_shape(dev):
    """#2 and #2' at a coloring train step's M = 256 x 20 x 2 = 10,240
    against their plain versions, within 1e-4."""
    x, pi, mu, ls = _mix(cs.COLORING_SHAPE, 8, dev, seed=3)
    y, ldj = cm.mixture_forward_cuda(x, pi, mu, ls)
    y_p, ldj_p = nm.mixture_logit_cdf_and_ldj(x, pi, mu, ls)
    _close(y, y_p, 1e-4)
    _close(ldj, ldj_p, 1e-4)
    g = torch.Generator(dev).manual_seed(4)
    cs.mixture_bwd_case(dev, g, cs.COLORING_SHAPE, 8)


def _coloring_pair(dev, cd):
    from categoricalnf_tpu_torch.inference import build_task
    args = dict(min_nodes=4, max_nodes=8, batch_size=16, encoding_dim=2,
                num_layers=4, hidden_dim=32, num_mixtures=8,
                compute_dtype=cd)
    cpu = build_task("graph_coloring", args, device="cpu")
    batch = cpu._gen(np.random.default_rng(0), 16)
    cpu.data_init(batch, generator=torch.Generator().manual_seed(0))
    cs.randomize_coupling_nets(cpu.model, 1)
    gpu = build_task("graph_coloring", args, device=dev)
    gpu.model.load_state_dict(cpu.model.state_dict())
    return cpu, gpu, batch


def test_tiny_coloring_task_on_card_matches_cpu(dev):
    """The fp32 coloring slice (a scanned stack of RGCN couplings; the
    mixture kernels) against the CPU (plain path): IS bits/var within
    1e-4 and a sample within 1e-3, the padded nodes' outputs finite."""
    cpu, gpu, batch = _coloring_pair(dev, "float32")
    noise = nm.uniform_noise((4, 16, 8, 2),
                             generator=torch.Generator().manual_seed(5))
    n = cm.LAUNCHES["mixture_forward"]
    bpd_cpu = cpu.eval_step(batch, 4, noise=noise)
    bpd_gpu = gpu.eval_step(batch, 4, noise=noise.to(dev)).cpu()
    _close(bpd_gpu, bpd_cpu, 1e-4)
    assert cm.LAUNCHES["mixture_forward"] == n + 4
    u = nm.uniform_noise((16, 8, 2), generator=torch.Generator()
                         .manual_seed(6))
    with torch.no_grad():
        z = [t.model.flow.sample((16, 8, 2), cond=t._tensor(batch["cond"]),
                                 mask=t._tensor(batch["mask"]),
                                 noise=u.to(t.device)).cpu()
             for t in (gpu, cpu)]
    assert torch.isfinite(z[0]).all()
    _close(z[0], z[1], 1e-3)


def test_coloring_remat_gradients_on_card(dev):
    """A bf16 coloring train step on the card through the kernels: with
    remat (the blocks recomputed in the backward pass, which replays the
    mixture forward kernel) the loss equals the one without and every
    gradient is within 1e-5 of it (the embedding lookup's backward sums
    with atomics, in no fixed order), and every parameter gets a finite
    gradient."""
    grads = []
    for remat in (False, True):
        _, gpu, batch = _coloring_pair(dev, "bfloat16")
        (scan,) = gpu.model.flow.layers
        scan.remat = remat
        noise = nm.uniform_noise((16, 8, 2), generator=torch.Generator()
                                 .manual_seed(7))
        n = cm.LAUNCHES["mixture_forward"]
        loss = gpu.loss(batch, 0.8, noise=noise.to(dev))
        loss.backward()
        torch.cuda.synchronize()
        assert cm.LAUNCHES["mixture_forward"] == n + (8 if remat else 4)
        grads.append((loss.detach(), {k: p.grad for k, p in
                                      gpu.model.named_parameters()}))
    (l0, g0), (l1, g1) = grads
    assert torch.equal(l0, l1)
    for k, g in g0.items():
        assert g is not None and bool(torch.isfinite(g).all()), k
        _close(g1[k], g, 1e-5)


def test_scanned_set_stack_remat_on_card(dev):
    """A 4-layer scanned set task in bf16 on the card: with remat the
    backward pass recomputes each block, which replays the fused
    SetTransformer forward (#3) and the mixture forward (#2); the loss
    equals the one without and every gradient is within 1e-5 of it (the
    embedding lookup's backward sums with atomics)."""
    from categoricalnf_tpu_torch.inference import build_task
    args = dict(set_size=8, num_layers=4, hidden_dim=32, num_mixtures=4,
                encoding_dim=4, compute_dtype="bfloat16", scan_blocks=True)
    x = np.argsort(np.random.default_rng(0).random((32, 8)), axis=1)
    noise = nm.uniform_noise((32, 8, 4), generator=torch.Generator()
                             .manual_seed(1))
    grads = []
    for remat in (False, True):
        task = build_task("set_shuffling", {**args, "remat": remat},
                          device=dev)
        cs.randomize_coupling_nets(task.model, 2)
        n = ft.LAUNCHES["bfloat16"]
        loss = task.loss({"x": x}, 0.8, noise=noise.to(dev))
        loss.backward()
        torch.cuda.synchronize()
        assert ft.LAUNCHES["bfloat16"] == n + (8 if remat else 4)
        grads.append((loss.detach(), {k: p.grad for k, p in
                                      task.model.named_parameters()}))
    (l0, g0), (l1, g1) = grads
    assert torch.equal(l0, l1)
    for k, g in g0.items():
        assert g is not None and bool(torch.isfinite(g).all()), k
        _close(g1[k], g, 1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_mixture_inverse_bwd_against_the_exact_derivative(dev, seed):
    """#1' at the encoders' shapes (M = 16,384 and 65,536, K = 4, the
    parameters as strided slices of one leaf) by chip_smoke's rule
    (``inverse_bwd_readings``): the loop-rule kernel, the reference's
    gradient, within the elementwise rule of autograd through the plain
    loop on the card, and so is its plain version; the exact derivative
    (the implicit rule) is now the control, which fails that rule on some
    gradient; and #1 passes the residual rule there."""
    for name, (y, pi, mu, ls) in cs.encoder_inverse_cases(seed,
                                                          dev).items():
        g = torch.Generator(dev).manual_seed(seed + 40)
        gx = torch.randn(y.shape, generator=g, device=dev)
        cs.inverse_bwd_readings(y, pi, mu, ls, gx, f"{name}, seed {seed}")
        x = cm.mixture_inverse_cuda(y, pi, mu, ls)
        x_p = nm.mixture_inverse_logit_cdf(y, pi, mu, ls)
        assert not cs.inverse_failures(x, x_p, y, pi, mu, ls, name)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["set129", "mask"])
def test_refused_calls_raise_on_the_card(dev, cd, case):
    """A set of 129, and a key mask of another shape than the sets', which
    the kernels do not take, raise on the card rather than run the plain
    path there, with or without grad.  No kernel launches.  A key mask of
    the sets' shape in a differentiable fp32 call runs the fp32 train
    step's pair with the mask."""
    net = _net(cd, dev)
    set_size = 129 if case == "set129" else 16
    x = torch.randn(4, set_size, 4, device=dev, requires_grad=True)
    mask = None
    if case == "mask":
        mask = (torch.arange(set_size - 1, device=dev)[None]
                < torch.tensor([[15], [9], [3], [12]], device=dev)).float()
    before = (dict(ft.LAUNCHES), dict(ft.BWD_LAUNCHES),
              dict(ft.TRAIN_FWD_LAUNCHES))
    for grad in (False, True):
        with torch.set_grad_enabled(grad), pytest.raises(ValueError):
            net(x, mask=mask)
    assert (dict(ft.LAUNCHES), dict(ft.BWD_LAUNCHES),
            dict(ft.TRAIN_FWD_LAUNCHES)) == before
    if case == "mask" and cd == "float32":
        n = (ft.MASKED_TRAIN_FWD_LAUNCHES["float32"],
             ft.MASKED_BWD_LAUNCHES["float32"])
        y = net(x, mask=torch.ones(4, set_size, device=dev))
        y.sum().backward()
        assert (ft.MASKED_TRAIN_FWD_LAUNCHES["float32"],
                ft.MASKED_BWD_LAUNCHES["float32"]) == (n[0] + 1, n[1] + 1)
        assert torch.isfinite(x.grad).all()


def test_fused_bf16_at_the_vardeq_main_flow_shape(dev):
    """#3 and #4 in bf16 at the vardeq main flow's coupling net (in 1, out
    26, 16,384 rows), held by chip_smoke's rules: the forward within
    BF16_FWD_REL of plain_forward, the backward within 0.03 of each
    gradient of autograd through it."""
    g = torch.Generator(dev).manual_seed(3)
    x = torch.randn(1024, 16, 1, generator=g, device=dev)
    net = cs.flagship_net("bfloat16", dev, 1, cs.VARDEQ_OUT)
    assert cs.fused_fwd_report(net, x)["rel_err"] <= cs.BF16_FWD_REL
    gy = torch.randn(1024, 16, cs.VARDEQ_OUT, generator=g,
                     device=dev).to(torch.bfloat16)
    assert cs.fused_bwd_report(net, x, gy, "in 1, out 26")["rel_err"] \
        <= 0.03


def test_vardeq_train_step_against_fp64(dev):
    """One fp32 train step of runs/sum_vardeq at full width on the card,
    #1' (the loop rule) in the encoder, held by chip_smoke's rules against
    the same step on the CPU through the loop (the tensors outside the
    encoder per tensor against float64, the encoder's elementwise against
    the CPU fp32 step); the control, the CPU step with the implicit rule,
    fails the elementwise rule on some encoder tensor."""
    launches = cs.check_vardeq_step_against_cpu(0, {})
    assert launches["mixture_inverse_loop_bwd"] > 0
    assert launches["mixture_inverse_bwd"] == 0


# -- the language models: K up to 32, the LSTM flow on the card -----------

@pytest.mark.parametrize("k", [17, 24, 32])
@pytest.mark.parametrize("shape", [(128, 256, 4), (128, 4), (4, 4), (7, 13)])
def test_mixture_kernels_at_wide_k_match_plain(dev, shape, k):
    """#2 and #2' on the wide groups (16 < K <= 32), the logits and
    log-scales strided as the autoregressive layer passes them, against
    their plain versions within 1e-4; #1 back to x within 1e-3 where y is
    steep enough (M <= 512)."""
    x, pi, mu, ls = _mix(shape, k, dev, seed=k)
    pi, ls = _strided(pi, ls * 6.0)
    y, ldj = cm.mixture_forward_cuda(x, pi, mu, ls)
    y_p, ldj_p = nm.mixture_logit_cdf_and_ldj(x, pi, mu, ls)
    _close(y, y_p, 1e-4)
    _close(ldj, ldj_p, 1e-4)
    g = torch.Generator(dev).manual_seed(k + 1)
    gy, gl = (torch.randn(shape, generator=g, device=dev) for _ in range(2))
    got = cm.mixture_forward_bwd_cuda(x, pi, mu, ls, gy, gl)
    _, vjp = torch.func.vjp(nm.mixture_logit_cdf_and_ldj, x, pi, mu, ls)
    for a, w in zip(got, vjp((gy, gl))):
        _close(a, w, 1e-4)
    if x.numel() <= 512:
        xi = cm.mixture_inverse_cuda(y_p, pi, mu, ls)
        assert cs.inverse_failures(xi, nm.mixture_inverse_logit_cdf(
            y_p, pi, mu, ls), y_p, pi, mu, ls, f"K={k}") == []


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["density", "m512", "m16", "peaked",
                                  "tails"])
def test_mixture_inverse_residual_at_lm_shapes(dev, name, seed):
    """#1 at K = 32 by its residual in y on chip_smoke.lm_inverse_cases;
    the plain version cut short is refused."""
    y, pi, mu, ls = cs.lm_inverse_cases(seed, dev)[name]
    x = cm.mixture_inverse_cuda(y, pi, mu, ls)
    x_p = nm.mixture_inverse_logit_cdf(y, pi, mu, ls)
    assert cs.inverse_failures(x, x_p, y, pi, mu, ls, name) == []
    cut = nm.mixture_inverse_logit_cdf(y, pi, mu, ls, num_bisect=12,
                                       num_newton=0)
    assert cs.inverse_failures(cut, x_p, y, pi, mu, ls, name)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_tiny_lm_task_on_card_matches_cpu(dev, cd):
    """A tiny LM (K = 32, the HMM prior, random heads): the IS bits/char
    (fp32 twin) and a sample with shared noise on the card against the
    CPU; a bf16 train step on the card gives every parameter, the prior's
    too, a finite gradient and launches #2 and #2'."""
    from categoricalnf_tpu_torch.inference import build_task
    args = dict(corpus="synthetic", seq_len=12, batch_size=8,
                encoding_dim=4, num_layers=2, hidden_dim=16, lstm_layers=2,
                num_mixtures=32, prior="hmm", prior_states=4,
                compute_dtype=cd)
    cpu = build_task("lm_synthetic_markov", args, device="cpu")
    cs.randomize_coupling_nets(cpu.model, 3, 0.1)
    gpu = build_task("lm_synthetic_markov", args, device=dev)
    gpu.model.load_state_dict(cpu.model.state_dict())
    x = next(cpu.train_batches(np.random.default_rng(0)))["x"]
    noise = nm.uniform_noise((4, 8, 12, 4),
                             generator=torch.Generator().manual_seed(0))
    bpd_cpu = cpu.eval_step({"x": x}, 4, noise=noise)
    bpd_gpu = gpu.eval_step({"x": x}, 4, noise=noise.to(dev)).cpu()
    _close(bpd_gpu, bpd_cpu, 1e-4)
    u = nm.uniform_noise((8, 12, 5), generator=torch.Generator()
                         .manual_seed(1))
    with torch.no_grad():
        _close(gpu.eval_model.flow.sample((8, 12, 4), noise=u.to(dev)).cpu(),
               cpu.eval_model.flow.sample((8, 12, 4), noise=u), 1e-3)
    n_fwd, n_bwd = (cm.LAUNCHES[k] for k in ("mixture_forward",
                                             "mixture_forward_bwd"))
    loss = gpu.loss({"x": x}, 0.7, generator=torch.Generator(dev)
                    .manual_seed(2))
    loss.backward()
    assert cm.LAUNCHES["mixture_forward"] == n_fwd + 4
    assert cm.LAUNCHES["mixture_forward_bwd"] == n_bwd + 4
    for name, p in gpu.model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
    assert gpu.model.flow.prior.trans_logits.grad.abs().sum() > 0


# -- the key mask (GraphCNF's node flow) -----------------------------------


def _key_mask(b, s, dev, seed=0):
    """[b, s] masks of random sizes, set 0 with one valid key, set 1 with
    none."""
    r = np.random.default_rng(seed)
    m = (np.arange(s)[None] < r.integers(1, s + 1, (b, 1))).astype(
        np.float32)
    m[0] = 0.0
    m[0, 0] = 1.0
    m[1] = 0.0
    return torch.as_tensor(m, device=dev)


@pytest.mark.parametrize("s", [6, 24, 32])
@pytest.mark.parametrize("kernel", ["fwd_bf16", "bwd_bf16", "fwd_f32"])
def test_masked_kernels_match_plain(dev, kernel, s):
    """#3 bf16, #4 bf16 and #3 fp32 with a key mask (a set of one valid key
    and one of none among them) against plain_forward with it, by
    chip_smoke's rules: BF16_FWD_REL, 0.03 of each gradient's norm,
    F32_FWD_REL and 1e-4; each launch counted as masked; a mask of ones
    bitwise the call without a mask."""
    cd = "float32" if kernel == "fwd_f32" else "bfloat16"
    net = _net(cd, dev, hidden=48, in_dim=6, out_dim=6 * 26)
    g = torch.Generator(dev).manual_seed(s)
    x = torch.randn(40, s, 6, generator=g, device=dev)
    mask = _key_mask(40, s, dev, s)
    if kernel == "bwd_bf16":
        gy = torch.randn(40, s, 6 * 26, generator=g, device=dev).to(
            torch.bfloat16)
        n = ft.MASKED_BWD_LAUNCHES["bfloat16"]
        r = cs.masked_bwd_readings(net, x, mask, gy)
        assert ft.MASKED_BWD_LAUNCHES["bfloat16"] > n
        assert r["rel_err"] <= cs.BF16_BWD_REL
        return
    tol = cs.F32_FWD_REL if cd == "float32" else cs.BF16_FWD_REL
    n = ft.MASKED_LAUNCHES[cd]
    r = cs.masked_fwd_readings(net, x, mask, tol)
    assert ft.MASKED_LAUNCHES[cd] > n and r["rel_err"] <= tol
    if cd == "float32":
        with torch.no_grad():
            _close(net(x, mask=mask), net.plain_forward(x, mask=mask), 1e-4)


@pytest.mark.parametrize("hidden,b", [(96, 64), (128, 128), (48, 40)])
def test_masked_f32_pair_matches_plain(dev, hidden, b):
    """The fp32 train step's pair with the key mask at the node flow's
    widths (in 6, out 156, sets of 24; a set of one valid key and one of
    none) by chip_smoke's rules (``masked_f32_pair_readings``): #3 within
    1e-4 and each gradient of #4 within 2e-4 of plain_forward and autograd
    through it, the pair without the mask above 10 x those, a mask of ones
    bitwise no mask, the masked launches counted."""
    net = cs.molecule_net("float32", dev, 2, hidden, 6 * 26)
    g = torch.Generator(dev).manual_seed(hidden + b)
    x = torch.randn(b, 24, 6, generator=g, device=dev)
    gy = torch.randn(b, 24, 6 * 26, generator=g, device=dev)
    r = cs.masked_f32_pair_readings(net, x, _key_mask(b, 24, dev, hidden),
                                    gy)
    assert r["fwd_err"] <= cs.F32_TRAIN_FWD_TOL
    assert r["bwd_err"] <= cs.F32_BWD_TOL


@pytest.mark.parametrize("s", [5, 16])
def test_masked_f32_pair_with_a_ragged_head_width(dev, s):
    """The pair's scalar attention path (a head width of 3, not a multiple
    of 4) and a set size that leaves padded rows in a tile, with the key
    mask, by the same rules."""
    net = _net("float32", dev, hidden=12, heads=4, in_dim=3, out_dim=7)
    g = torch.Generator(dev).manual_seed(s)
    x = torch.randn(9, s, 3, generator=g, device=dev)
    gy = torch.randn(9, s, 7, generator=g, device=dev)
    r = cs.masked_f32_pair_readings(net, x, _key_mask(9, s, dev, s), gy)
    assert r["fwd_err"] <= cs.F32_TRAIN_FWD_TOL
    assert r["bwd_err"] <= cs.F32_BWD_TOL


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_all_masked_set_attends_uniformly(dev, cd):
    """A set with no valid key: every query attends uniformly over the
    set, as the reference's -1e9 logits give, so the set's output is the
    plain version's; the other sets are untouched by it."""
    net = _net(cd, dev, hidden=48, in_dim=6, out_dim=12)
    x = torch.randn(3, 24, 6, generator=torch.Generator(dev).manual_seed(4),
                    device=dev)
    mask = torch.ones(3, 24, device=dev)
    mask[1] = 0.0
    with torch.no_grad():
        y = net(x, mask=mask)
        y_p = net.plain_forward(x, mask=mask)
        y_u = net(x)
    assert torch.isfinite(y.float()).all()
    if cd == "float32":
        _close(y, y_p, 1e-4)
    else:
        assert _rel(y, y_p) <= cs.BF16_FWD_REL
    assert torch.equal(y[[0, 2]], y_u[[0, 2]])


def test_hidden_256_bf16_training_matches_plain(dev):
    """Masked #4 bf16 at runs/moses's node-flow shape (hidden 256, out 300,
    192 graphs of 24 nodes), whose residual copies live in the global
    workspace, against autograd through plain_forward by chip_smoke's
    rules (``masked_bwd_readings``: 0.03 of each gradient's norm, the
    control without the mask above 10 x that, a mask of ones bitwise no
    mask); the launch counted as masked."""
    in_global = ft.bwd_layout(torch.bfloat16, 24, 6, 256, 512, 300, 4, 2)[2]
    assert in_global
    net = cs.molecule_net("bfloat16", dev, 0, 256, 300)
    g = torch.Generator(dev).manual_seed(7)
    x = torch.randn(cs.MOSES_BATCH, 24, 6, generator=g, device=dev)
    gy = torch.randn(cs.MOSES_BATCH, 24, 300, generator=g, device=dev).to(
        torch.bfloat16)
    mask = cs.molecule_key_mask(0, dev, cs.MOSES_BATCH)
    n = ft.MASKED_BWD_LAUNCHES["bfloat16"]
    n_wgrad = ft.GLOBAL_H_WGRAD_LAUNCHES["bfloat16"]
    r = cs.masked_bwd_readings(net, x, mask, gy)
    assert ft.MASKED_BWD_LAUNCHES["bfloat16"] > n
    assert ft.GLOBAL_H_WGRAD_LAUNCHES["bfloat16"] > n_wgrad
    assert r["rel_err"] <= cs.BF16_BWD_REL


@pytest.mark.parametrize("batch,grid", [(192, None), (40, 7)])
def test_wgrad_tiles_matches_plain(dev, batch, grid):
    """wgrad_tiles_bf16 on random operand images at runs/moses' node flow
    (192 graphs: 192 tiles of 24 rows padded to 32, at the backward's grid;
    and 40 graphs at a grid of 7, slices of 5 and 6 tiles) against
    ``wgrad_tiles_plain`` on the same images (``chip_smoke.wgrad_readings``:
    the matrices within one bf16 rounding, the biases within 1e-5 of the
    largest)."""
    r = cs.wgrad_readings(dev, 0, batch, grid)
    assert r["matrices_within"] and r["biases_within"]


@pytest.mark.parametrize("hidden,b", [(96, 40), (192, 128)])
def test_global_h_layout_is_bitwise_the_shared_one(dev, hidden, b):
    """Where both layouts fit, the global workspace of residual copies
    gives dx and every weight gradient bitwise equal to the shared layout's
    (same tile and grid): only where the bytes live differs."""
    net = cs.molecule_net("bfloat16", dev, 1, hidden, 6 * 26)
    g = torch.Generator(dev).manual_seed(hidden)
    x = torch.randn(b, 24, 6, generator=g, device=dev)
    gy = torch.randn(b, 24, 6 * 26, generator=g, device=dev).to(
        torch.bfloat16)
    mask = _key_mask(b, 24, dev, hidden)
    packed = net._packed_weights(torch.bfloat16)
    shared = ft.bwd_layout(torch.bfloat16, 24, 6, hidden, 2 * hidden, 6 * 26,
                           4, 2)
    forced = ft.bwd_layout(torch.bfloat16, 24, 6, hidden, 2 * hidden, 6 * 26,
                           4, 2, global_h=True)
    assert not shared[2] and forced[2] and forced[0] == shared[0]
    with torch.no_grad():
        a = ft.fused_set_transformer_bwd(packed, x, gy, num_heads=4,
                                         mask=mask)
        c = ft.fused_set_transformer_bwd(packed, x, gy, num_heads=4,
                                         mask=mask, _global_h=True)
    for u, v in zip((a[0], *a[1]), (c[0], *c[1])):
        assert torch.equal(u, v)


@pytest.mark.parametrize("hidden,b,k", [(192, 128, 8), (256, 192, 16)])
def test_masked_f32_pair_with_a_global_workspace_matches_plain(dev, hidden,
                                                               b, k):
    """The fp32 train step's pair at the node flow's wide nets (hidden 192,
    K = 8, 128 graphs: #4's residual copies and MLP pair in its global
    workspace; hidden 256, K = 16, 192 graphs: qkv too) by chip_smoke's
    rules (``masked_f32_pair_readings``), the global layout's launch
    counted."""
    out = 6 * (2 + 3 * k)
    regions = ft.bwd_layout(torch.float32, 24, 6, hidden, 2 * hidden, out,
                            4, 2)[2]
    assert regions == ft.FMA_WS_REGIONS[:2 if hidden == 192 else 3]
    net = cs.molecule_net("float32", dev, 3, hidden, out)
    g = torch.Generator(dev).manual_seed(hidden + b)
    x = torch.randn(b, 24, 6, generator=g, device=dev)
    gy = torch.randn(b, 24, out, generator=g, device=dev)
    n = ft.GLOBAL_H_BWD_LAUNCHES["float32"]
    r = cs.masked_f32_pair_readings(net, x, _key_mask(b, 24, dev, hidden),
                                    gy)
    assert ft.GLOBAL_H_BWD_LAUNCHES["float32"] > n
    assert r["fwd_err"] <= cs.F32_TRAIN_FWD_TOL
    assert r["bwd_err"] <= cs.F32_BWD_TOL


def test_fma_workspace_layout_is_bitwise_the_shared_one(dev):
    """#4 fp32 with every region in the global workspace (forced) gives dx
    and the 12 weight gradients bitwise the shared layout's at hidden 96
    and 128, at the same tile and grid (``chip_smoke.fma_workspace_bitwise``
    fails otherwise)."""
    out = cs.fma_workspace_bitwise(dev, 1)
    assert set(out) == {"h96", "h128"}
    assert all(v["bitwise"] for v in out.values())


# -- sets of 33 to 128: clusters, #4 on warp tiles ------------------------

@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("s", [33, 48, 64, 99, 100, 128])
def test_big_sets_match_plain(dev, s, seed):
    """#3 bf16, #4 bf16 and #3 fp32 at sets of ``s`` (whole-set tiles, and
    for #4 bf16 above 64 and #3 fp32 above 100 two blocks of a cluster,
    rank 1 holding one row fewer at 99) against plain by chip_smoke's
    limits (``fused_fwd_report``, ``fused_bwd_report``), at two seeds; at
    the ragged sets of 33 and 100 also #4 bf16 with a key mask, its
    control without the mask above 10 x (``masked_bwd_readings``)."""
    g = torch.Generator(dev).manual_seed(s + 1000 * seed)
    sets = 4096 // s
    x = torch.randn(sets, s, cs.D, generator=g, device=dev)
    gy = torch.randn(sets, s, cs.OUT, generator=g,
                     device=dev).to(torch.bfloat16)
    assert cs.fused_fwd_report(cs.flagship_net("bfloat16", dev),
                               x)["rel_err"] <= cs.BF16_FWD_REL
    assert cs.fused_bwd_report(cs.flagship_net("bfloat16", dev), x, gy,
                               f"sets of {s}")["rel_err"] <= 0.03
    assert cs.fused_fwd_report(cs.flagship_net("float32", dev),
                               x)["rel_err"] <= cs.F32_FWD_REL
    if s in (33, 100):
        r = cs.masked_bwd_readings(cs.flagship_net("bfloat16", dev), x,
                                   cs.set_mask(sets, s, seed, dev), gy)
        assert r["rel_err"] <= 0.03 < r["control_rel_err"] / 10


@pytest.mark.parametrize("cd", ["bfloat16", "float32"])
@pytest.mark.parametrize("hidden,heads", [(96, 8), (80, 4), (36, 4)])
@pytest.mark.parametrize("s", [33, 100])
def test_big_set_backward_at_head_widths_off_8(dev, cd, hidden, heads, s):
    """#4's attention at sets above 32 pads a head width to its tiles
    (bf16: k16 steps and a k8 tail of mma.sync, zero past the width;
    fp32: float4 rows where the width is a multiple of 4, else single
    values): widths of 12, 20 and 9 at the ragged sets of 33 and 100 (with
    a key mask at 100) against autograd of plain, bf16 within 0.03 of each
    gradient's norm, fp32 within 2e-4 as torch.allclose."""
    net = SetTransformer(cs.D, cs.OUT, hidden_dim=hidden, num_heads=heads,
                         compute_dtype=cd,
                         generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        net.out.w.copy_(torch.randn(net.out.w.shape, generator=torch
                                    .Generator().manual_seed(4)) * 0.1)
    net = net.to(dev)
    g = torch.Generator(dev).manual_seed(hidden + s)
    x = torch.randn(64, s, cs.D, generator=g, device=dev)
    gy = torch.randn(64, s, cs.OUT, generator=g, device=dev)
    mask = cs.set_mask(64, s, 7, dev) if s == 100 else None
    params = list(net.parameters())

    def grads(plain):
        xr = x.clone().requires_grad_(True)
        y = net.plain_forward(xr, mask=mask) if plain else net(xr, mask=mask)
        return torch.autograd.grad(y, [xr] + params, gy.to(y.dtype))

    def launches():
        return ft.BWD_LAUNCHES[cd] + ft.CLUSTER_BWD_LAUNCHES.get(cd, 0)

    n = launches()
    got, want = grads(False), grads(True)
    assert launches() > n
    if cd == "bfloat16":
        assert max(cs.rel_err(a, w) for a, w in zip(got, want)) <= 0.03
    else:
        assert max(cs.allclose_err(a, w) for a, w in zip(got, want)) <= 2e-4


def test_big_sets_masked_and_cluster_forward(dev):
    """The key mask at sets of 64 in #3 bf16, #4 bf16 and #3 fp32
    (``check_big_set_kernels``, which also runs every size of BIG_SETS at
    one seed and #3 bf16 over a cluster at hidden 192)."""
    cs.check_big_set_kernels(dev, (0,), {})


@pytest.mark.parametrize("cd", ["bfloat16", "float32"])
@pytest.mark.parametrize("s", [33, 64, 65, 128])
def test_big_forward_on_warp_tiles_matches_plain(dev, cd, s):
    """#3's BIG instances, whose attention runs on warp tiles: bf16, and
    fp32 with grad (the train step's forward, over a cluster of 2 or 4),
    at sets of ``s`` (one block, or over a cluster with the other block's
    K and V staged) against ``plain_forward``, bf16 within BF16_FWD_REL of
    its norm, fp32 within 1e-4 as torch.allclose; four calls bitwise equal
    and launched; at 64 with a key mask, its control without the mask
    above 10 x (``masked_fwd_readings``, ``masked_f32_pair_readings``)."""
    g = torch.Generator(dev).manual_seed(s + 17)
    sets = 4096 // s
    x = torch.randn(sets, s, cs.D, generator=g, device=dev)
    net = cs.flagship_net(cd, dev)
    bf16 = cd == "bfloat16"
    packed = net._packed_weights(getattr(torch, cd))
    ws = ft.flatten_params(net)
    counts = ft.LAUNCHES if bf16 else ft.CLUSTER_TRAIN_FWD_LAUNCHES

    def run():
        if bf16:
            return ft.fused_set_transformer(packed, x, num_heads=cs.HEADS)
        return ft.FusedSetTransformer.apply(x, packed, cs.HEADS, None, *ws)

    n = counts[cd]
    with torch.no_grad():
        ys = [run() for _ in range(4)]
        y_p = net.plain_forward(x)
    torch.cuda.synchronize()
    assert counts[cd] == n + 4
    assert all(torch.equal(y, ys[0]) for y in ys[1:])
    if bf16:
        assert cs.rel_err(ys[0], y_p) <= cs.BF16_FWD_REL
    else:
        assert cs.allclose_err(ys[0], y_p) <= 1e-4
    if s == 64:
        mask = cs.set_mask(sets, s, 5, dev)
        if bf16:
            cs.masked_fwd_readings(net, x, mask, cs.BF16_FWD_REL)
        else:
            gy = torch.randn(sets, s, cs.OUT, generator=g, device=dev)
            cs.masked_f32_pair_readings(net, x, mask, gy)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("s", [33, 48, 64, 100, 128])
def test_twin_big_forward_on_warp_tiles_matches_plain(dev, s, masked):
    """#3 fp32 without grad (the 3xTF32 eval twin) at sets of ``s``, its
    attention on warp tiles in 3xTF32 over a cluster of 2 blocks up to 64
    rows and of 4 above: against ``plain_forward`` within 1e-4 as
    torch.allclose and within F32_FWD_REL of its norm (masked: with the key
    mask, the call without it above 10 x, a mask of ones bitwise none,
    ``masked_fwd_readings``); four calls bitwise equal, each launched."""
    g = torch.Generator(dev).manual_seed(s + 29)
    sets = 4096 // s
    x = torch.randn(sets, s, cs.D, generator=g, device=dev)
    net = cs.flagship_net("float32", dev)
    packed = net._packed_weights(torch.float32)
    mask = cs.set_mask(sets, s, 11, dev) if masked else None
    cluster = ft.fwd_shape(torch.float32, s, cs.D, cs.H, 2 * cs.H,
                           cs.HEADS)[2]
    assert cluster == (2 if s <= 64 else 4)
    n = ft.LAUNCHES["float32"]
    with torch.no_grad():
        ys = [ft.fused_set_transformer(packed, x, num_heads=cs.HEADS,
                                       mask=mask) for _ in range(4)]
        y_p = net.plain_forward(x, mask=mask)
    torch.cuda.synchronize()
    assert ft.LAUNCHES["float32"] == n + 4
    assert all(torch.equal(y, ys[0]) for y in ys[1:])
    assert cs.allclose_err(ys[0], y_p) <= 1e-4
    assert cs.rel_err(ys[0], y_p) <= cs.F32_FWD_REL
    if masked:
        cs.masked_fwd_readings(net, x, mask, cs.F32_FWD_REL)


# bytes the 3xTF32 forward's BIG instance spills (stores and loads), as
# ptxas reports them for sm_90a and PERF.md records them
TWIN_BIG_SPILL_BYTES = 140


def test_twin_instances_registers_and_spills(dev):
    """ptxas on the 3xTF32 forward: its BIG instance within the registers
    its launch bounds give F32_BIG_BLOCKS blocks an SM, spilling no more
    than PERF.md records (TWIN_BIG_SPILL_BYTES); the instance for sets up
    to 32 at 80 registers (three blocks an SM), without spills, as
    before."""
    from categoricalnf_tpu_torch.ops.cuda import build
    name = "fused_transformer_tf32x3"
    res = cs.kernel_resources(build.build_all([name])[name])
    big = [v for k, v in res.items() if "fwd_tf32x3ILb1" in k]
    small = [v for k, v in res.items() if "fwd_tf32x3ILb0" in k]
    assert len(big) == len(small) == 1, res
    assert big[0]["registers"] <= 65536 // (256 * ft.F32_BIG_BLOCKS)
    assert big[0]["spill_bytes"] <= TWIN_BIG_SPILL_BYTES, big
    assert small[0] == {"registers": 80, "spill_bytes": 0}, small


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("s,masked", [(33, False), (64, False),
                                      (100, False), (128, False),
                                      (64, True), (33, True), (100, True)])
def test_fp32_training_above_32_matches_autograd_of_plain(dev, s, masked,
                                                          seed):
    """A differentiable fp32 call at a set above 32 runs the fp32 train
    step's pair over a cluster of 2 blocks
    (up to 64 rows) or 4: #3 within 1e-4 and #4 within 2e-4 of autograd of
    plain as torch.allclose (``f32_pair_readings``; masked at 33, 64 and
    100 with the control without the mask above 10 x,
    ``masked_f32_pair_readings``), both kernels launched over clusters, at
    two seeds."""
    g = torch.Generator(dev).manual_seed(s + 1000 * seed)
    sets = 2048 // s
    x = torch.randn(sets, s, 4, generator=g, device=dev)
    gy = torch.randn(sets, s, 104, generator=g, device=dev)
    net = _net("float32", dev)
    n = (ft.CLUSTER_TRAIN_FWD_LAUNCHES["float32"],
         ft.CLUSTER_BWD_LAUNCHES["float32"])
    if masked:
        r = cs.masked_f32_pair_readings(net, x,
                                        cs.set_mask(sets, s, 3 + seed, dev),
                                        gy)
    else:
        r = cs.f32_pair_readings(net, x, gy)
        assert r["cluster"] == (2 if s <= 64 else 4)
    assert r["fwd_err"] <= 1e-4 and r["bwd_err"] <= 2e-4
    assert ft.CLUSTER_TRAIN_FWD_LAUNCHES["float32"] > n[0]
    assert ft.CLUSTER_BWD_LAUNCHES["float32"] > n[1]


def test_fp32_training_at_129_raises_before_launch(dev):
    """A differentiable fp32 call at a set of 129 raises ValueError naming
    B16 and launches nothing, as the same call without grad raises."""
    net = _net("float32", dev)
    x = torch.randn(2, 129, 4, device=dev, requires_grad=True)
    counts = (ft.LAUNCHES, ft.BWD_LAUNCHES, ft.TRAIN_FWD_LAUNCHES,
              ft.CLUSTER_TRAIN_FWD_LAUNCHES, ft.CLUSTER_BWD_LAUNCHES)
    before = [dict(c) for c in counts]
    with pytest.raises(ValueError, match="B16"):
        net(x)
    with torch.no_grad(), pytest.raises(ValueError, match="B16"):
        net(x)
    assert [dict(c) for c in counts] == before
