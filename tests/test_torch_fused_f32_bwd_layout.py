"""The host-side arithmetic of the 3xTF32 fp32 fused SetTransformer
backward (kernel #4 in fp32, ``tools/f32_bwd_tf32x3.cu``, which waits
beside the port on the fp32 train step's gradient check), on the CPU: the
TF32 split of W that its input gradients read (``w_layouts``), the tile
and shared memory it picks (``bwd_shape``), and its 3xTF32 arithmetic
(split products in the input and the weight gradients), emulated in torch
for the whole net against autograd of the port's plain path and the JAX
package's gradient of its fused net.  Needs neither a card nor nvcc."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from categoricalnf_tpu.networks.transformer import \
    SetTransformer as JaxSetTransformer
from categoricalnf_tpu.ops.pallas import fused_transformer as jft
from categoricalnf_tpu_torch.convert import flatten_tree
from categoricalnf_tpu_torch.networks import SetTransformer
from categoricalnf_tpu_torch.ops.cuda import fused_transformer as ft

# one intra-op thread: pytest-xdist runs six workers at once, and each at
# torch's default pool oversubscribes the cores on these small tensors
torch.set_num_threads(1)


def _tool():
    spec = importlib.util.spec_from_file_location(
        "f32_bwd_tf32x3", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "tools", "f32_bwd_tf32x3.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


bwd = _tool()

F32 = torch.float32
# Relative norm error per tensor allowed between the emulated 3xTF32
# backward and fp32 arithmetic: the forward's F32_FWD_REL.  fp32 itself
# reads about 1e-7, a single TF32 pass about 3e-4.
F32_BWD_REL = 1e-5


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def _unsplit(layout):
    """(hi, lo) [..., rows, pad8(k)] of a ``tf32x3_layouts`` layout."""
    *lead, n8, k16 = layout.shape
    parts = layout.reshape(*lead, n8, k16 // 16, 4, 2, 2)
    return tuple(parts[..., i, :].transpose(-1, -2)
                 .reshape(*lead, n8, k16 // 2) for i in (0, 1))


def _ws(hidden=96, out=104, in_dim=4, layers=2, mlp=192, seed=0):
    r = np.random.default_rng(seed)
    shapes = [(in_dim, hidden), (1, hidden), (layers, hidden, 3 * hidden),
              (layers, 3 * hidden), (layers, hidden, hidden),
              (layers, hidden), (layers, hidden, mlp), (layers, mlp),
              (layers, mlp, hidden), (layers, hidden), (hidden, out),
              (1, out)]
    return [torch.tensor(r.standard_normal(s) * 2.0, dtype=F32)
            for s in shapes]


@pytest.mark.parametrize("hidden,out,mlp", [(96, 104, 192), (24, 44, 48),
                                            (36, 13, 72)])
def test_tf32_split_of_w_for_the_input_gradients(hidden, out, mlp):
    """The backward's 6 layouts of W [..., kd, n]: [..., pad8(kd),
    2 pad8(n)], hi with its low 13 mantissa bits zero, hi + lo = W to
    fp32's rounding (2^-22 of |W|), the pads zero; the remainder carries
    what hi drops."""
    ws = _ws(hidden, out, mlp=mlp)
    mats = [ws[j] for j in (0, 2, 4, 6, 8, 10)]
    for layout, j in zip(bwd.w_layouts(mats), (0, 2, 4, 6, 8, 10)):
        w = ws[j]
        *lead, kd, n = w.shape
        assert layout.shape == (*lead, ft.pad8(kd), 2 * ft.pad8(n))
        hi, lo = _unsplit(layout)
        bits = torch.cat([hi.flatten(), lo.flatten()]).view(torch.int32)
        assert bool(((bits & 0x1FFF) == 0).all())
        assert torch.equal(hi[..., :kd, :n], ft.rna_tf32(w))
        err = (hi[..., :kd, :n].double() + lo[..., :kd, :n].double()
               - w.double()).abs()
        assert bool((err <= 2.0 ** -22 * w.double().abs()).all())
        assert float(lo[..., :kd, :n].abs().max()) > 0
        for part in (hi, lo):
            assert not part[..., kd:, :].any() and not part[..., :, n:].any()


def test_input_gradient_through_the_split_layout():
    """g @ W^T through the layout's (hi, lo), with g zero past its width as
    the kernel's pads read against zero weights: the three products equal
    g @ W^T to fp32's accuracy, the pad columns are zero."""
    ws = _ws()
    (layout,) = bwd.w_layouts([ws[2]])
    w = ws[2][0]                            # qkv of block 0: [96, 288]
    hi, lo = (p[0] for p in _unsplit(layout))  # [96, 288] each
    g = torch.tensor(np.random.default_rng(3).standard_normal((40, 288)),
                     dtype=F32)
    g_hi = ft.rna_tf32(g)
    g_lo = ft.rna_tf32(g - g_hi)
    got = (g_lo.double() @ hi.double().T + g_hi.double() @ lo.double().T
           + g_hi.double() @ hi.double().T)
    want = g.double() @ w.double().T
    assert got.shape == (40, 96)
    assert _rel(got, want) < 1e-6


# in 4, hidden 96, MLP 192 (ratio 2), out 104, 4 heads, 2 blocks
FLAGSHIP = dict(in_dim=4, hidden=96, mlp=192, out_dim=104, heads=4,
                layers=2)


def test_bwd_shape_of_the_flagship():
    """16 rows (one set), no padded rows; rows 4 mod 8 floats wide: h at 3
    block boundaries and five [16, 100] buffers, qkv [16, 292], the MLP pair
    [16, 2 x 196], the softmax statistics [4, 16, 3] and 8 floats of slack:
    94 KB, two blocks an SM; 64 blocks at a flagship fp32 step's 1,024
    rows, 256 at 4,096, the card's 2 x 132 at 16,384."""
    tile, smem = bwd.bwd_shape(16, **FLAGSHIP)
    assert (tile, smem) == (16, 4 * (16 * (8 * 100 + 292 + 392 + 12) + 8)) \
        == (16, 95_776)
    assert ft.smem_blocks_per_sm(smem) == 2
    assert [ft.bwd_grid(rows, tile, smem, 132)
            for rows in (1024, 4096, 16_384)] == [64, 256, 264]


@pytest.mark.parametrize("s,tile", [(8, 16), (16, 16), (32, 32)])
def test_bwd_tiles_hold_whole_sets_and_fit(s, tile):
    """Whole sets up to 16 rows, one set where a set is larger."""
    got, smem = bwd.bwd_shape(s, **FLAGSHIP)
    assert got == tile and got % s == 0
    assert smem <= ft.MAX_SMEM
    assert smem == 4 * (tile * (8 * 100 + 292 + 392 + 12) + 8)


@pytest.mark.parametrize("s,hidden,ratio,tile", [
    (16, 160, 4, 16),    # a wide net fits 16 rows with conflict-free rows
    (32, 128, 1, 32),    # one set of 32 fits only at the true width
    (6, 24, 2, 12), (1, 24, 2, 16), (17, 96, 2, 17)])
def test_bwd_fallback_layouts(s, hidden, ratio, tile):
    net = dict(FLAGSHIP, hidden=hidden, mlp=ratio * hidden)
    got, smem = bwd.bwd_shape(s, **net)
    assert got == tile and smem <= ft.MAX_SMEM


# -- the 3xTF32 backward, emulated ----------------------------------------

def _mm(a, w, split):
    """a @ w as the kernel's products compute it: with ``split`` a_lo.w_hi
    + a_hi.w_lo + a_hi.w_hi (TF32 parts, exact products, fp32 sums), else
    a single TF32 pass a_hi.w_hi."""
    a_hi, w_hi = ft.rna_tf32(a), ft.rna_tf32(w)
    y = a_hi @ w_hi
    if split:
        a_lo, w_lo = ft.rna_tf32(a - a_hi), ft.rna_tf32(w - w_hi)
        y = (a_lo @ w_hi + a_hi @ w_lo) + y
    return y


class _Dense(torch.autograd.Function):
    """x @ w + b with the kernels' products in the forward (mma_dense), the
    input gradient g @ W^T (mma_dense on the split W) and the weight
    gradient X^T @ G (wgrad_tile); the bias gradient a plain fp32 sum."""

    @staticmethod
    def forward(ctx, x, w, b, split):
        ctx.save_for_backward(x, w)
        ctx.split = split
        return _mm(x, w, split) + b

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        x2, g2 = x.reshape(-1, x.shape[-1]), g.reshape(-1, g.shape[-1])
        gx = _mm(g, w.transpose(0, 1).contiguous(), ctx.split)
        gw = _mm(x2.transpose(0, 1).contiguous(), g2, ctx.split)
        return gx, gw, g2.sum(0), None


def _ln(h):
    mu = h.mean(-1, keepdim=True)
    var = ((h - mu) ** 2).mean(-1, keepdim=True)
    return (h - mu) * torch.rsqrt(var + 1e-5)


def _emulated_net(net, x, split=True):
    """The fp32 kernels' whole net with every dense product emulated in
    both directions; LN, attention and gelu in fp32 autograd."""
    def dense(a, layer):
        return _Dense.apply(a, layer.w, layer.b, split)

    B, S, _ = x.shape
    h = dense(x, net.embed)
    H = h.shape[-1]
    heads = net.num_heads
    hd = H // heads
    for blk in net.blocks:
        qkv = dense(_ln(h), blk.qkv).reshape(B, S, 3, heads, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        p = torch.softmax((q @ k.transpose(-1, -2)) / hd ** 0.5, dim=-1)
        h = h + dense((p @ v).transpose(1, 2).reshape(B, S, H), blk.proj)
        m = torch.nn.functional.gelu(dense(_ln(h), blk.fc1),
                                     approximate="tanh")
        h = h + dense(m, blk.fc2)
    return dense(_ln(h), net.out)


def _grads(net, x, wy, fn):
    xr = x.clone().requires_grad_(True)
    params = list(net.parameters())
    return torch.autograd.grad((fn(xr) * wy).sum(), [xr] + params)


@pytest.mark.parametrize("s", [16, 6])
def test_3xtf32_backward_has_fp32_accuracy(s):
    """dx and every parameter's gradient of the emulated 3xTF32 backward
    against autograd of plain_forward in fp32 (the flagship net, its output
    layer randomised), within F32_BWD_REL per tensor; the control, a single
    TF32 pass in both directions, reads above it."""
    net = SetTransformer(4, 104, hidden_dim=96, num_heads=4,
                         compute_dtype="float32",
                         generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        net.out.w.copy_(torch.randn(net.out.w.shape, generator=torch
                                    .Generator().manual_seed(1)) * 0.1)
    r = np.random.default_rng(2)
    x = torch.tensor(r.standard_normal((6, s, 4)), dtype=F32)
    wy = torch.tensor(r.standard_normal((6, s, 104)), dtype=F32)
    want = _grads(net, x, wy, net.plain_forward)
    got = _grads(net, x, wy, lambda xr: _emulated_net(net, xr))
    single = _grads(net, x, wy, lambda xr: _emulated_net(net, xr, False))
    assert len(got) == 1 + 4 + 2 * 8  # dx, embed and out, 2 blocks
    errs = [_rel(a, w) for a, w in zip(got, want)]
    assert max(errs) <= F32_BWD_REL, errs
    assert max(_rel(a, w) for a, w in zip(single, want)) > F32_BWD_REL


def test_3xtf32_backward_matches_the_jax_fused_gradient():
    """The emulated backward against ``jax.grad`` through the JAX package's
    fused net (``_fused_apply``: its Pallas VJP, interpret mode), at the
    tolerance and shapes of ``test_torch_training.py``'s
    ``test_set_transformer_gradient_matches_reference_and_pallas``
    (2e-4)."""
    S, IN, H, OUT = 4, 4, 24, 4 * 11
    jnet = JaxSetTransformer(hidden_dim=H, num_heads=4, num_layers=2,
                             compute_dtype="float32")
    params = jax.tree.map(np.asarray, jax.jit(
        jnet.init, static_argnums=(1, 2))(jax.random.PRNGKey(0), IN, OUT))
    r = np.random.default_rng(1)
    params["out"]["w"] = (r.standard_normal((H, OUT)) * 0.1).astype(
        np.float32)
    x = r.standard_normal((8, S, IN)).astype(np.float32)
    cfg = jft.FusedCfg(H, 4, 2, 2, "float32", OUT, S)

    def loss_fused(p, x_):
        y = jft._fused_apply(cfg, True, x_.reshape(-1, IN),
                             jft.flatten_params(p, 2))
        return jnp.sum(jnp.sin(y))

    gp, gx = jax.jit(jax.grad(loss_fused, argnums=(0, 1)))(params,
                                                           jnp.asarray(x))
    tnet = SetTransformer(IN, OUT, hidden_dim=H, num_heads=4,
                          compute_dtype="float32")
    tnet.load_state_dict(flatten_tree(params))
    tx = torch.tensor(x, requires_grad=True)
    torch.sin(_emulated_net(tnet, tx)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=2e-4,
                               atol=2e-4)
    tgrads = {k: p.grad for k, p in tnet.named_parameters()}
    want = flatten_tree(jax.tree.map(np.asarray, gp))
    assert set(want) == set(tgrads)
    for k, g in want.items():
        np.testing.assert_allclose(tgrads[k].numpy(), np.asarray(g),
                                   rtol=2e-4, atol=2e-4, err_msg=k)
