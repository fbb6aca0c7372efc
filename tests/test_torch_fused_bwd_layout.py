"""The host-side arithmetic of the fused SetTransformer backward (kernel
#4: bf16 in ``csrc/fused_transformer_bf16.cu``, fp32 in
``csrc/fused_transformer.cu``), on the CPU: the padded weight layouts its
products read (``padded_layouts``: at 16 for the bf16 tensor cores, at 4
for the fp32 FMA pair), and its tile, shared memory and grid per compute
dtype (``bwd_layout``, ``bwd_grid``).  Needs neither a card nor nvcc."""

import numpy as np
import pytest
import torch

from categoricalnf_tpu_torch.ops.cuda import fused_transformer as ft

# one intra-op thread: pytest-xdist runs six workers at once, and each at
# torch's default pool oversubscribes the cores on these small tensors
torch.set_num_threads(1)

# (kd, n) of the weights at the flagship width (in 4, hidden 96, out 104)
# and at the card tests' hidden 24
SHAPES = [(4, 96), (96, 288), (96, 96), (96, 192), (192, 96), (96, 104),
          (4, 24), (24, 72), (24, 48), (48, 24), (24, 104)]


@pytest.mark.parametrize("kd,n", SHAPES)
def test_padded_layouts_are_zero_padded_casts(kd, n):
    rng = np.random.default_rng(kd * 1000 + n)
    wb = torch.tensor(rng.standard_normal((2, kd, n))).to(torch.bfloat16)
    other = torch.ones(3, 24, 40, dtype=torch.bfloat16)  # a second matrix
    fwd, _, bwd, _ = ft.padded_layouts([wb, other])
    pk, pn = ft.pad16(kd), ft.pad16(n)
    assert fwd.shape == (2, pn, pk) and bwd.shape == (2, pk, pn)
    assert fwd.dtype == bwd.dtype == torch.bfloat16
    assert fwd.is_contiguous() and bwd.is_contiguous()
    # 4-byte aligned for the kernel's paired loads
    assert fwd.data_ptr() % 4 == 0 and bwd.data_ptr() % 4 == 0
    assert torch.equal(fwd[:, :n, :kd], wb.transpose(1, 2))
    assert torch.equal(bwd[:, :kd, :n], wb)
    for t, rows, cols in ((fwd, n, kd), (bwd, kd, n)):
        assert not t[:, rows:].any() and not t[:, :, cols:].any()


@pytest.mark.parametrize("kd,n", SHAPES)
def test_products_through_padded_layouts_equal_unpadded(kd, n):
    """x @ W through W^T and g @ W^T through W, with x and g zero past
    their widths as the kernel keeps them in shared memory: the padded
    columns of the result are zero and the rest equals the unpadded
    product (in float64, where the bf16 products and their sums are
    exact)."""
    rng = np.random.default_rng(kd + 7 * n)
    w = torch.tensor(rng.standard_normal((kd, n))).to(torch.bfloat16)
    fwd, bwd = ft.padded_layouts([w])
    pk, pn = ft.pad16(kd), ft.pad16(n)
    wb = w.double()
    x = torch.tensor(rng.standard_normal((64, kd))).to(torch.bfloat16)
    g = torch.tensor(rng.standard_normal((64, n))).to(torch.bfloat16)
    pad = torch.nn.functional.pad
    y = pad(x, (0, pk - kd)).double() @ fwd.double().T
    dx = pad(g, (0, pn - n)).double() @ bwd.double().T
    assert y.shape == (64, pn) and dx.shape == (64, pk)
    torch.testing.assert_close(y[:, :n], x.double() @ wb, rtol=1e-12,
                               atol=1e-12)
    torch.testing.assert_close(dx[:, :kd], g.double() @ wb.T, rtol=1e-12,
                               atol=1e-12)
    assert not y[:, n:].any() and not dx[:, kd:].any()


# (kd, n) of the weights of GraphCNF's node flow at hidden 96 and 128 (in 6,
# out 156)
NODE_FLOW_SHAPES = [(6, 96), (96, 288), (96, 192), (192, 96), (96, 156),
                    (6, 128), (128, 384), (128, 256), (256, 128), (128, 156)]


@pytest.mark.parametrize("kd,n", SHAPES[:6] + NODE_FLOW_SHAPES)
def test_fma_layouts_are_zero_padded_to_4(kd, n):
    """The fp32 FMA pair's weights (``PackedWeights.fma_mats``):
    ``padded_layouts`` at ``pad4`` in fp32, W^T [..., pad4(n), pad4(kd)]
    and W [..., pad4(kd), pad4(n)], the values bitwise, the pads zero, each
    view 16-byte aligned for the kernels' float4 loads (every size a
    multiple of 4 floats), layer strides pad4(kd) pad4(n)."""
    rng = np.random.default_rng(kd * 7 + n)
    w = torch.tensor(rng.standard_normal((2, kd, n)), dtype=torch.float32)
    other = torch.ones(1, 6, 26)  # a matrix of odd widths before it
    wt_o, wt, w_o, wp = ft.padded_layouts([other, w], pad=ft.pad4)
    pk, pn = ft.pad4(kd), ft.pad4(n)
    assert wt.shape == (2, pn, pk) and wp.shape == (2, pk, pn)
    assert wt_o.shape == (1, 28, 8) and w_o.shape == (1, 8, 28)
    assert wt.dtype == wp.dtype == torch.float32
    base = wt_o.data_ptr()
    for t in (wt, w_o, wp):
        assert t.is_contiguous() and (t.data_ptr() - base) % 16 == 0
    assert torch.equal(wt[:, :n, :kd], w.transpose(1, 2))
    assert torch.equal(wp[:, :kd, :n], w)
    for t, rows, cols in ((wt, n, kd), (wp, kd, n)):
        assert not t[:, rows:].any() and not t[:, :, cols:].any()
    assert wp[1].data_ptr() - wp[0].data_ptr() == 4 * pk * pn


FLAGSHIP = dict(in_dim=4, hidden=96, mlp=192, out_dim=104, heads=4,
                layers=2)


def test_bwd_shape_of_the_flagship_per_dtype():
    bf16, f32 = torch.bfloat16, torch.float32
    tile, smem = ft.bwd_layout(bf16, 16, **FLAGSHIP)[:2]
    # 64 rows: (L + 6) [64, 104] buffers, qkv [64, 296], the MLP pair
    # [64, 2 x 200], all bf16, and the fp32 softmax statistics
    assert tile == 64
    assert smem == 2 * 64 * (8 * 104 + 296 + 400) + 4 * 64 * 3 * 4 == 198_656
    assert smem <= ft.MAX_SMEM and ft.smem_blocks_per_sm(smem) == 1
    assert ft.bwd_grid(16_384, tile, smem, 132) == 132
    assert ft.bwd_grid(112, tile, smem, 132) == 2
    # fp32 keeps its 32-row tile, its fp32 rows 4 mod 8 floats wide
    # (conflict_free: 100, 292 and 2 x 196 for the MLP pair) beside its
    # warps' weight rings (12,288 B), and the grid of the rows one float
    # wider that it had: one block an SM
    tile, smem = ft.bwd_layout(f32, 16, **FLAGSHIP)[:2]
    assert tile == 32
    assert smem == 4 * 32 * (8 * 100 + 292 + 392 + 3 * 4) + 12_288 == 203_776
    assert ft.smem_blocks_per_sm(smem) == ft.smem_blocks_per_sm(187_264) == 1
    assert ft.bwd_grid(4096, tile, smem, 132) == 128
    assert ft.bwd_grid(16_384, tile, smem, 132) == 132


@pytest.mark.parametrize("s,tile", [(32, 64), (16, 64), (6, 60), (24, 48),
                                    (17, 51), (1, 64)])
def test_bf16_tiles_hold_whole_sets_and_fit(s, tile):
    """Whole sets up to 64 rows, padded to 16-row m-tiles; S = 32 (two sets
    a tile) fits at the flagship width like S = 16."""
    got, smem = ft.bwd_layout(torch.bfloat16, s, **FLAGSHIP)[:2]
    assert got == tile and got % s == 0
    assert smem <= ft.MAX_SMEM
    if ft.pad16(tile) == 64:
        assert smem == ft.bwd_layout(torch.bfloat16, 16, **FLAGSHIP)[1]


def test_deeper_nets_take_32_row_tiles():
    """A net with 5 blocks does not fit a 64-row bf16 tile; the kernel then
    takes 32 rows, so every shape the fp32-layout kernel took still fits."""
    deep = dict(FLAGSHIP, layers=5)
    tile, smem = ft.bwd_layout(torch.bfloat16, 16, **deep)[:2]
    assert tile == 32 and smem <= ft.MAX_SMEM
    for layers, hidden in ((2, 112), (5, 96), (6, 64)):
        net = dict(FLAGSHIP, layers=layers, hidden=hidden, mlp=2 * hidden)
        if ft.bwd_layout(torch.float32, 16, **net)[1] <= ft.MAX_SMEM:
            assert ft.bwd_layout(torch.bfloat16, 16, **net)[1] <= ft.MAX_SMEM
